// Banded hard z-buffer for Hopper (sm_90a): K3.
//
// Replaces the Pallas TPU kernel
//   soccerplayershapepose_tpu/render/pallas_zbuffer.py:_zbuf_kernel   (K3)
// with the same pruning, not the same blocking. The host (render/
// zbuffer.py) y-sorts the faces and packs them as (B, F_pad, 9) f32 rows
// [x0 y0 x1 y1 x2 y2 z0 z1 z2] with F_pad = n_chunks * chunk, computes the
// exact integer box of every chunk and each band's candidate range [lo, hi)
// (render/band_raster.py:_band_chunk_bounds, margin 1 px). Padding faces
// are the -1e9 degenerate sentinel, sorted last. Dropped from the TPU
// kernel: the face-block grid axis and its VMEM z scratch (a block here
// walks all its candidate chunks in one loop and keeps the z-buffer in
// registers), the SMEM grouping of chunk boxes, and the TPU tile widths.
//
// Grid: one block per (x-tile, band, batch); one thread per pixel of the
// band_h x tile_w tile (8 x 32 = 256 threads). A block walks its band's
// candidate chunks, clamped to [0, n_chunks] so that a NaN vertex upstream
// cannot make the loop run away. The test of a chunk's box (padded by the
// margin) against the tile is uniform across the block, so the
// __syncthreads() in the loop are reached by every thread. The chunk's
// faces are staged once in shared memory with their edge vectors.
//
// Each thread keeps its best (z, face, w0, w1) in registers and visits the
// faces in ascending sorted order, replacing the best only on a strictly
// smaller z: the winner is the covering face of least z, ties to the
// smallest sorted id, the Pallas kernel's rule (min z within a chunk, then
// the smallest id reaching it, merged across chunks on a strict <).
//
// The inside test is a hard decision, so the arithmetic uses the _rn
// intrinsics, which the compiler never contracts into FMAs, and an IEEE
// division: every step rounds as the separate PyTorch ops of the plain
// version (render/zbuffer.py:rasterize_bary_plain) round, and the face ids
// and mask agree exactly.
//
// What bounds it on the H100: fp32 ALU work. Counting each fp32 add, sub,
// mul, div, comparison and absolute value as one operation (selects and
// boolean logic not counted), a (face, pixel) visit costs
//   36 = edge functions 3 x 5 (two relative coordinates, two products, one
//        difference; the edge vectors are per face, staged once per chunk)
//        + area 2 + inside test 8 (six sign comparisons, |area|, > 1e-9)
//        + inv_area 1 (division) + w0, w1 2 + z 7 (three products, two
//        sums, 1 - w0 - w1) + the z comparison 1.
// chip_smoke.py computes the bound from this count and the run's visits.
// The bytes moved (the table, the chunk boxes, 12 bytes per pixel out) are
// a few tens of MB per call.
//
// The launcher returns cudaGetLastError() so that a refused launch is
// reported by the caller.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxChunk = 32;

struct ZFace {
  float x[3], y[3], z[3];
  float dx[3], dy[3];  // edge e runs from vertex (e + 1) % 3 to (e + 2) % 3
};

__device__ __forceinline__ void load_zface(ZFace* fc, const float* t) {
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    fc->x[v] = t[2 * v];
    fc->y[v] = t[2 * v + 1];
    fc->z[v] = t[6 + v];
  }
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int a = (e + 1) % 3, b = (e + 2) % 3;
    fc->dx[e] = __fsub_rn(fc->x[b], fc->x[a]);
    fc->dy[e] = __fsub_rn(fc->y[b], fc->y[a]);
  }
}

// Edge function of edge e (opposite vertex e) at pixel (px, py):
// (xb - xa)(py - ya) - (yb - ya)(px - xa).
__device__ __forceinline__ float edge_fn(const ZFace& fc, int e, float px,
                                         float py) {
  const int a = (e + 1) % 3;
  return __fsub_rn(__fmul_rn(fc.dx[e], __fsub_rn(py, fc.y[a])),
                   __fmul_rn(fc.dy[e], __fsub_rn(px, fc.x[a])));
}

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void zbuffer_bary_kernel(const float* __restrict__ tri,
                                    const int* __restrict__ cymin,
                                    const int* __restrict__ cymax,
                                    const int* __restrict__ cxmin,
                                    const int* __restrict__ cxmax,
                                    const int* __restrict__ lo,
                                    const int* __restrict__ hi,
                                    int* __restrict__ fid_out,
                                    float* __restrict__ w0_out,
                                    float* __restrict__ w1_out, int n_chunks,
                                    int chunk, int img_wh, int n_bands,
                                    float margin) {
  __shared__ ZFace faces[kMaxChunk];
  const int xt = blockIdx.x, band = blockIdx.y, b = blockIdx.z;
  const int tile_w = blockDim.x, band_h = blockDim.y;
  const int tid = threadIdx.y * tile_w + threadIdx.x;
  const int ix = xt * tile_w + threadIdx.x;
  const int iy = band * band_h + threadIdx.y;
  const float px = (float)ix, py = (float)iy;
  const float x0 = (float)(xt * tile_w), x1 = x0 + (float)tile_w;
  const float y0 = (float)(band * band_h), y1 = y0 + (float)band_h;

  const int c_lo = clamp_int(lo[b * n_bands + band], 0, n_chunks);
  const int c_hi = clamp_int(hi[b * n_bands + band], 0, n_chunks);
  const float* tri_b = tri + (size_t)b * n_chunks * chunk * 9;

  float best_z = INFINITY, best_w0 = 0.0f, best_w1 = 0.0f;
  int best_f = -1;
  for (int c = c_lo; c < c_hi; ++c) {
    const int k = b * n_chunks + c;
    if (!((float)cymax[k] >= __fsub_rn(y0, margin) &&
          (float)cymin[k] <= __fadd_rn(y1, margin) &&
          (float)cxmax[k] >= __fsub_rn(x0, margin) &&
          (float)cxmin[k] <= __fadd_rn(x1, margin)))
      continue;
    __syncthreads();  // the previous chunk's readers are done
    if (tid < chunk)
      load_zface(&faces[tid], tri_b + ((size_t)c * chunk + tid) * 9);
    __syncthreads();
    for (int f = 0; f < chunk; ++f) {
      const ZFace& fc = faces[f];
      const float e0 = edge_fn(fc, 0, px, py);
      const float e1 = edge_fn(fc, 1, px, py);
      const float e2 = edge_fn(fc, 2, px, py);
      const float area = __fadd_rn(__fadd_rn(e0, e1), e2);
      const bool nondeg = fabsf(area) > 1e-9f;
      const bool inside =
          ((e0 >= 0.f && e1 >= 0.f && e2 >= 0.f) ||
           (e0 <= 0.f && e1 <= 0.f && e2 <= 0.f)) && nondeg;
      const float inv_area = __fdiv_rn(1.0f, nondeg ? area : 1.0f);
      const float w0 = __fmul_rn(e0, inv_area);
      const float w1 = __fmul_rn(e1, inv_area);
      const float z = __fadd_rn(
          __fadd_rn(__fmul_rn(w0, fc.z[0]), __fmul_rn(w1, fc.z[1])),
          __fmul_rn(__fsub_rn(__fsub_rn(1.0f, w0), w1), fc.z[2]));
      if (inside && z < best_z) {
        best_z = z;
        best_f = c * chunk + f;
        best_w0 = w0;
        best_w1 = w1;
      }
    }
  }
  if (ix < img_wh && iy < img_wh) {
    const size_t o = ((size_t)b * img_wh + iy) * img_wh + ix;
    fid_out[o] = best_f;
    w0_out[o] = best_w0;
    w1_out[o] = best_w1;
  }
}

}  // namespace

extern "C" int spt_zbuffer_bary(const float* tri, const int* cymin,
                                const int* cymax, const int* cxmin,
                                const int* cxmax, const int* lo,
                                const int* hi, int* fid, float* w0, float* w1,
                                int batch, int n_chunks, int chunk,
                                int img_wh, int band_h, int tile_w,
                                float margin, void* stream) {
  const int threads = band_h * tile_w;
  if (chunk < 1 || chunk > kMaxChunk || band_h < 1 || tile_w < 1 ||
      threads > 1024 || threads < chunk || img_wh < 1 || batch < 1 ||
      batch > 65535 || n_chunks < 1)
    return (int)cudaErrorInvalidValue;
  const int n_bands = (img_wh + band_h - 1) / band_h;
  const int n_xt = (img_wh + tile_w - 1) / tile_w;
  const dim3 grid(n_xt, n_bands, batch);
  const dim3 block(tile_w, band_h);
  zbuffer_bary_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      tri, cymin, cymax, cxmin, cxmax, lo, hi, fid, w0, w1, n_chunks, chunk,
      img_wh, n_bands, margin);
  return (int)cudaGetLastError();
}
