// Banded soft-silhouette rasterizer for Hopper (sm_90a): forward K1 and
// backward K2.
//
// Replaces the Pallas TPU kernels of
//   soccerplayershapepose_tpu/render/pallas_raster.py:_band_kernel      (K1)
//   soccerplayershapepose_tpu/render/pallas_raster.py:_band_bwd_kernel  (K2)
// with the same algorithm, not the same blocking. The host (render/
// band_raster.py) y-sorts the faces, packs them as (B, F_pad, 6) f32
// triangles with F_pad = n_chunks * chunk, computes integer chunk boxes and
// the exact per-band candidate range [lo, hi) from the suffix-min /
// prefix-max of the chunk y-ranges. Culled and padding faces are the -1e9
// degenerate sentinel, sorted last, outside every band's range.
//
// Grid: one block per (x-tile, band, batch); one thread per pixel of the
// band_h x tile_w tile (8 x 32 = 256 threads by default). A block walks its
// band's candidate chunks; the test of a chunk's box (padded by the sigmoid
// support margin) against the tile is uniform across the block, so the
// __syncthreads() inside the loop are reached by every thread. The chunk's
// per-face constants are staged once in shared memory.
//
// What bounds it on the H100: fp32 ALU work. Counting each fp32 add, sub,
// mul, div, min/max, compare, negation, exp and log1p as one operation
// (selects not counted), a (face, pixel) visit costs
//   forward  73 = edge_terms 3 x 18 (relative point 2, cross 3, t 4,
//                 clamp 2, residual 4, d2 3) + inside test 7 + d2min 2
//                 + coverage 7 (sign, div, negation, exp, add, div, clamp)
//                 + log-sum 3 (negation, log1p, add);
//   backward 93 = the same 70 without the log-sum + dL/dd2 factor 4
//                 + minimum-edge choice 3 + endpoint terms 10 (u 2, v 2,
//                 s 4, e 2) + one add per reduced value 6.
// chip_smoke.py computes the bound from these counts. The warp-shuffle tree
// below spends 30 adds per visit where the reduction needs the 6 counted.
// The bytes moved (triangles, chunk boxes, one f32 per pixel) are a few MB
// per call. The band and box pruning is what keeps the visit count down: a
// 256^2 fit image in 8-row bands sees on the order of 10^2 of the ~10^3
// chunks of kept faces per band.
//
// K2 reduces each chunk's chunk x 6 per-pixel gradient terms across the
// block (warp shuffles, then shared memory) and issues one atomicAdd per
// value into dtri[b, face, :]. The summation order therefore varies from
// run to run; compare K2 with a relative tolerance.
//
// The geometric arithmetic uses the _rn intrinsics, which the compiler
// never contracts into FMAs, so each step rounds as PyTorch's elementwise
// ops round in the plain version (render/softras.py).
//
// Both launchers return cudaGetLastError() so that a refused launch is
// reported by the caller.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxChunk = 32;
constexpr int kMaxWarps = 32;
// float32(1 - 1e-7): the coverage clamp of the plain version.
constexpr float kDMax = 0.99999988079071044921875f;

struct FaceConst {
  float x[3], y[3];    // vertices a, b, c
  float ex[3], ey[3];  // edges a->b, b->c, c->a
  float ee[3];         // max(|e|^2, 1e-12)
  float nondeg;        // 1 if |signed area| > 1e-9 else 0
};

__device__ __forceinline__ void load_face(FaceConst* fc, const float* t) {
  const float ax = t[0], ay = t[1], bx = t[2], by = t[3], cx = t[4], cy = t[5];
  fc->x[0] = ax; fc->y[0] = ay;
  fc->x[1] = bx; fc->y[1] = by;
  fc->x[2] = cx; fc->y[2] = cy;
  const float xs[4] = {ax, bx, cx, ax};
  const float ys[4] = {ay, by, cy, ay};
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float ex = __fsub_rn(xs[e + 1], xs[e]);
    const float ey = __fsub_rn(ys[e + 1], ys[e]);
    fc->ex[e] = ex;
    fc->ey[e] = ey;
    fc->ee[e] = fmaxf(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), 1e-12f);
  }
  const float area = __fsub_rn(
      __fmul_rn(__fsub_rn(bx, ax), __fsub_rn(cy, ay)),
      __fmul_rn(__fsub_rn(by, ay), __fsub_rn(cx, ax)));
  fc->nondeg = fabsf(area) > 1e-9f ? 1.0f : 0.0f;
}

struct EdgeTerms {
  float cross, d2, t, rx, ry;
};

__device__ __forceinline__ EdgeTerms edge_terms(const FaceConst& fc, int e,
                                                float px, float py) {
  EdgeTerms r;
  const float ex = fc.ex[e], ey = fc.ey[e];
  const float pxr = __fsub_rn(px, fc.x[e]);
  const float pyr = __fsub_rn(py, fc.y[e]);
  r.cross = __fsub_rn(__fmul_rn(ex, pyr), __fmul_rn(ey, pxr));
  float t = __fdiv_rn(__fadd_rn(__fmul_rn(pxr, ex), __fmul_rn(pyr, ey)),
                      fc.ee[e]);
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  r.t = t;
  r.rx = __fsub_rn(pxr, __fmul_rn(t, ex));
  r.ry = __fsub_rn(pyr, __fmul_rn(t, ey));
  r.d2 = __fadd_rn(__fmul_rn(r.rx, r.rx), __fmul_rn(r.ry, r.ry));
  return r;
}

__device__ __forceinline__ bool is_inside(const FaceConst& fc,
                                          const EdgeTerms& e0,
                                          const EdgeTerms& e1,
                                          const EdgeTerms& e2) {
  const bool pos = (e0.cross >= 0.f) && (e1.cross >= 0.f) && (e2.cross >= 0.f);
  const bool neg = (e0.cross <= 0.f) && (e1.cross <= 0.f) && (e2.cross <= 0.f);
  return (pos || neg) && fc.nondeg != 0.0f;
}

__device__ __forceinline__ float coverage(float d2min, bool inside,
                                          float sigma_px) {
  const float s = __fdiv_rn(inside ? d2min : -d2min, sigma_px);
  const float d = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-s)));
  return fminf(d, kDMax);
}

// Uniform across the block: does chunk k's padded box meet the tile?
__device__ __forceinline__ bool chunk_hits(const int* cymin, const int* cymax,
                                           const int* cxmin, const int* cxmax,
                                           int k, float x0, float x1, float y0,
                                           float y1, float margin) {
  return (float)cymax[k] >= __fsub_rn(y0, margin) &&
         (float)cymin[k] <= __fadd_rn(y1, margin) &&
         (float)cxmax[k] >= __fsub_rn(x0, margin) &&
         (float)cxmin[k] <= __fadd_rn(x1, margin);
}

__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void band_fwd_kernel(const float* __restrict__ tri,
                                const int* __restrict__ cymin,
                                const int* __restrict__ cymax,
                                const int* __restrict__ cxmin,
                                const int* __restrict__ cxmax,
                                const int* __restrict__ lo,
                                const int* __restrict__ hi,
                                float* __restrict__ out, int n_chunks,
                                int chunk, int img_wh, int n_bands,
                                float sigma_px, float margin) {
  __shared__ FaceConst faces[kMaxChunk];
  const int xt = blockIdx.x, band = blockIdx.y, b = blockIdx.z;
  const int tile_w = blockDim.x, band_h = blockDim.y;
  const int tid = threadIdx.y * tile_w + threadIdx.x;
  const int ix = xt * tile_w + threadIdx.x;
  const int iy = band * band_h + threadIdx.y;
  const float px = (float)ix, py = (float)iy;
  const float x0 = (float)(xt * tile_w), x1 = x0 + (float)tile_w;
  const float y0 = (float)(band * band_h), y1 = y0 + (float)band_h;

  // The kernel clamps its own range: a NaN vertex upstream can never make
  // this loop run away.
  const int c_lo = clamp_int(lo[b * n_bands + band], 0, n_chunks);
  const int c_hi = clamp_int(hi[b * n_bands + band], 0, n_chunks);
  const float* tri_b = tri + (size_t)b * n_chunks * chunk * 6;

  float acc = 0.0f;
  for (int c = c_lo; c < c_hi; ++c) {
    const int k = b * n_chunks + c;
    if (!chunk_hits(cymin, cymax, cxmin, cxmax, k, x0, x1, y0, y1, margin))
      continue;
    __syncthreads();  // the previous chunk's readers are done
    if (tid < chunk) load_face(&faces[tid], tri_b + ((size_t)c * chunk + tid) * 6);
    __syncthreads();
    for (int f = 0; f < chunk; ++f) {
      const FaceConst& fc = faces[f];
      const EdgeTerms e0 = edge_terms(fc, 0, px, py);
      const EdgeTerms e1 = edge_terms(fc, 1, px, py);
      const EdgeTerms e2 = edge_terms(fc, 2, px, py);
      const float d2min = fminf(e0.d2, fminf(e1.d2, e2.d2));
      const float d = coverage(d2min, is_inside(fc, e0, e1, e2), sigma_px);
      acc = __fadd_rn(acc, log1pf(-d));
    }
  }
  if (ix < img_wh && iy < img_wh)
    out[((size_t)b * img_wh + iy) * img_wh + ix] = __fsub_rn(1.0f, expf(acc));
}

__global__ void band_bwd_kernel(const float* __restrict__ tri,
                                const int* __restrict__ cymin,
                                const int* __restrict__ cymax,
                                const int* __restrict__ cxmin,
                                const int* __restrict__ cxmax,
                                const int* __restrict__ lo,
                                const int* __restrict__ hi,
                                const float* __restrict__ gs,
                                float* __restrict__ dtri, int n_chunks,
                                int chunk, int img_wh, int n_bands,
                                float sigma_px, float margin) {
  __shared__ FaceConst faces[kMaxChunk];
  __shared__ float red[kMaxWarps][kMaxChunk * 6];
  const int xt = blockIdx.x, band = blockIdx.y, b = blockIdx.z;
  const int tile_w = blockDim.x, band_h = blockDim.y;
  const int tid = threadIdx.y * tile_w + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_warps = (tile_w * band_h) >> 5;
  const int ix = xt * tile_w + threadIdx.x;
  const int iy = band * band_h + threadIdx.y;
  const float px = (float)ix, py = (float)iy;
  const float x0 = (float)(xt * tile_w), x1 = x0 + (float)tile_w;
  const float y0 = (float)(band * band_h), y1 = y0 + (float)band_h;
  // Pixels outside the image carry no gradient.
  const float g = (ix < img_wh && iy < img_wh)
                      ? gs[((size_t)b * img_wh + iy) * img_wh + ix]
                      : 0.0f;

  const int c_lo = clamp_int(lo[b * n_bands + band], 0, n_chunks);
  const int c_hi = clamp_int(hi[b * n_bands + band], 0, n_chunks);
  const float* tri_b = tri + (size_t)b * n_chunks * chunk * 6;
  float* dtri_b = dtri + (size_t)b * n_chunks * chunk * 6;

  for (int c = c_lo; c < c_hi; ++c) {
    const int k = b * n_chunks + c;
    if (!chunk_hits(cymin, cymax, cxmin, cxmax, k, x0, x1, y0, y1, margin))
      continue;
    __syncthreads();  // faces[] and red[] of the previous chunk are free
    if (tid < chunk) load_face(&faces[tid], tri_b + ((size_t)c * chunk + tid) * 6);
    __syncthreads();
    for (int f = 0; f < chunk; ++f) {
      const FaceConst& fc = faces[f];
      const EdgeTerms e0 = edge_terms(fc, 0, px, py);
      const EdgeTerms e1 = edge_terms(fc, 1, px, py);
      const EdgeTerms e2 = edge_terms(fc, 2, px, py);
      const bool inside = is_inside(fc, e0, e1, e2);
      const float d2min = fminf(e0.d2, fminf(e1.d2, e2.d2));
      const float dcov = coverage(d2min, inside, sigma_px);
      // dL/d(d2_min) = g(1-S) * D / sigma * sign * nondeg
      const float gd2 = __fmul_rn(
          __fmul_rn(__fdiv_rn(__fmul_rn(g, dcov), sigma_px),
                    inside ? 1.0f : -1.0f),
          fc.nondeg);
      // The minimum edge, ties to the lower edge (Voronoi-exclusive, so a
      // shared vertex is not counted twice).
      const bool min0 = (e0.d2 <= e1.d2) && (e0.d2 <= e2.d2);
      const bool min1 = !min0 && (e1.d2 <= e2.d2);
      const bool min2 = !min0 && !min1;
      const float rx = min0 ? e0.rx : (min1 ? e1.rx : e2.rx);
      const float ry = min0 ? e0.ry : (min1 ? e1.ry : e2.ry);
      const float t = min0 ? e0.t : (min1 ? e1.t : e2.t);
      // Envelope theorem: the edge's endpoint 0 gets -2r(1-t) = 2(v - u),
      // its endpoint 1 gets -2rt = -2v, with u = q r and v = u t. Edge e
      // runs from vertex e to vertex (e + 1) % 3.
      const float ux = __fmul_rn(gd2, rx), uy = __fmul_rn(gd2, ry);
      const float vx = __fmul_rn(ux, t), vy = __fmul_rn(uy, t);
      const float sx = 2.0f * __fsub_rn(vx, ux), sy = 2.0f * __fsub_rn(vy, uy);
      const float ex = -2.0f * vx, ey = -2.0f * vy;
      const float v6[6] = {
          min0 ? sx : (min2 ? ex : 0.0f), min0 ? sy : (min2 ? ey : 0.0f),
          min1 ? sx : (min0 ? ex : 0.0f), min1 ? sy : (min0 ? ey : 0.0f),
          min2 ? sx : (min1 ? ex : 0.0f), min2 ? sy : (min1 ? ey : 0.0f)};
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        float v = v6[j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) red[warp][f * 6 + j] = v;
      }
    }
    __syncthreads();
    if (tid < chunk * 6) {
      float s = 0.0f;
      for (int w = 0; w < n_warps; ++w) s += red[w][tid];
      if (s != 0.0f) atomicAdd(&dtri_b[(size_t)c * chunk * 6 + tid], s);
    }
  }
}

int check_launch(int chunk, int img_wh, int band_h, int tile_w, int batch,
                 int n_chunks) {
  const int threads = band_h * tile_w;
  if (chunk < 1 || chunk > kMaxChunk || band_h < 1 || tile_w < 1 ||
      threads > 1024 || threads % 32 != 0 || threads < chunk * 6 ||
      img_wh < 1 || batch < 1 || batch > 65535 || n_chunks < 1)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" int spt_band_raster_fwd(const float* tri, const int* cymin,
                                   const int* cymax, const int* cxmin,
                                   const int* cxmax, const int* lo,
                                   const int* hi, float* out, int batch,
                                   int n_chunks, int chunk, int img_wh,
                                   int band_h, int tile_w, float sigma_px,
                                   float margin, void* stream) {
  const int bad = check_launch(chunk, img_wh, band_h, tile_w, batch, n_chunks);
  if (bad) return bad;
  const int n_bands = (img_wh + band_h - 1) / band_h;
  const int n_xt = (img_wh + tile_w - 1) / tile_w;
  const dim3 grid(n_xt, n_bands, batch);
  const dim3 block(tile_w, band_h);
  band_fwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      tri, cymin, cymax, cxmin, cxmax, lo, hi, out, n_chunks, chunk, img_wh,
      n_bands, sigma_px, margin);
  return (int)cudaGetLastError();
}

extern "C" int spt_band_raster_bwd(const float* tri, const int* cymin,
                                   const int* cymax, const int* cxmin,
                                   const int* cxmax, const int* lo,
                                   const int* hi, const float* gs, float* dtri,
                                   int batch, int n_chunks, int chunk,
                                   int img_wh, int band_h, int tile_w,
                                   float sigma_px, float margin, void* stream) {
  const int bad = check_launch(chunk, img_wh, band_h, tile_w, batch, n_chunks);
  if (bad) return bad;
  const int n_bands = (img_wh + band_h - 1) / band_h;
  const int n_xt = (img_wh + tile_w - 1) / tile_w;
  const dim3 grid(n_xt, n_bands, batch);
  const dim3 block(tile_w, band_h);
  band_bwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      tri, cymin, cymax, cxmin, cxmax, lo, hi, gs, dtri, n_chunks, chunk,
      img_wh, n_bands, sigma_px, margin);
  return (int)cudaGetLastError();
}
