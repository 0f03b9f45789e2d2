// Banded soft-silhouette rasterizer for Hopper (sm_90a): forward K1 and
// backward K2.
//
// Replaces the Pallas TPU kernels of
//   soccerplayershapepose_tpu/render/pallas_raster.py:_band_kernel      (K1)
//   soccerplayershapepose_tpu/render/pallas_raster.py:_band_bwd_kernel  (K2)
// with the same function and the same coarse pruning, not the same
// blocking. The host (render/band_raster.py) y-sorts the faces, pads them
// to F_pad = n_chunks * chunk with the -1e9 degenerate sentinel (culled and
// padding faces, sorted last), computes the integer box of every chunk and
// each band's exact candidate-chunk range [lo, hi) from the suffix-min /
// prefix-max of the chunk y-ranges. Once per call it also writes one
// 20-float record per face (face_constants):
//   [ax ay bx by cx cy | ex0 ey0 ex1 ey1 ex2 ey2 | iee0 iee1 iee2 nondeg |
//    bx0 bx1 by0 by1]
// the vertices, the edges a->b, b->c, c->a, the reciprocal of
// max(|e|^2, 1e-12) (the Pallas kernel's per-face reciprocal), the
// non-degenerate flag and the face's float bounding box padded by the
// support radius r = sqrt(20.1 sigma_px). A pixel centre outside that box
// is farther than r from the triangle, so d^2 > 20.1 sigma_px and
// D = sigmoid(-d^2 / sigma_px) < 1.9e-9 (< 2e-9 with room for the rounding
// of d^2): the rule by which the chunk test (padded by r + 2 px) already
// drops chunks. Neither kernel evaluates a (face, pixel) pair whose pixel
// centre lies outside the face's padded box.
//
// What bounded the first port (PR 4) on the H100: it evaluated every face
// of every chunk that met an 8 x 32 tile at all 256 pixels, 40x the pairs
// inside the faces' supports at the fit shape, with five IEEE divisions per
// pair, and K2 reduced every pair through six warp-shuffle trees and
// atomics. What bounds these kernels now is not their fp32 work (about 11
// and 14 us at the fit shape) but latency and the walk around it: K1's
// gather, in which each of a band's x-tiles tests every face of the band's
// [lo, hi) in batches with two barriers each, and in both kernels lanes
// whose faces' boxes differ in size, with few independent instructions in
// flight per warp.
//
// K1 (tile gather). One block of 256 threads (8 warps) per (x-tile, band,
// batch) of 8 x 32 pixels. The block walks its band's faces in batches of
// 256: each thread tests one face (its chunk's box against the tile, then
// its own padded box), a ballot and a prefix count over the warps compact
// the faces that meet the tile into shared memory in sorted order, and the
// records are copied there with cp.async (one buffer: the four blocks
// resident on an SM overlap one block's gather with the others' pair
// evaluation). Warp w then takes faces w, w + 8,
// ... of the compacted list, and its lanes take the pixels of the face's
// padded box inside the tile, one pixel a lane, 32 at a time: a face's box
// is 5-8 px wide at the fit shape, so a lane works on a pixel of the box in
// most of the slots, and a face whose box holds more than 32 pixels (wide
// supports, sigma = 1e-4) keeps its constants in registers across each
// lane's pixels. Each warp sums log1p(-D) into its own 8 x 32 accumulator
// in shared memory (one lane per pixel per face, so no atomics), in sorted
// face order; at the end each pixel adds the eight warps' sums in warp
// order, so S is the same from run to run. Why this mapping: a first
// version gave each of four warps an 8 x 8 sub-tile with two pixels a
// lane; it ran a whole 32-lane half of a sub-tile for each 5 x 5 box that
// met it and left all of a tile's faces to four warps, and took 0.81 ms
// at the fit shape against 0.31 ms for this mapping (H100 SXM,
// chip_smoke.py). Why not the face-parallel scatter over band strips: it
// would need shared-memory atomics, whose order, and so S, varies from run
// to run.
//
// K2 (face-parallel). One thread per face of the sorted table walks the
// pixels of the face's padded box clipped to the image, reads g(1 - S)
// (6 MB at the fit shape, resident in the 50 MB L2), sums the six
// dL/dtri terms in registers and writes its six values once: no shuffles,
// no shared memory, no atomics, and the result is bit-identical from run
// to run. Faces with an empty box (sentinels, faces off the image, a NaN
// vertex) write zeros, so dtri needs no memset.
//
// Operations per (face, pixel) pair, each fp32 add, sub, mul, div,
// min/max, compare, negation, exp and log1p counted as one (selects and
// the box test that selects the pair not counted):
//   forward  73 = edge terms 3 x 18 (relative point 2, cross 3, t 4: dot 3
//                 and the product by iee, clamp 2, residual 4, d2 3)
//                 + inside test 7 + d2min 2 + coverage 7 (sign, product by
//                 1/sigma, negation, exp, add, the reciprocal division,
//                 clamp) + log-sum 3 (negation, log1p, add);
//   backward 93 = the same 70 without the log-sum + dL/dd2 factor 4
//                 (g D, times 1/sigma, sign, nondeg) + minimum-edge choice 3
//                 + endpoint terms 10 (u 2, v 2, s 4, e 2) + one add per
//                 summed value 6.
// chip_smoke.py multiplies them by the pairs inside the faces' padded boxes
// (render/band_raster.py:support_pairs) for the bound. One IEEE division
// per pair remains (the sigmoid's); the projection and 1/sigma are
// products, as in the Pallas kernel.
//
// The geometric arithmetic uses the _rn intrinsics, which the compiler
// never contracts into FMAs, so each step rounds as the separate PyTorch
// ops of the plain versions (render/band_raster.py) round.
//
// Each launcher returns cudaGetLastError() so that a refused launch is
// reported by the caller. With a non-null n_pairs a launch adds the pairs
// it evaluated there (a separate instantiation; the fit passes null).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBandH = 8;          // tile rows: render/band_raster.py BAND_H
constexpr int kTileW = 32;         // tile columns: TILE_W
constexpr int kTilePx = kBandH * kTileW;
constexpr int kFwdWarps = 8;       // each takes every 8th face of the tile
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kBwdThreads = 128;   // one face a thread
constexpr int kRec = 5;            // float4 per face record (20 floats)
// float32(1 - 1e-7): the coverage clamp of the plain version.
constexpr float kDMax = 0.99999988079071044921875f;

struct Face {
  float x[3], y[3];     // vertices a, b, c
  float ex[3], ey[3];   // edges a->b, b->c, c->a
  float iee[3];         // 1 / max(|e|^2, 1e-12)
  float nondeg;         // 1 if |signed area| > 1e-9 else 0
};

__device__ __forceinline__ Face unpack(const float4* r) {
  const float4 a = r[0], b = r[1], c = r[2], d = r[3];
  Face f;
  f.x[0] = a.x; f.y[0] = a.y; f.x[1] = a.z; f.y[1] = a.w;
  f.x[2] = b.x; f.y[2] = b.y;
  f.ex[0] = b.z; f.ey[0] = b.w; f.ex[1] = c.x; f.ey[1] = c.y;
  f.ex[2] = c.z; f.ey[2] = c.w;
  f.iee[0] = d.x; f.iee[1] = d.y; f.iee[2] = d.z; f.nondeg = d.w;
  return f;
}

struct EdgeTerms {
  float cross, d2, t, rx, ry;
};

__device__ __forceinline__ EdgeTerms edge_terms(const Face& f, int e,
                                                float px, float py) {
  EdgeTerms r;
  const float ex = f.ex[e], ey = f.ey[e];
  const float pxr = __fsub_rn(px, f.x[e]);
  const float pyr = __fsub_rn(py, f.y[e]);
  r.cross = __fsub_rn(__fmul_rn(ex, pyr), __fmul_rn(ey, pxr));
  float t = __fmul_rn(__fadd_rn(__fmul_rn(pxr, ex), __fmul_rn(pyr, ey)),
                      f.iee[e]);
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  r.t = t;
  r.rx = __fsub_rn(pxr, __fmul_rn(t, ex));
  r.ry = __fsub_rn(pyr, __fmul_rn(t, ey));
  r.d2 = __fadd_rn(__fmul_rn(r.rx, r.rx), __fmul_rn(r.ry, r.ry));
  return r;
}

__device__ __forceinline__ bool is_inside(const Face& f, const EdgeTerms& e0,
                                          const EdgeTerms& e1,
                                          const EdgeTerms& e2) {
  const bool pos = (e0.cross >= 0.f) && (e1.cross >= 0.f) && (e2.cross >= 0.f);
  const bool neg = (e0.cross <= 0.f) && (e1.cross <= 0.f) && (e2.cross <= 0.f);
  return (pos || neg) && f.nondeg != 0.0f;
}

__device__ __forceinline__ float coverage(float d2min, bool inside,
                                          float inv_sigma) {
  const float s = __fmul_rn(inside ? d2min : -d2min, inv_sigma);
  const float d = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-s)));
  return fminf(d, kDMax);
}

// log1p(-D) of one pair: the forward's summand.
__device__ __forceinline__ float log_miss(const Face& f, float px, float py,
                                          float inv_sigma) {
  const EdgeTerms e0 = edge_terms(f, 0, px, py);
  const EdgeTerms e1 = edge_terms(f, 1, px, py);
  const EdgeTerms e2 = edge_terms(f, 2, px, py);
  const float d2min = fminf(e0.d2, fminf(e1.d2, e2.d2));
  return log1pf(-coverage(d2min, is_inside(f, e0, e1, e2), inv_sigma));
}

// Adds one pair's dL/dtri terms to acc, given gs = g(1 - S) at the pixel.
__device__ __forceinline__ void add_pair_grad(const Face& f, float px,
                                              float py, float g,
                                              float inv_sigma, float* acc) {
  const EdgeTerms e0 = edge_terms(f, 0, px, py);
  const EdgeTerms e1 = edge_terms(f, 1, px, py);
  const EdgeTerms e2 = edge_terms(f, 2, px, py);
  const bool inside = is_inside(f, e0, e1, e2);
  const float d2min = fminf(e0.d2, fminf(e1.d2, e2.d2));
  const float dcov = coverage(d2min, inside, inv_sigma);
  // dL/d(d2_min) = g(1-S) * D / sigma * sign * nondeg
  const float gd2 = __fmul_rn(
      __fmul_rn(__fmul_rn(__fmul_rn(g, dcov), inv_sigma),
                inside ? 1.0f : -1.0f),
      f.nondeg);
  // The minimum edge, ties to the lower edge (Voronoi-exclusive, so a
  // shared vertex is not counted twice).
  const bool min0 = (e0.d2 <= e1.d2) && (e0.d2 <= e2.d2);
  const bool min1 = !min0 && (e1.d2 <= e2.d2);
  const bool min2 = !min0 && !min1;
  const float rx = min0 ? e0.rx : (min1 ? e1.rx : e2.rx);
  const float ry = min0 ? e0.ry : (min1 ? e1.ry : e2.ry);
  const float t = min0 ? e0.t : (min1 ? e1.t : e2.t);
  // Envelope theorem: the edge's endpoint 0 gets -2r(1-t) = 2(v - u), its
  // endpoint 1 gets -2rt = -2v, with u = q r and v = u t. Edge e runs from
  // vertex e to vertex (e + 1) % 3.
  const float ux = __fmul_rn(gd2, rx), uy = __fmul_rn(gd2, ry);
  const float vx = __fmul_rn(ux, t), vy = __fmul_rn(uy, t);
  const float sx = 2.0f * __fsub_rn(vx, ux), sy = 2.0f * __fsub_rn(vy, uy);
  const float ex = -2.0f * vx, ey = -2.0f * vy;
  const float v6[6] = {
      min0 ? sx : (min2 ? ex : 0.0f), min0 ? sy : (min2 ? ey : 0.0f),
      min1 ? sx : (min0 ? ex : 0.0f), min1 ? sy : (min0 ? ey : 0.0f),
      min2 ? sx : (min1 ? ex : 0.0f), min2 ? sy : (min1 ? ey : 0.0f)};
#pragma unroll
  for (int j = 0; j < 6; ++j) acc[j] = __fadd_rn(acc[j], v6[j]);
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// First and last pixel index whose centre lies in [lo, hi], clipped to the
// image; empty (first > last) when the box misses it.
__device__ __forceinline__ int first_px(float lo, int img_wh) {
  return (int)fminf(fmaxf(ceilf(lo), 0.0f), (float)img_wh);
}

__device__ __forceinline__ int last_px(float hi, int img_wh) {
  return (int)fmaxf(fminf(floorf(hi), (float)(img_wh - 1)), -1.0f);
}

template <bool kCount>
__global__ void __launch_bounds__(kFwdThreads, 4)
band_fwd_kernel(const float4* __restrict__ fc, const int* __restrict__ cymin,
                const int* __restrict__ cymax, const int* __restrict__ cxmin,
                const int* __restrict__ cxmax, const int* __restrict__ lo,
                const int* __restrict__ hi, float* __restrict__ out,
                unsigned long long* __restrict__ n_pairs, int n_chunks,
                int chunk, int img_wh, int n_bands, float inv_sigma,
                float margin) {
  __shared__ float4 faces[kFwdThreads * kRec];
  __shared__ float acc[kFwdWarps][kTilePx];   // each warp's own sums
  __shared__ int warp_hits[kFwdWarps];
  const int xt = blockIdx.x, band = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = xt * kTileW, y0 = band * kBandH;
  // The tile, for the chunk test (as the Pallas kernel has it) and for the
  // faces' padded boxes (against its first and last pixel centres).
  const float tx0 = (float)x0, tx1 = (float)(x0 + kTileW);
  const float ty0 = (float)y0, ty1 = (float)(y0 + kBandH);
  // The tile's pixels inside the image.
  const int last_x = min(x0 + kTileW, img_wh) - 1;
  const int last_y = min(y0 + kBandH, img_wh) - 1;
  float* my_acc = acc[warp];
#pragma unroll
  for (int i = lane; i < kTilePx; i += 32) my_acc[i] = 0.0f;
  __syncwarp();

  // The kernel clamps its own range: a NaN vertex upstream can never make
  // this loop run away.
  const int f_lo = clamp_int(lo[b * n_bands + band], 0, n_chunks) * chunk;
  const int f_hi = clamp_int(hi[b * n_bands + band], 0, n_chunks) * chunk;
  const float4* fc_b = fc + (size_t)b * n_chunks * chunk * kRec;

  unsigned long long cnt = 0;
  for (int base = f_lo; base < f_hi; base += kFwdThreads) {
    // Gather: which of the next 256 faces meet the tile?
    const int f = base + tid;
    bool hit = false;
    float4 box = make_float4(0.f, 0.f, 0.f, 0.f);
    if (f < f_hi && chunk_hits(cymin, cymax, cxmin, cxmax,
                               b * n_chunks + f / chunk, tx0, tx1, ty0, ty1,
                               margin)) {
      box = fc_b[(size_t)f * kRec + kRec - 1];
      // False for a NaN box.
      hit = box.y >= tx0 && box.x <= tx1 - 1.0f && box.w >= ty0 &&
            box.z <= ty1 - 1.0f;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, n_hit = 0;
#pragma unroll
    for (int w = 0; w < kFwdWarps; ++w) {
      const int h = warp_hits[w];
      offset += w < warp ? h : 0;
      n_hit += h;
    }
    if (hit) {
      float4* dst = faces + (offset + __popc(ballot & ((1u << lane) - 1u))) *
                                kRec;
      const float4* src = fc_b + (size_t)f * kRec;
#pragma unroll
      for (int j = 0; j < kRec - 1; ++j) cp_async16(dst + j, src + j);
      dst[kRec - 1] = box;
    }
    cp_async_wait_all();
    __syncthreads();

    // Evaluate: warp w takes faces w, w + 8, ... of the compacted list in
    // order; its lanes take the pixels of the face's box inside the tile,
    // one each, 32 at a time.
    for (int s = warp; s < n_hit; s += kFwdWarps) {
      const float4 bx = faces[s * kRec + kRec - 1];
      const int cx0 = max(first_px(bx.x, img_wh), x0);
      const int cx1 = min(last_px(bx.y, img_wh), last_x);
      const int cy0 = max(first_px(bx.z, img_wh), y0);
      const int cy1 = min(last_px(bx.w, img_wh), last_y);
      const int w = cx1 - cx0 + 1, n_px = w * (cy1 - cy0 + 1);
      if (w <= 0 || n_px <= 0) continue;  // uniform across the warp
      const Face fa = unpack(faces + s * kRec);
      const float inv_w = __frcp_rn((float)w);
      for (int i = lane; i < n_px; i += 32) {
        // Row i / w, exact: (i + 0.5) / w lies at least 1 / (2w) from an
        // integer, far beyond the rounding of the product.
        const int r = (int)(((float)i + 0.5f) * inv_w);
        const int px = cx0 + i - r * w, py = cy0 + r;
        float* a = my_acc + (py - y0) * kTileW + (px - x0);
        *a = __fadd_rn(*a, log_miss(fa, (float)px, (float)py, inv_sigma));
      }
      if (kCount && lane < n_px) cnt += (n_px - lane + 31) / 32;
      __syncwarp();
    }
    __syncthreads();  // faces[] and warp_hits[] are free for the next batch
  }
  __syncthreads();  // every warp's sums are in (also when no face came)
  // Each pixel's sum over the warps, in warp order.
  const int r = tid / kTileW, c = tid % kTileW;
  float sum = 0.0f;
#pragma unroll
  for (int w = 0; w < kFwdWarps; ++w) sum = __fadd_rn(sum, acc[w][tid]);
  if (x0 + c < img_wh && y0 + r < img_wh)
    out[((size_t)b * img_wh + y0 + r) * img_wh + x0 + c] =
        __fsub_rn(1.0f, expf(sum));
  if (kCount && cnt) atomicAdd(n_pairs, cnt);
}

template <bool kCount>
__global__ void __launch_bounds__(kBwdThreads, 8)
band_bwd_kernel(const float4* __restrict__ fc, const float* __restrict__ gs,
                float* __restrict__ dtri,
                unsigned long long* __restrict__ n_pairs, int f_pad,
                int img_wh, float inv_sigma) {
  const int f = blockIdx.x * kBwdThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (f >= f_pad) return;
  const float4* rec = fc + ((size_t)b * f_pad + f) * kRec;
  const float4 box = rec[kRec - 1];
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  // False for a NaN box.
  if (box.x <= box.y && box.z <= box.w) {
    const int ix0 = first_px(box.x, img_wh), ix1 = last_px(box.y, img_wh);
    const int iy0 = first_px(box.z, img_wh), iy1 = last_px(box.w, img_wh);
    if (ix0 <= ix1 && iy0 <= iy1) {
      const Face fa = unpack(rec);
      const float* gs_b = gs + (size_t)b * img_wh * img_wh;
      for (int iy = iy0; iy <= iy1; ++iy) {
        const float py = (float)iy;
        const float* row = gs_b + (size_t)iy * img_wh;
        for (int ix = ix0; ix <= ix1; ++ix)
          add_pair_grad(fa, (float)ix, py, __ldg(row + ix), inv_sigma, acc);
      }
      if (kCount)
        atomicAdd(n_pairs, (unsigned long long)(ix1 - ix0 + 1) *
                               (unsigned long long)(iy1 - iy0 + 1));
    }
  }
  float* d = dtri + ((size_t)b * f_pad + f) * 6;
#pragma unroll
  for (int j = 0; j < 6; ++j) d[j] = acc[j];
}

template <typename K>
int resources(K kernel, int threads, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = blocks;
  out[4] = threads;
  return 0;
}

}  // namespace

extern "C" int spt_band_raster_fwd(const float* fc, const int* cymin,
                                   const int* cymax, const int* cxmin,
                                   const int* cxmax, const int* lo,
                                   const int* hi, float* out,
                                   unsigned long long* n_pairs, int batch,
                                   int n_chunks, int chunk, int img_wh,
                                   int band_h, int tile_w, float inv_sigma,
                                   float margin, void* stream) {
  if (chunk < 1 || band_h != kBandH || tile_w != kTileW || img_wh < 1 ||
      batch < 1 || batch > 65535 || n_chunks < 1)
    return (int)cudaErrorInvalidValue;
  const int n_bands = (img_wh + kBandH - 1) / kBandH;
  const int n_xt = (img_wh + kTileW - 1) / kTileW;
  const dim3 grid(n_xt, n_bands, batch);
  const float4* fc4 = reinterpret_cast<const float4*>(fc);
  if (n_pairs)
    band_fwd_kernel<true><<<grid, kFwdThreads, 0, (cudaStream_t)stream>>>(
        fc4, cymin, cymax, cxmin, cxmax, lo, hi, out, n_pairs, n_chunks,
        chunk, img_wh, n_bands, inv_sigma, margin);
  else
    band_fwd_kernel<false><<<grid, kFwdThreads, 0, (cudaStream_t)stream>>>(
        fc4, cymin, cymax, cxmin, cxmax, lo, hi, out, n_pairs, n_chunks,
        chunk, img_wh, n_bands, inv_sigma, margin);
  return (int)cudaGetLastError();
}

extern "C" int spt_band_raster_bwd(const float* fc, const float* gs,
                                   float* dtri, unsigned long long* n_pairs,
                                   int batch, int f_pad, int img_wh,
                                   float inv_sigma, void* stream) {
  if (f_pad < 1 || img_wh < 1 || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((f_pad + kBwdThreads - 1) / kBwdThreads, batch);
  const float4* fc4 = reinterpret_cast<const float4*>(fc);
  if (n_pairs)
    band_bwd_kernel<true><<<grid, kBwdThreads, 0, (cudaStream_t)stream>>>(
        fc4, gs, dtri, n_pairs, f_pad, img_wh, inv_sigma);
  else
    band_bwd_kernel<false><<<grid, kBwdThreads, 0, (cudaStream_t)stream>>>(
        fc4, gs, dtri, n_pairs, f_pad, img_wh, inv_sigma);
  return (int)cudaGetLastError();
}

// Registers per thread, static shared bytes per block, local (spill and
// stack) bytes per thread, resident blocks per SM and threads per block of
// the fit's instantiations: out[0..4] for K1, out[5..9] for K2.
extern "C" int spt_band_raster_resources(int* out) {
  const int err = resources(band_fwd_kernel<false>, kFwdThreads, out);
  if (err) return err;
  return resources(band_bwd_kernel<false>, kBwdThreads, out + 5);
}
