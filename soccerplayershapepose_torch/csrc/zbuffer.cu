// Banded hard z-buffer for Hopper (sm_90a): K3.
//
// Replaces the Pallas TPU kernel
//   soccerplayershapepose_tpu/render/pallas_zbuffer.py:_zbuf_kernel   (K3)
// with the same function and the same coarse pruning, not the same
// blocking. The host (render/zbuffer.py) y-sorts the faces, pads them to
// F_pad = n_chunks * chunk with the -1e9 degenerate sentinel (sorted last),
// computes the exact integer box of every chunk and each band's candidate
// range [lo, hi) (render/band_raster.py:_band_chunk_bounds, margin 1 px).
// A face far off the image (an absent occluder moved by +1e5 px) falls out
// through the band ranges. Once per call the host also writes one 20-float
// record per face (face_records):
//   [x0 y0 x1 y1 | x2 y2 z0 z1 | z2 dx0 dy0 dx1 | dy1 dx2 dy2 0 |
//    bx0 bx1 by0 by1]
// the vertices, their depths, the edge vectors (edge e runs from vertex
// (e + 1) % 3 to (e + 2) % 3: each a single rounded difference, so it
// rounds as the plain version's per-pair xb - xa does) and the face's float
// bounding box padded by P = 1 px. Sentinel faces get a box off the image,
// a face with a NaN vertex a NaN box: neither holds a pixel.
//
// Which pairs are evaluated. Only the (face, pixel) pairs whose pixel
// centre lies in the face's P-padded box. Why P = 1 px drops no covered
// pair: the rounded edge function fl(fl(dx fl(py - ya)) - fl(dy fl(px -
// xa))) differs from the exact one by at most 3u (|dx||py - ya| + |dy||px -
// xa|) with u = 2^-24 (three roundings on each product), so a pixel centre
// that passes the rounded inside test lies within eps = 3u sqrt(2) R of
// every edge line it violates, R the largest coordinate difference between
// a vertex and a pixel centre (eps ~ 1.5e-4 px at 512^2). A pixel centre
// outside the padded box lies at least P from the triangle, and a point at
// distance d from a triangle violates some edge line by at least
// d sin(theta_min / 2), theta_min its smallest angle. So P = 1 px is exact
// for every face with sin(theta_min / 2) > eps / P, an angle above ~3e-4 rad
// at 512^2. A face thinner than that (collinear up to rounding) can pass
// the rounded test anywhere along its own line: every box-based pruning
// drops those pairs (this kernel, its first port and the Pallas kernel,
// which drop them outside the tiles their chunk boxes meet), and only the
// dense plain version keeps them. tests/test_torch_zbuffer_prune.py pins
// both: no inside pair outside the boxes on the evaluation's scenes and on
// adversarial triangles, and the leak of a face collinear up to rounding.
//
// Grid and gather. A tile is 8 x 128 pixels (one band, four K1 tiles
// wide); a cluster of `split` blocks of 256 threads (8 warps) shares it,
// part k taking batches k, k + split, ... of 256 faces of the band's
// [lo, hi). In a batch each thread reads one face's padded box and clips it
// to the tile; a ballot and a prefix count compact the faces that hold a
// pixel of the tile into shared memory, with their clipped rectangles, and
// their records come in with cp.async. Warp w then takes faces w, w + 8,
// ... of the compacted list, and its lanes take the face's pixels in the
// tile, one pixel a lane, 32 at a time. K1's design, with four changes
// that measured faster here (PERF.md): no test of the chunk's integer box
// before the face's own (it implies nothing the face's box does not, and
// its four dependent loads cost more than the box loads it saves); tiles
// 4x as wide, so a band's faces are scanned by 4x fewer blocks; clusters
// (at least two blocks per tile, more while the grid is small), because a
// tile's work varies 20-fold and the heaviest tiles at 128^2 held the
// whole grid back; and an inside test without a branch per comparison.
// What bounds it now (scripts/probe_zbuffer_kernel.py): the walk, one
// face at a time per warp, with its edge functions and inside test for
// every pair of the padded boxes, then the inside pairs' division and
// atomic, then the gather.
//
// The winner, order-free. A lane whose pixel passes the inside test
// computes 1 / area (an IEEE division, only for inside pairs), w0, w1 and
// z, and, when z is neither +inf nor NaN, does a 64-bit atomicMin (a CAS
// loop on sm_90) into its block's key buffer in shared memory:
//   key = (order-preserving bits of z) << 32 | sorted face id.
// The least key is the least z, then the smallest sorted id: the plain
// version's and the Pallas kernel's tie rule, whatever order the warps and
// the parts reach the buffers in, so the result is the same from run to
// run. z = -0.0 becomes +0.0 first (the plain version's z <= zc treats them
// as equal), and +inf and NaN never enter (the plain version's zc < best_z
// never takes one). After a cluster barrier each pixel takes the least key
// of the parts' buffers (distributed shared memory), reloads the winner's
// record and recomputes w0, w1 with the same steps, so they are bit-equal
// to the pair's; a pixel with no key writes -1, 0, 0.
//
// The inside test is a hard decision, so the arithmetic uses the _rn
// intrinsics, which the compiler never contracts into FMAs, and an IEEE
// division: every step rounds as the separate PyTorch ops of the plain
// version (render/zbuffer.py:rasterize_bary_plain) round, and the face ids
// and barycentrics agree bit for bit.
//
// Operations per (face, pixel) pair, each fp32 add, sub, mul, div,
// comparison and absolute value counted as one (selects, boolean logic and
// the box test that selects the pair not counted): 36 for an inside pair =
// edge functions 3 x 5 (two relative coordinates, two products, one
// difference; the edge vectors come from the record) + area 2 + inside
// test 8 (six sign comparisons, |area|, > 1e-9) + inv_area 1 (division) +
// w0, w1 2 + z 7 (three products, two sums, 1 - w0 - w1) + the test of z
// against +inf 1; a pair that fails the inside test stops after 25. The
// count per pair is the first port's; chip_smoke.py multiplies it by the
// pixel centres inside each face's unpadded box for the bound. The bytes
// moved (the table, the chunk boxes, 12 bytes per pixel out) are a few tens
// of MB per call.
//
// The launcher returns cudaGetLastError() so that a refused launch is
// reported by the caller. With a non-null n_pairs a launch adds the pairs
// it evaluated there (a separate instantiation; the evaluation passes
// null).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBandH = 8;          // tile rows: render/band_raster.py BAND_H
constexpr int kTileW = 128;        // tile columns: render/zbuffer.py TILE_W
constexpr int kTilePx = kBandH * kTileW;
constexpr int kWarps = 8;          // each takes every 8th face of the tile
constexpr int kThreads = 32 * kWarps;
constexpr int kRec = 5;            // float4 per face record (20 floats)
constexpr int kFace = 4;           // of which the face's constants
constexpr unsigned long long kEmpty = ~0ull;

struct ZFace {
  float x[3], y[3], z[3];
  float dx[3], dy[3];  // edge e runs from vertex (e + 1) % 3 to (e + 2) % 3
};

__device__ __forceinline__ ZFace unpack(const float4* r) {
  const float4 a = r[0], b = r[1], c = r[2], d = r[3];
  ZFace f;
  f.x[0] = a.x; f.y[0] = a.y; f.x[1] = a.z; f.y[1] = a.w;
  f.x[2] = b.x; f.y[2] = b.y; f.z[0] = b.z; f.z[1] = b.w;
  f.z[2] = c.x; f.dx[0] = c.y; f.dy[0] = c.z; f.dx[1] = c.w;
  f.dy[1] = d.x; f.dx[2] = d.y; f.dy[2] = d.z;
  return f;
}

// Edge function of edge e (opposite vertex e) at pixel (px, py):
// (xb - xa)(py - ya) - (yb - ya)(px - xa).
__device__ __forceinline__ float edge_fn(const ZFace& f, int e, float px,
                                         float py) {
  const int a = (e + 1) % 3;
  return __fsub_rn(__fmul_rn(f.dx[e], __fsub_rn(py, f.y[a])),
                   __fmul_rn(f.dy[e], __fsub_rn(px, f.x[a])));
}

struct Pair {
  float e0, e1, e2, area;
};

__device__ __forceinline__ Pair pair_edges(const ZFace& f, float px,
                                           float py) {
  Pair p;
  p.e0 = edge_fn(f, 0, px, py);
  p.e1 = edge_fn(f, 1, px, py);
  p.e2 = edge_fn(f, 2, px, py);
  p.area = __fadd_rn(__fadd_rn(p.e0, p.e1), p.e2);
  return p;
}

__device__ __forceinline__ bool covers(const Pair& p) {
  // Bitwise & and |, not && and ||: no branch per comparison.
  const bool pos = (p.e0 >= 0.f) & (p.e1 >= 0.f) & (p.e2 >= 0.f);
  const bool neg = (p.e0 <= 0.f) & (p.e1 <= 0.f) & (p.e2 <= 0.f);
  return (pos | neg) & (fabsf(p.area) > 1e-9f);
}

// The barycentrics of a covered pair; bit-equal wherever they are
// recomputed.
__device__ __forceinline__ void bary(const Pair& p, float* w0, float* w1) {
  const float inv_area = __fdiv_rn(1.0f, p.area);
  *w0 = __fmul_rn(p.e0, inv_area);
  *w1 = __fmul_rn(p.e1, inv_area);
}

__device__ __forceinline__ float depth(const ZFace& f, float w0, float w1) {
  return __fadd_rn(
      __fadd_rn(__fmul_rn(w0, f.z[0]), __fmul_rn(w1, f.z[1])),
      __fmul_rn(__fsub_rn(__fsub_rn(1.0f, w0), w1), f.z[2]));
}

// (z, id) as one unsigned 64-bit key whose order is z's, then id's. z is
// neither NaN nor +inf here; -0.0 becomes +0.0.
__device__ __forceinline__ unsigned long long zkey(float z, int id) {
  const unsigned u = __float_as_uint(z == 0.0f ? 0.0f : z);
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)ord << 32) | (unsigned)id;
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
// image; empty (first > last) when the box misses it. A NaN side is
// excluded before: fminf and fmaxf would drop it.
__device__ __forceinline__ int first_px(float lo, int img_wh) {
  return (int)fminf(fmaxf(ceilf(lo), 0.0f), (float)img_wh);
}

__device__ __forceinline__ int last_px(float hi, int img_wh) {
  return (int)fmaxf(fminf(floorf(hi), (float)(img_wh - 1)), -1.0f);
}

template <bool kCount>
__global__ void __launch_bounds__(kThreads, 4)
zbuffer_bary_kernel(const float4* __restrict__ zr,
                    const int* __restrict__ lo, const int* __restrict__ hi,
                    int* __restrict__ fid_out, float* __restrict__ w0_out,
                    float* __restrict__ w1_out,
                    unsigned long long* __restrict__ n_pairs, int n_chunks,
                    int chunk, int img_wh, int n_bands) {
  __shared__ float4 faces[kThreads * kFace];
  __shared__ int4 rects[kThreads];    // x0, y0, width, pixels in the tile
  __shared__ float inv_ws[kThreads];  // 1 / width
  __shared__ int ids[kThreads];
  __shared__ unsigned long long keys[kTilePx];
  __shared__ int warp_hits[kWarps];
  // The blocks of a cluster share one tile: part k takes batches k,
  // k + split, ... of the band's faces.
  const cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int part = (int)cluster.block_rank();
  const int xt = blockIdx.x / split, band = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x0 = xt * kTileW, y0 = band * kBandH;
  // The tile's pixels inside the image.
  const int last_x = min(x0 + kTileW, img_wh) - 1;
  const int last_y = min(y0 + kBandH, img_wh) - 1;
  for (int i = tid; i < kTilePx; i += kThreads) keys[i] = kEmpty;

  // The kernel clamps its own range: a NaN vertex upstream can never make
  // this loop run away.
  const int f_lo = clamp_int(lo[b * n_bands + band], 0, n_chunks) * chunk;
  const int f_hi = clamp_int(hi[b * n_bands + band], 0, n_chunks) * chunk;
  const float4* zr_b = zr + (size_t)b * n_chunks * chunk * kRec;

  unsigned long long cnt = 0;
  for (int base = f_lo + part * kThreads; base < f_hi;
       base += split * kThreads) {
    // Gather: which of the next 256 faces hold a pixel of the tile? The
    // thread that tests a face also clips its box to the tile.
    const int f = base + tid;
    int4 rect = make_int4(0, 0, 0, 0);
    const float4 box = f < f_hi ? zr_b[(size_t)f * kRec + kRec - 1]
                                : make_float4(1.f, 0.f, 1.f, 0.f);
    if (box.x <= box.y && box.z <= box.w) {  // false for a NaN box
      const int cx0 = max(first_px(box.x, img_wh), x0);
      const int cx1 = min(last_px(box.y, img_wh), last_x);
      const int cy0 = max(first_px(box.z, img_wh), y0);
      const int cy1 = min(last_px(box.w, img_wh), last_y);
      if (cx0 <= cx1 && cy0 <= cy1)
        rect = make_int4(cx0, cy0, cx1 - cx0 + 1,
                         (cx1 - cx0 + 1) * (cy1 - cy0 + 1));
    }
    const bool hit = rect.w > 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(ballot);
    __syncthreads();
    int offset = 0, n_hit = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int h = warp_hits[w];
      offset += w < warp ? h : 0;
      n_hit += h;
    }
    if (hit) {
      const int slot = offset + __popc(ballot & ((1u << lane) - 1u));
      float4* dst = faces + slot * kFace;
      const float4* src = zr_b + (size_t)f * kRec;
#pragma unroll
      for (int j = 0; j < kFace; ++j) cp_async16(dst + j, src + j);
      rects[slot] = rect;
      inv_ws[slot] = __frcp_rn((float)rect.z);
      ids[slot] = f;
    }
    cp_async_wait_all();
    __syncthreads();

    // Evaluate: warp w takes faces w, w + 8, ... of the compacted list;
    // its lanes take the face's pixels in the tile, one each, 32 at a time.
    for (int s = warp; s < n_hit; s += kWarps) {
      const int4 rc = rects[s];
      const float inv_w = inv_ws[s];
      const ZFace fa = unpack(faces + s * kFace);
      const int id = ids[s];
      for (int i = lane; i < rc.w; i += 32) {
        // Row i / width, exact: (i + 0.5) / width lies at least
        // 1 / (2 width) from an integer, far beyond the rounding of the
        // product.
        const int r = (int)(((float)i + 0.5f) * inv_w);
        const int px = rc.x + i - r * rc.z, py = rc.y + r;
        const Pair p = pair_edges(fa, (float)px, (float)py);
        if (covers(p)) {
          float w0, w1;
          bary(p, &w0, &w1);
          const float z = depth(fa, w0, w1);
          if (z < INFINITY)  // false for +inf and NaN
            atomicMin(&keys[(py - y0) * kTileW + (px - x0)], zkey(z, id));
        }
      }
      if (kCount && lane < rc.w) cnt += (rc.w - lane + 31) / 32;
    }
    __syncthreads();  // the compacted list is free again
  }
  cluster.sync();  // every key of every part is in (also when no face came)

  // Resolve: part k takes pixels k, k + split, ... of the tile; each
  // decodes the least key of the parts' buffers and recomputes the
  // winner's barycentrics with the pair's own steps.
  for (int t = part + tid * split; t < kTilePx; t += kThreads * split) {
    unsigned long long key = kEmpty;
    for (int k = 0; k < split; ++k)
      key = min(key, *cluster.map_shared_rank(&keys[t], k));
    const int px = x0 + t % kTileW, py = y0 + t / kTileW;
    int fid = -1;
    float w0 = 0.0f, w1 = 0.0f;
    if (key != kEmpty) {
      fid = (int)(unsigned)(key & 0xffffffffull);
      const ZFace fa = unpack(zr_b + (size_t)fid * kRec);
      bary(pair_edges(fa, (float)px, (float)py), &w0, &w1);
    }
    if (px < img_wh && py < img_wh) {
      const size_t o = ((size_t)b * img_wh + py) * img_wh + px;
      fid_out[o] = fid;
      w0_out[o] = w0;
      w1_out[o] = w1;
    }
  }
  if (kCount && cnt) atomicAdd(n_pairs, cnt);
  cluster.sync();  // no part leaves while another still reads its keys
}

// Blocks that share one tile: at least two, more while the grid holds
// fewer than 16 blocks per SM, at most 8 (the portable cluster size).
int tile_split(int tiles) {
  int dev = 0, n_sm = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  int split = 2;
  while (split < 8 && (long long)tiles * split < 16LL * n_sm) split *= 2;
  return split;
}

template <bool kCount>
cudaError_t launch(const float4* zr, const int* lo, const int* hi, int* fid,
                   float* w0, float* w1, unsigned long long* n_pairs,
                   int batch, int n_chunks, int chunk, int img_wh,
                   cudaStream_t stream) {
  const int n_bands = (img_wh + kBandH - 1) / kBandH;
  const int n_xt = (img_wh + kTileW - 1) / kTileW;
  const int split = tile_split(n_xt * n_bands * batch);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_xt * split, n_bands, batch);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, zbuffer_bary_kernel<kCount>, zr, lo, hi,
                            fid, w0, w1, n_pairs, n_chunks, chunk, img_wh,
                            n_bands);
}

}  // namespace

extern "C" int spt_zbuffer_bary(const float* zr, const int* lo,
                                const int* hi, int* fid, float* w0, float* w1,
                                unsigned long long* n_pairs, int batch,
                                int n_chunks, int chunk, int img_wh,
                                int band_h, int tile_w, void* stream) {
  if (chunk < 1 || band_h != kBandH || tile_w != kTileW || img_wh < 1 ||
      batch < 1 || batch > 65535 || n_chunks < 1)
    return (int)cudaErrorInvalidValue;
  const float4* zr4 = reinterpret_cast<const float4*>(zr);
  const cudaError_t err =
      n_pairs ? launch<true>(zr4, lo, hi, fid, w0, w1, n_pairs, batch,
                             n_chunks, chunk, img_wh, (cudaStream_t)stream)
              : launch<false>(zr4, lo, hi, fid, w0, w1, n_pairs, batch,
                              n_chunks, chunk, img_wh, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Registers per thread, static shared bytes per block, local (spill and
// stack) bytes per thread, resident blocks per SM and threads per block of
// the evaluation's instantiation: out[0..4].
extern "C" int spt_zbuffer_resources(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, zbuffer_bary_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, zbuffer_bary_kernel<false>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)a.localSizeBytes;
  out[3] = blocks;
  out[4] = kThreads;
  return 0;
}
