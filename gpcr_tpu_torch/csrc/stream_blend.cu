// Forward front-to-back alpha blend of a tile-sorted splat stream.
//
// Replaces the TPU kernel gpcr_tpu/ops/rasterize_stream.py::_stream_kernel
// (launched by blend_stream through pl.pallas_call). It computes the
// reference renderCUDA semantics (forward.cu:264-377):
//   power = -0.5*(cx*dx^2 + cz*dy^2) - cy*dx*dy,  alpha = min(0.99, op*exp(power));
//   an entry is skipped when power > 0 or alpha < 1/255; a pixel stops BEFORE
//   the entry whose T*(1-alpha) < 1e-4 (that entry is not composited);
//   acc[c] += feat[c] * alpha * T.
//
// Layout (built by gpcr_tpu_torch/ops/rasterize_stream.py::bin_sorted_stream):
//   stream  (entries, ncols) f32 rows [x, y, conic(3), op, depth, 0, feat(C)],
//           sorted by (tile, depth rank);
//   starts  (num_tiles + 1,) i32, tile t owns rows [starts[t], starts[t+1]);
//   order   (n_order,) i32 tile ids to render, one CTA each, launched in this
//           order (render_order gives them longest first);
//   acc_out (num_tiles, P_out, C) f32 and t_out (num_tiles, P_out) f32, written
//           at the tile's own position (tiles never rendered keep what the
//           caller filled in: acc 0, T 1). P_out = 256, or 64 with downscale 2.
//   tile_base (serving kernel) the global id of local tile 0: starts, order
//           and the outputs index a window of the tile grid (the tile-sharded
//           path, the TPU kernel's prefetched base), the pixel origin is
//           that of global tile tile_base + t; 0 for the whole grid.
//
// What bounds it on Hopper. Every walked (entry, pixel) pair costs its alpha
// and the two skip tests (16 FP32 operations, one of them expf); only a live
// pair (not skipped) goes on to the 4 + 2C operations of compositing. The
// stream bytes are read once per tile (80 B per entry at C = 12). The floor
// is set by bytes on the learned streams (19.7% of the walked pairs live)
// and by operations on dense analytic ones. The first version (one CTA per
// tile, one thread per pixel, every pixel testing every entry) sat 9x above
// it: at the learned view 0 the CTA of the longest tile (8,984 entries, 6,403
// walked) spanned the whole kernel, half of the walked (entry, pixel) slots
// belonged to pixels that had already stopped, and every walked pair paid the
// expf whether or not its splat could reach the pixel.
//
// Design of the serving kernel (stream_blend_kernel).
// - One CTA per rendered 16x16 tile, one thread per pixel; warp w covers the
//   8x4 pixel block at ((w & 1) * 8, (w >> 1) * 4) of the tile.
// - Warp-level culling. When a chunk has landed in shared memory, one thread
//   per entry computes which of the 8 blocks its alpha can reach at >= 1/255
//   (block_mask: the bounding box of the ellipse q(d) <= 2 ln(255 op), widened
//   for float rounding, with no culling where the conic is not clearly
//   positive definite). Each warp turns 32 entries' mask bits into one ballot
//   word and walks only its set bits: a culled pair, which the plain version
//   skips, costs no expf and no instruction of the walk. A warp whose pixels
//   have all stopped leaves the chunk; the CTA leaves the tile when all have.
// - The walk takes its visited entries kGroup at a time: their alphas are
//   computed before any is composited, so the expf chains overlap (the
//   compositing, T's product, stays in order). Rows whose width is a
//   multiple of 16 B are read from shared memory with 16-byte loads.
// - Loads. Chunks are staged with cp.async into two shared-memory buffers
//   (16 B per copy when the rows are a multiple of 16 B, 4 B otherwise), the
//   next chunk's copy in flight while the current one is walked.
// - Order. Tiles run in the order given; render_order sorts them by
//   descending entry count, so the longest tiles start first.
// - With downscale 2 the CTA reduces the 2x2 means of acc and T in shared
//   memory (row-major pixel positions) and writes the 8x8 output tile:
//   compositing is linear, so out = acc_down + T_down * bg stays exact.
// Splitting long tiles over several CTAs would need the transmittance in
// front of each part, and a product of part factors rounds otherwise than
// the sequential one, which moves the 1e-4 termination of some pixels by an
// entry: this kernel keeps every pixel's walk sequential and exact.
//
// Contributor count (stream_count_kernel). The training forward replaces
// the TPU launch gpcr_tpu/ops/rasterize_stream_vjp.py::_fwd_impl
// (pl.pallas_call of _stream_kernel with with_contrib=True, downscale 1).
// Beside acc and T it writes, per pixel, how many positions of the tile's
// range [s, e) the pixel walked before it stopped: the in-tile index of the
// crossing entry when it terminated, else e - s. Skipped entries count as
// positions. The replay backward (stream_blend_bwd.cu) masks entries at or
// past this count. (The TPU kernel's count also runs over the padding rows
// of a tile's last chunk, which this kernel never stages, so a pixel that
// never terminates reports e - s here; the backward's pos < e mask makes
// the two equivalent.)
// Its first version kept the first serving walk: row-major warps, every
// pixel testing every entry, two CTA barriers per chunk, 1.59 ms at the
// training view 0 against a 0.015 ms bound, its longest CTA (the longest of
// 293 tiles, 12.9x the median) the whole kernel. Redesign, for Hopper:
// - the serving kernel's warp-block culling and grouped alphas (warps on
//   8x4 pixel blocks, blend_common.cuh walk_chunk), its cull masks computed
//   once per chunk by the first warp to reach it; tiles longest first
//   (render_order);
// - no CTA barrier per chunk: a ring of S stages guarded by mbarriers, one
//   producer warp copying each chunk with cp.async.bulk (4-byte cp.async
//   where rows are not 16-byte sized), and consumer warps that each walk
//   the ring at their own pace (blend_common.cuh ring_walk), so a tile
//   costs about its slowest warp's walk, not the sum over chunks of each
//   chunk's slowest warp. S is the most stages, up to 8, that fit in
//   64 KB: 8 of 64 rows of 80 B (41.7 KB) at the training shape
//   (gpcr_count_ring reports it).
// On an H100 it takes 0.53 ms at the training view 0 (was 1.55), still
// 36x its bound: the longest tile's slowest warp walks its 3,953 visited
// entries one after another, 95% of the kernel (PERF.md §6).
// It is a kernel function of its own: the serving kernel's register
// allocation is sensitive to its code (a change of that kind once moved a
// kernel's time by 18.6%), and its ptxas numbers must not move.
//
// Numerics. Built with -fmad=false and without --use_fast_math, and using
// expf, so each (entry, pixel) alpha and every transmittance product is the
// same float32 value the plain PyTorch version computes (culling removes only
// pairs the plain version skips); the channel sums differ in order, and
// both kernels form them with fused multiply-adds.

#include "blend_common.cuh"

namespace {

using gpcr::kPix;
using gpcr::kTile;

// Visited entries whose alphas overlap (gpcr::kGroup, 4): faster than 1
// and 2 at the learned view 0 on an H100, and 8 no faster (PERF.md §6).
using gpcr::kGroup;

// One (entry, pixel) pair's power and alpha, as the plain version forms them
// (no multiply-add contraction: the same float32 value). kVec4: the staged
// rows are a multiple of 16 B, so a row is read with 16-byte loads.
struct PairAlpha {
  float power, alpha;
};

template <bool kVec4>
__device__ __forceinline__ PairAlpha pair_alpha(const float* r, float px,
                                                float py) {
  float x, y, ca, cb, cc, op;
  if constexpr (kVec4) {
    const float4 g = *reinterpret_cast<const float4*>(r);
    const float2 h = *reinterpret_cast<const float2*>(r + 4);
    x = g.x, y = g.y, ca = g.z, cb = g.w, cc = h.x, op = h.y;
  } else {
    x = r[0], y = r[1], ca = r[2], cb = r[3], cc = r[4], op = r[5];
  }
  const float dx = x - px;
  const float dy = y - py;
  PairAlpha o;
  o.power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
  o.alpha = fminf(0.99f, op * expf(o.power));
  return o;
}

// Composite one pair into (T, acc) unless it is skipped; a pair whose
// T * (1 - alpha) would fall below 1e-4 stops the pixel instead. T is the
// plain version's product; acc takes fused multiply-adds (its sums run in
// another order than the plain version's anyway).
template <int C, bool kVec4>
__device__ __forceinline__ void composite(const float* r, PairAlpha pa,
                                          float& T, float (&acc)[C],
                                          int& done) {
  if (pa.power > 0.0f || pa.alpha < 1.0f / 255.0f) return;
  const float test_T = T * (1.0f - pa.alpha);
  if (test_T < 0.0001f) {
    done = 1;
    return;
  }
  const float w = pa.alpha * T;
  if constexpr (kVec4) {
#pragma unroll
    for (int q = 0; q < (C + 3) / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(r + 8)[q];
      const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * q + k < C) acc[4 * q + k] = fmaf(fv[k], w, acc[4 * q + k]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = fmaf(r[8 + c], w, acc[c]);
  }
  T = test_T;
}

// ---- serving kernel ----------------------------------------------------------

template <int C, bool kVec4>
__global__ void __launch_bounds__(kPix)
stream_blend_kernel(const float* __restrict__ stream, int ncols,
                    const int* __restrict__ starts,
                    const int* __restrict__ order, int grid_x, int tile_base,
                    int chunk, int downscale, bool vec, size_t mask_off,
                    float* __restrict__ acc_out, float* __restrict__ t_out) {
  GPCR_DIAG_SPAN;
  gpcr::WarpDiag wd;
  extern __shared__ float4 smem4[];
  float* const base = reinterpret_cast<float*>(smem4);  // 2 x chunk rows
  unsigned char* const mask =
      reinterpret_cast<unsigned char*>(smem4) + mask_off;  // chunk bytes

  const int tile = order[blockIdx.x];
  const int s = starts[tile];
  const int e = starts[tile + 1];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const gpcr::WarpPixel wp = gpcr::warp_pixel(tid);
  const int p = wp.p;
  const int global_tile = tile_base + tile;
  const float x0 = (float)((global_tile % grid_x) * kTile);
  const float y0 = (float)((global_tile / grid_x) * kTile);
  const float px = x0 + (float)wp.lx;
  const float py = y0 + (float)wp.ly;

  float T = 1.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  int done = 0;

  const int nch = (e - s + chunk - 1) / chunk;
  if (nch > 0)
    gpcr::stage(base, stream + (size_t)s * ncols, min(chunk, e - s) * ncols,
                vec);
  for (int ch = 0; ch < nch; ++ch) {
    const int first = s + ch * chunk;
    const int n = min(chunk, e - first);
    if (ch + 1 < nch) {
      gpcr::stage(base + (size_t)((ch + 1) & 1) * chunk * ncols,
                  stream + (size_t)(first + chunk) * ncols,
                  min(chunk, e - first - chunk) * ncols, vec);
    } else {
      gpcr::cp_async_commit();  // an empty group keeps the wait uniform
    }
    wd.wait_begin();
    gpcr::cp_async_wait_all_but_newest();
    __syncthreads();  // this chunk's rows are in
    wd.wait_end();
    const float* rows = base + (size_t)(ch & 1) * chunk * ncols;
    for (int j = tid; j < n; j += kPix)
      mask[j] = (unsigned char)gpcr::block_mask(rows + j * ncols, x0, y0);
    wd.wait_begin();
    __syncthreads();
    wd.wait_end();

    wd.chunk(!done);
    if (!__all_sync(0xffffffffu, done)) {
      for (int jb = 0; jb < n; jb += 32) {
        unsigned bits = __ballot_sync(
            0xffffffffu, jb + lane < n && ((mask[jb + lane] >> warp) & 1u));
        while (bits) {
          // kGroup visited entries at a time: their alphas are independent,
          // only the compositing runs in order
          int js[kGroup];
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            js[g] = bits ? jb + __ffs(bits) - 1 : -1;
            bits &= bits - 1u;
          }
          if (done) continue;
          int nv = 0;
#pragma unroll
          for (int g = 0; g < kGroup; ++g) nv += js[g] >= 0;
          wd.visit(nv);
          PairAlpha pa[kGroup];
#pragma unroll
          for (int g = 0; g < kGroup; ++g)  // js[0] stands in for a gap
            pa[g] = pair_alpha<kVec4>(rows + max(js[g], js[0]) * ncols, px,
                                      py);
#pragma unroll
          for (int g = 0; g < kGroup; ++g)
            if (js[g] >= 0 && !done)
              composite<C, kVec4>(rows + js[g] * ncols, pa[g], T, acc, done);
        }
        if (__all_sync(0xffffffffu, done)) break;
      }
    }
    // every thread is done with this chunk's rows and masks
    wd.wait_begin();
    const int n_done = __syncthreads_count(done);
    wd.wait_end();
    if (n_done == kPix) break;
  }
  gpcr::cp_async_wait_all();  // a copy of the next chunk may still fly
  wd.store();

  if (downscale == 1) {
    float* dst = acc_out + ((size_t)tile * kPix + p) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) dst[c] = acc[c];
    t_out[(size_t)tile * kPix + p] = T;
    return;
  }
  // downscale == 2: 2x2 means through shared memory (stride C + 1 floats
  // per pixel: acc then T), over the row buffers
  float* red = base;
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c) red[p * (C + 1) + c] = acc[c];
  red[p * (C + 1) + C] = T;
  __syncthreads();
  constexpr int kOut = kTile / 2;
  if (tid < kOut * kOut) {
    const int qy = tid / kOut;
    const int qx = tid % kOut;
    const float* a = red + ((2 * qy) * kTile + 2 * qx) * (C + 1);
    const float* b = a + (C + 1);
    const float* c2 = a + kTile * (C + 1);
    const float* d = c2 + (C + 1);
    float* dst = acc_out + ((size_t)tile * (kOut * kOut) + tid) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) dst[c] = (a[c] + b[c] + c2[c] + d[c]) * 0.25f;
    t_out[(size_t)tile * (kOut * kOut) + tid] =
        (a[C] + b[C] + c2[C] + d[C]) * 0.25f;
  }
}

// ---- contributor-count kernel (training forward) ----------------------------

// A tile's stream rows, chunk by chunk, for the ring (blend_common.cuh).
// bulk: the rows are a multiple of 16 B and the stream starts on a 16-byte
// boundary, so every chunk goes as one cp.async.bulk.
template <bool kVec4>
struct RowChunks {
  const float* src;  // the tile's first row
  int ncols, chunk, entries;
  bool bulk;
  __device__ int count() const { return (entries + chunk - 1) / chunk; }
  __device__ int n(int k) const { return min(chunk, entries - k * chunk); }
  __device__ void issue(int k, unsigned char* dst, unsigned long long* bar,
                        int lane) const {
    const float* from = src + (size_t)k * chunk * ncols;
    const unsigned nf = (unsigned)(n(k) * ncols);
    if (bulk) {
      if (lane == 0) {
        gpcr::mbar_arrive_expect_tx(bar, nf * 4u);
        gpcr::bulk_copy(dst, from, nf * 4u, bar);
      }
    } else {
      gpcr::copy4_warp(reinterpret_cast<float*>(dst), from, (int)nf, lane);
      gpcr::cp_async_arrive_noinc(bar);
    }
  }
  __device__ gpcr::RowView<kVec4> view(const unsigned char* stage) const {
    return {reinterpret_cast<const float*>(stage), ncols};
  }
};

// One CTA of gpcr::kRingThreads per rendered tile: the chunk ring, warp-block
// culling and grouped alphas of blend_common.cuh (ring_walk). The count of
// a pixel that stops is the in-tile index of the crossing entry (never
// culled: its alpha is at least 1/255), else e - s.
template <int C, bool kVec4>
__global__ void __launch_bounds__(gpcr::kRingThreads, 2)
stream_count_kernel(const float* __restrict__ stream, int ncols,
                    const int* __restrict__ starts,
                    const int* __restrict__ order, int grid_x, int chunk,
                    bool bulk, int stages, float* __restrict__ acc_out,
                    float* __restrict__ t_out,
                    int* __restrict__ n_contrib_out) {
  GPCR_DIAG_SPAN;
  gpcr::WarpDiag wd;
  extern __shared__ float4 ring_smem4[];
  const int tile = order[blockIdx.x];
  const int s = starts[tile];
  const int e = starts[tile + 1];
  const RowChunks<kVec4> chunks{stream + (size_t)s * ncols, ncols, chunk,
                                e - s, bulk};
  gpcr::PixelBlend<C> pb;
  int stop_at = -1;
  gpcr::ring_walk<C>(chunks, stages, (size_t)chunk * ncols * sizeof(float),
                     reinterpret_cast<unsigned char*>(ring_smem4),
                     (float)((tile % grid_x) * kTile),
                     (float)((tile / grid_x) * kTile), pb, stop_at, wd);
  wd.store();
  if (threadIdx.x >= kPix) return;
  const size_t q = (size_t)tile * kPix + gpcr::ring_pixel(threadIdx.x).p;
  float* dst = acc_out + q * C;
#pragma unroll
  for (int c = 0; c < C; ++c) dst[c] = pb.acc[c];
  t_out[q] = pb.T;
  n_contrib_out[q] = stop_at >= 0 ? stop_at : e - s;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();  // clear it for the caller
  return err;
}

template <int C>
cudaError_t launch(const float* stream, int ncols, const int* starts,
                   const int* order, int n_order, int grid_x, int tile_base,
                   int chunk, int downscale, float* acc_out, float* t_out,
                   cudaStream_t st) {
  const bool vec = gpcr::rows_vectorizable(stream, ncols);
  size_t floats = (size_t)2 * chunk * ncols;
  if (downscale == 2 && floats < (size_t)kPix * (C + 1))
    floats = (size_t)kPix * (C + 1);
  const size_t mask_off = floats * sizeof(float);
  const size_t smem = mask_off + (size_t)chunk;
  // rows of a multiple of 16 B sit 16-byte aligned in shared memory
  auto kernel = ncols % 4 == 0 ? stream_blend_kernel<C, true>
                               : stream_blend_kernel<C, false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_order, kPix, smem, st>>>(stream, ncols, starts, order, grid_x,
                                      tile_base, chunk, downscale, vec,
                                      mask_off, acc_out, t_out);
  return cudaGetLastError();
}

// The count kernel's ring for rows of ncols floats: stages and shared bytes.
int count_ring(int ncols, int chunk, size_t* smem) {
  const size_t stride =
      gpcr::ring_stride((size_t)chunk * ncols * sizeof(float), chunk);
  const int stages = gpcr::ring_stages(stride);
  *smem = gpcr::ring_smem(stages, stride);
  return stages;
}

template <int C>
cudaError_t launch_count(const float* stream, int ncols, const int* starts,
                         const int* order, int n_order, int grid_x, int chunk,
                         float* acc_out, float* t_out, int* n_contrib_out,
                         cudaStream_t st) {
  size_t smem;
  const int stages = count_ring(ncols, chunk, &smem);
  const bool bulk = gpcr::rows_vectorizable(stream, ncols);
  // rows of a multiple of 16 B sit 16-byte aligned in the stages
  auto kernel = ncols % 4 == 0 ? stream_count_kernel<C, true>
                               : stream_count_kernel<C, false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_order, gpcr::kRingThreads, smem, st>>>(
      stream, ncols, starts, order, grid_x, chunk, bulk, stages, acc_out,
      t_out, n_contrib_out);
  return cudaGetLastError();
}

#define GPCR_CHANNEL_SWITCH(CALL)                                       \
  switch (channels) {                                                  \
    case 1: return (int)CALL(1); case 2: return (int)CALL(2);          \
    case 3: return (int)CALL(3); case 4: return (int)CALL(4);          \
    case 5: return (int)CALL(5); case 6: return (int)CALL(6);          \
    case 7: return (int)CALL(7); case 8: return (int)CALL(8);          \
    case 9: return (int)CALL(9); case 10: return (int)CALL(10);        \
    case 11: return (int)CALL(11); case 12: return (int)CALL(12);      \
    case 13: return (int)CALL(13); case 14: return (int)CALL(14);      \
    case 15: return (int)CALL(15); case 16: return (int)CALL(16);      \
    default: return (int)cudaErrorInvalidValue;                        \
  }

}  // namespace

extern "C" {

// Both return a cudaError_t value: 0 on a successful launch.
int gpcr_stream_blend(const float* stream, int ncols, const int* starts,
                      const int* order, int n_order, int grid_x, int tile_base,
                      int channels, int chunk, int downscale, float* acc_out,
                      float* t_out, void* cuda_stream) {
  if (n_order <= 0) return (int)cudaSuccess;
  if (chunk <= 0 || ncols < 8 + channels || tile_base < 0 ||
      (downscale != 1 && downscale != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)cuda_stream;
#define GPCR_SERVE(NC)                                                      \
  launch<NC>(stream, ncols, starts, order, n_order, grid_x, tile_base, chunk, \
             downscale, acc_out, t_out, st)
  GPCR_CHANNEL_SWITCH(GPCR_SERVE)
#undef GPCR_SERVE
}

// The training forward: native resolution, plus n_contrib_out
// (num_tiles, 256) i32 written at each rendered tile's own position.
int gpcr_stream_blend_contrib(const float* stream, int ncols,
                              const int* starts, const int* order, int n_order,
                              int grid_x, int channels, int chunk,
                              float* acc_out, float* t_out, int* n_contrib_out,
                              void* cuda_stream) {
  if (n_contrib_out == nullptr) return (int)cudaErrorInvalidValue;
  if (n_order <= 0) return (int)cudaSuccess;
  if (chunk <= 0 || ncols < 8 + channels) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)cuda_stream;
#define GPCR_COUNT(NC)                                                 \
  launch_count<NC>(stream, ncols, starts, order, n_order, grid_x, chunk, \
                   acc_out, t_out, n_contrib_out, st)
  GPCR_CHANNEL_SWITCH(GPCR_COUNT)
#undef GPCR_COUNT
}

// The count kernel's ring stages for rows of ncols floats and chunk rows;
// its dynamic shared memory in *smem_bytes.
int gpcr_count_ring(int ncols, int chunk, int* smem_bytes) {
  size_t smem;
  const int stages = count_ring(ncols, chunk, &smem);
  *smem_bytes = (int)smem;
  return stages;
}

const char* gpcr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

GPCR_DIAG_SETTER(gpcr_stream_blend_set_diag)
