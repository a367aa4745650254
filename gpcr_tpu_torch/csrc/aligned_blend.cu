// Front-to-back alpha blend of ALL tiles of an image over the chunk-aligned
// layout.
//
// Replaces the TPU kernel gpcr_tpu/ops/rasterize_pallas.py::_blend_kernel
// (:116-225, launched by blend_pallas through pl.pallas_call, :285). It
// computes the reference renderCUDA semantics (forward.cu:264-377), as the
// stream kernel (stream_blend.cu) does:
//   power = -0.5*(cx*dx^2 + cz*dy^2) - cy*dx*dy,  alpha = min(0.99, op*exp(power));
//   an entry is skipped when power > 0 or alpha < 1/255; a pixel stops BEFORE
//   the entry whose T*(1-alpha) < 1e-4 (that entry is not composited and T is
//   not advanced past it); acc[c] += feat[c] * alpha * T.
//
// Layout (built by gpcr_tpu_torch/ops/rasterize_aligned.py::tile_bin_aligned):
//   chunk_starts (num_tiles + 1,) i32 in chunk units: tile t owns the whole
//                chunks [chunk_starts[t], chunk_starts[t+1]);
//   scal         (n_chunks, 6, CH) f32: per chunk the rows x, y, conic x / y / z,
//                opacity, gaussians along the last axis;
//   feat         (n_chunks, C, CH) f32: per chunk one row per channel;
//   acc_out      (num_tiles, 256, C) f32 and t_out (num_tiles, 256) f32, every
//                tile written (an empty tile gets acc 0 and T 1).
// The slots that pad a tile's last chunk are all zero: opacity 0 gives alpha 0,
// which the alpha < 1/255 test skips. The kernel gets no per-tile entry count
// and walks whole chunks.
//
// Design. What the TPU kernel does for its hardware is not carried over: the
// log-space shift-add cumsum along lanes, the (P, CH) x (Cpad, CH) matrix
// product, the channel padding to 8 and the 8-row T block serve the MXU and
// Mosaic's tiling. The first version here had one CTA per tile id,
// one thread per pixel, plain staging copies and two CTA barriers per chunk,
// every pixel testing every slot: 1.73 ms at the learned view 0, 14x its
// bound, its longest CTA (36 chunks) 76% of the kernel while 2,797 of the
// 4,096 CTAs were empty tiles. Redesign, for Hopper, the count forward's
// (stream_blend.cu) on the planar layout:
// - one CTA of gpcr::kRingThreads per tile, tiles launched in the order the
//   wrapper gives (rasterize_aligned.aligned_order: descending chunk count,
//   empty tiles last; their CTAs only write acc 0 and T 1);
// - warps on 8x4 pixel blocks cull each 32-slot group against their block
//   (gpcr::block_mask on the six scalars of a slot, computed once per chunk
//   by the first warp to reach it; a zero slot padding a tile's last chunk
//   reaches no block: PlanarView::mask) and take their visited slots'
//   alphas four at a time (blend_common.cuh walk_chunk);
// - a ring of S chunk stages with full / empty / ready mbarriers: the
//   producer warp copies a chunk's scalar block (6 * CH floats) and feature
//   block (C * CH floats) with two cp.async.bulk on the stage's full
//   barrier (4-byte cp.async where a block is not 16-byte sized or
//   aligned), and each consumer warp walks the ring at its own pace
//   (ring_walk). At chunk 256 and C = 12 a stage is 18 KB (and 256 mask
//   bytes) and S = 3 (gpcr_aligned_blend_stages).
//
// What bounds it on Hopper. As for the stream kernel: each walked (slot,
// pixel) pair costs 16 FP32 operations (alpha and the two skip tests, expf as
// one), a live pair 4 + 2C more; each slot is read once, (6 + C) * 4 bytes,
// padding slots included, and acc / T are written once for every tile of the
// image, empty ones too. On the learned stream bytes set the floor, on dense
// analytic ones operations. On an H100 it takes 0.76 ms at the learned view
// 0 (was 1.73), 6x its bound: what is left is the serial walk of the longest
// tiles' slowest warps (97% of the longest CTA; PERF.md §6).
//
// Numerics. Built with -fmad=false and without --use_fast_math, and using
// expf, so each alpha and every transmittance product is the float32 value the
// plain PyTorch version computes (culling removes only pairs it skips); only
// the channel accumulation order differs (fused multiply-adds here).

#include "blend_common.cuh"

namespace {

using gpcr::kPix;
using gpcr::kTile;
constexpr int kScalRows = 6;

// A tile's chunks of the planar layout, for the ring. bulk: both blocks of
// every chunk are 16-byte sized and aligned (CH a multiple of 4, scal and
// feat on 16-byte boundaries).
template <int C>
struct PlanarChunks {
  const float* scal;  // the tile's first chunk
  const float* feat;
  int chunk, nch;
  bool bulk;
  __device__ int count() const { return nch; }
  __device__ int n(int) const { return chunk; }
  __device__ void issue(int k, unsigned char* dst, unsigned long long* bar,
                        int lane) const {
    float* d = reinterpret_cast<float*>(dst);
    const float* s = scal + (size_t)k * kScalRows * chunk;
    const float* f = feat + (size_t)k * C * chunk;
    if (bulk) {
      if (lane == 0) {
        gpcr::mbar_arrive_expect_tx(bar,
                                    (unsigned)((kScalRows + C) * chunk) * 4u);
        gpcr::bulk_copy(d, s, (unsigned)(kScalRows * chunk) * 4u, bar);
        gpcr::bulk_copy(d + kScalRows * chunk, f, (unsigned)(C * chunk) * 4u,
                        bar);
      }
    } else {
      gpcr::copy4_warp(d, s, kScalRows * chunk, lane);
      gpcr::copy4_warp(d + kScalRows * chunk, f, C * chunk, lane);
      gpcr::cp_async_arrive_noinc(bar);
    }
  }
  __device__ gpcr::PlanarView view(const unsigned char* stage) const {
    return {reinterpret_cast<const float*>(stage), chunk};
  }
};

template <int C>
__global__ void __launch_bounds__(gpcr::kRingThreads, 2)
aligned_blend_kernel(const int* __restrict__ chunk_starts,
                     const int* __restrict__ order,
                     const float* __restrict__ scal,
                     const float* __restrict__ feat, int grid_x, int chunk,
                     bool bulk, int stages, float* __restrict__ acc_out,
                     float* __restrict__ t_out) {
  GPCR_DIAG_SPAN;
  gpcr::WarpDiag wd;
  extern __shared__ float4 ring_smem4[];
  const int tile = order[blockIdx.x];
  const int c0 = chunk_starts[tile];
  const int c1 = chunk_starts[tile + 1];
  const PlanarChunks<C> chunks{scal + (size_t)c0 * kScalRows * chunk,
                               feat + (size_t)c0 * C * chunk, chunk, c1 - c0,
                               bulk};
  gpcr::PixelBlend<C> pb;
  int stop_at = -1;
  gpcr::ring_walk<C>(chunks, stages,
                     (size_t)(kScalRows + C) * chunk * sizeof(float),
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
}

int ring(int channels, int chunk, size_t* smem) {
  const size_t stride = gpcr::ring_stride(
      (size_t)(kScalRows + channels) * chunk * sizeof(float), chunk);
  const int stages = gpcr::ring_stages(stride);
  *smem = gpcr::ring_smem(stages, stride);
  return stages;
}

template <int C>
cudaError_t launch(const int* chunk_starts, const int* order,
                   const float* scal, const float* feat, int num_tiles,
                   int grid_x, int chunk, float* acc_out, float* t_out,
                   cudaStream_t cuda_stream) {
  size_t smem;
  const int stages = ring(C, chunk, &smem);
  const bool bulk = chunk % 4 == 0 && ((uintptr_t)scal & 15) == 0 &&
                    ((uintptr_t)feat & 15) == 0;
  cudaError_t err = cudaFuncSetAttribute(
      aligned_blend_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the caller's next launch check sees it
    return err;
  }
  aligned_blend_kernel<C>
      <<<num_tiles, gpcr::kRingThreads, smem, cuda_stream>>>(
      chunk_starts, order, scal, feat, grid_x, chunk, bulk, stages, acc_out,
      t_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t value: 0 on a successful launch. order lists every
// tile id once (one CTA each, launched in this order); n_chunks is the
// leading size of scal and feat; a tile with no chunk reads neither.
int gpcr_aligned_blend(const int* chunk_starts, const int* order,
                       const float* scal, const float* feat, int n_chunks,
                       int num_tiles, int grid_x, int channels, int chunk,
                       float* acc_out, float* t_out, void* cuda_stream) {
  if (num_tiles <= 0) return (int)cudaSuccess;
  if (chunk <= 0 || grid_x <= 0 || n_chunks < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)cuda_stream;
#define GPCR_CASE(NC)                                                       \
  case NC:                                                                  \
    return (int)launch<NC>(chunk_starts, order, scal, feat, num_tiles,      \
                           grid_x, chunk, acc_out, t_out, st);
  switch (channels) {
    GPCR_CASE(1) GPCR_CASE(2) GPCR_CASE(3) GPCR_CASE(4) GPCR_CASE(5)
    GPCR_CASE(6) GPCR_CASE(7) GPCR_CASE(8) GPCR_CASE(9) GPCR_CASE(10)
    GPCR_CASE(11) GPCR_CASE(12) GPCR_CASE(13) GPCR_CASE(14) GPCR_CASE(15)
    GPCR_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GPCR_CASE
}

// The ring's stages for this many channels and chunk slots; its dynamic
// shared memory in *smem_bytes.
int gpcr_aligned_blend_stages(int channels, int chunk, int* smem_bytes) {
  size_t smem;
  const int stages = ring(channels, chunk, &smem);
  *smem_bytes = (int)smem;
  return stages;
}

const char* gpcr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"

GPCR_DIAG_SETTER(gpcr_aligned_blend_set_diag)
