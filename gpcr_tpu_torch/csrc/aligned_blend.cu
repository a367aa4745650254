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
// Mosaic's tiling. Here: one CTA per tile over all tiles, one thread per
// pixel (256). Per chunk the CTA copies the scalar block and the feature
// block into shared memory with coalesced loads (both are contiguous in
// device memory, 6 * CH and C * CH floats), then every thread walks the CH
// slots sequentially with T and the C accumulators in registers; the reads
// of a slot from shared memory are broadcasts. The block leaves the walk as
// soon as every pixel is done (__syncthreads_count), as the TPU kernel skips
// a chunk once no pixel is alive.
//
// What bounds it on Hopper. As for the stream kernel: each walked (slot,
// pixel) pair costs 16 FP32 operations (alpha and the two skip tests, expf as
// one), a live pair 4 + 2C more; each slot is read once, (6 + C) * 4 bytes,
// padding slots included, and acc / T are written once for every tile of the
// image, empty ones too. On the learned stream bytes set the floor, on dense
// analytic ones operations. The kernel is far above either floor, held by the
// serial dependence of each pixel's walk and by long tiles running on one SM
// while CTAs of empty tiles end at once. Later work: TMA or cp.async double
// buffering of the two blocks, splitting long tiles over several CTAs.
//
// Numerics. Built with -fmad=false and without --use_fast_math, and using
// expf, so each alpha and every transmittance product is the float32 value the
// plain PyTorch version computes; only the channel accumulation order differs.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kScalRows = 6;

template <int C>
__global__ void __launch_bounds__(kPix)
aligned_blend_kernel(const int* __restrict__ chunk_starts,
                     const float* __restrict__ scal,
                     const float* __restrict__ feat, int grid_x, int chunk,
                     float* __restrict__ acc_out, float* __restrict__ t_out) {
  extern __shared__ float smem[];
  float* s_scal = smem;                     // 6 rows of chunk slots
  float* s_feat = smem + kScalRows * chunk;  // C rows of chunk slots

  const int tile = blockIdx.x;
  const int c0 = chunk_starts[tile];
  const int c1 = chunk_starts[tile + 1];
  const int tid = threadIdx.x;
  const float px = (float)((tile % grid_x) * kTile + tid % kTile);
  const float py = (float)((tile / grid_x) * kTile + tid / kTile);

  float T = 1.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  int done = 0;

  for (int k = c0; k < c1; ++k) {
    __syncthreads();  // every thread is done with the previous chunk
    const float* ssrc = scal + (size_t)k * kScalRows * chunk;
    for (int i = tid; i < kScalRows * chunk; i += kPix) s_scal[i] = ssrc[i];
    const float* fsrc = feat + (size_t)k * C * chunk;
    for (int i = tid; i < C * chunk; i += kPix) s_feat[i] = fsrc[i];
    __syncthreads();
    if (!done) {
      for (int j = 0; j < chunk; ++j) {
        const float dx = s_scal[j] - px;
        const float dy = s_scal[chunk + j] - py;
        const float power =
            -0.5f * (s_scal[2 * chunk + j] * dx * dx +
                     s_scal[4 * chunk + j] * dy * dy) -
            s_scal[3 * chunk + j] * dx * dy;
        if (power > 0.0f) continue;
        const float alpha = fminf(0.99f, s_scal[5 * chunk + j] * expf(power));
        if (alpha < 1.0f / 255.0f) continue;
        const float test_T = T * (1.0f - alpha);
        if (test_T < 0.0001f) {
          done = 1;
          break;
        }
        const float w = alpha * T;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += s_feat[c * chunk + j] * w;
        T = test_T;
      }
    }
    if (__syncthreads_count(done) == kPix) break;
  }

  float* dst = acc_out + ((size_t)tile * kPix + tid) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) dst[c] = acc[c];
  t_out[(size_t)tile * kPix + tid] = T;
}

template <int C>
cudaError_t launch(const int* chunk_starts, const float* scal,
                   const float* feat, int num_tiles, int grid_x, int chunk,
                   float* acc_out, float* t_out, cudaStream_t cuda_stream) {
  const size_t smem = (size_t)(kScalRows + C) * chunk * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      aligned_blend_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the caller's next launch check sees it
    return err;
  }
  aligned_blend_kernel<C><<<num_tiles, kPix, smem, cuda_stream>>>(
      chunk_starts, scal, feat, grid_x, chunk, acc_out, t_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t value: 0 on a successful launch. n_chunks is the
// leading size of scal and feat; a tile with no chunk reads neither.
int gpcr_aligned_blend(const int* chunk_starts, const float* scal,
                       const float* feat, int n_chunks, int num_tiles,
                       int grid_x, int channels, int chunk, float* acc_out,
                       float* t_out, void* cuda_stream) {
  if (num_tiles <= 0) return (int)cudaSuccess;
  if (chunk <= 0 || grid_x <= 0 || n_chunks < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)cuda_stream;
#define GPCR_CASE(NC)                                                       \
  case NC:                                                                  \
    return (int)launch<NC>(chunk_starts, scal, feat, num_tiles, grid_x,     \
                           chunk, acc_out, t_out, st);
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

const char* gpcr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
