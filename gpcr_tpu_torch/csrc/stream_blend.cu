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
//   order   (n_order,) i32 tile ids to render, one CTA each;
//   acc_out (num_tiles, P_out, C) f32 and t_out (num_tiles, P_out) f32, written
//           at the tile's own position (tiles never rendered keep what the
//           caller filled in: acc 0, T 1). P_out = 256, or 64 with downscale 2.
//
// Design. One CTA per rendered 16x16 tile, one thread per pixel (256). The
// CTA stages chunk rows of its stream range in shared memory with one
// coalesced copy, then every thread walks them sequentially; shared-memory
// reads of a row are broadcasts. The block leaves the walk as soon as every
// pixel is done (__syncthreads_count). With downscale 2 the CTA reduces the
// 2x2 means of acc and T in shared memory and writes the 8x8 output tile:
// compositing is linear, so out = acc_down + T_down * bg stays exact.
//
// What bounds it on Hopper. Per (entry, pixel) pair the thread does ~20 FP32
// ops and one expf; the stream bytes are read once per tile (~80 B per
// entry at C = 12), so the kernel is bound by the SM's FP32/SFU issue rate
// and by the serial dependence of each pixel's walk, not by HBM bandwidth.
// Big tiles (thousands of entries) run long on one SM while small ones end
// early; the per-tile CTA grid lets the hardware scheduler backfill SMs.
// Later work: cp.async double-buffering of the next chunk, and splitting the
// walk so tiles with many entries use more than one CTA.
//
// Numerics. Built with -fmad=false and without --use_fast_math, and using
// expf, so each (entry, pixel) alpha and every transmittance product is the
// same float32 value the plain PyTorch version computes; only the channel
// accumulation order differs.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;

template <int C>
__global__ void __launch_bounds__(kPix)
stream_blend_kernel(const float* __restrict__ stream, int ncols,
                    const int* __restrict__ starts,
                    const int* __restrict__ order, int grid_x, int chunk,
                    int downscale, float* __restrict__ acc_out,
                    float* __restrict__ t_out) {
  extern __shared__ float smem[];
  float* rows = smem;  // chunk * ncols staged stream rows

  const int tile = order[blockIdx.x];
  const int s = starts[tile];
  const int e = starts[tile + 1];
  const int tid = threadIdx.x;
  const float px = (float)((tile % grid_x) * kTile + tid % kTile);
  const float py = (float)((tile / grid_x) * kTile + tid / kTile);

  float T = 1.0f;
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  int done = 0;

  for (int base = s; base < e; base += chunk) {
    const int n = min(chunk, e - base);
    __syncthreads();  // every thread is done with the previous chunk
    const float* src = stream + (size_t)base * ncols;
    for (int i = tid; i < n * ncols; i += kPix) rows[i] = src[i];
    __syncthreads();
    if (!done) {
      for (int j = 0; j < n; ++j) {
        const float* r = rows + j * ncols;
        const float dx = r[0] - px;
        const float dy = r[1] - py;
        const float power =
            -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
        if (power > 0.0f) continue;
        const float alpha = fminf(0.99f, r[5] * expf(power));
        if (alpha < 1.0f / 255.0f) continue;
        const float test_T = T * (1.0f - alpha);
        if (test_T < 0.0001f) {
          done = 1;
          break;
        }
        const float w = alpha * T;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += r[8 + c] * w;
        T = test_T;
      }
    }
    if (__syncthreads_count(done) == kPix) break;
  }

  if (downscale == 1) {
    float* dst = acc_out + ((size_t)tile * kPix + tid) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) dst[c] = acc[c];
    t_out[(size_t)tile * kPix + tid] = T;
    return;
  }
  // downscale == 2: 2x2 means through shared memory (stride C + 1 floats
  // per pixel: acc then T)
  float* red = smem + (size_t)chunk * ncols;
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c) red[tid * (C + 1) + c] = acc[c];
  red[tid * (C + 1) + C] = T;
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

template <int C>
cudaError_t launch(const float* stream, int ncols, const int* starts,
                   const int* order, int n_order, int grid_x, int chunk,
                   int downscale, float* acc_out, float* t_out,
                   cudaStream_t cuda_stream) {
  size_t smem = (size_t)chunk * ncols * sizeof(float);
  if (downscale == 2) smem += (size_t)kPix * (C + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stream_blend_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the caller's next launch check sees it
    return err;
  }
  stream_blend_kernel<C><<<n_order, kPix, smem, cuda_stream>>>(
      stream, ncols, starts, order, grid_x, chunk, downscale, acc_out, t_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t value: 0 on a successful launch.
int gpcr_stream_blend(const float* stream, int ncols, const int* starts,
                      const int* order, int n_order, int grid_x, int channels,
                      int chunk, int downscale, float* acc_out, float* t_out,
                      void* cuda_stream) {
  if (n_order <= 0) return (int)cudaSuccess;
  if (chunk <= 0 || ncols < 8 + channels || (downscale != 1 && downscale != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)cuda_stream;
#define GPCR_CASE(NC)                                                       \
  case NC:                                                                  \
    return (int)launch<NC>(stream, ncols, starts, order, n_order, grid_x,   \
                           chunk, downscale, acc_out, t_out, st);
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
