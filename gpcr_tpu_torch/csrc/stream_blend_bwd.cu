// Replay backward of the stream blend: one gradient row per stream entry.
//
// Replaces the TPU kernel gpcr_tpu/ops/rasterize_stream_vjp.py::_bwd_kernel
// (launched by _blend_core_bwd through pl.pallas_call). Each rendered tile's
// entry range is walked BACK TO FRONT from the forward's final transmittance
// and per-pixel contributor count (stream_blend.cu, kContrib), so no
// per-entry forward state is stored. With a_i the forward's alpha of entry i
// at a pixel (zero when the entry was skipped, lies at or past the pixel's
// contributor count, or is out of range) and G_i = feat_i . dL/dout[pixel]:
//   T_excl_i = T_after / (1 - a_i), starting from T_final;
//   B_i      = T_final * dT_tot + sum_{k>i} a_k * T_excl_k * G_k;
//   dL/da_i  = T_excl_i * G_i - B_i / (1 - a_i)          where a_i > 0;
//   no gradient to power and opacity where op * exp(power) >= 0.99 (the
//   min(0.99, .) clamp has zero slope on its clamped branch);
//   dfeat_i[c] = sum_p a_i * T_excl_i * dL/dout[c, p].
// The row written for entry i, summed over the tile's 256 pixels, is
//   [dmean2d.x, dmean2d.y, dconic.x, dconic.y, dconic.z, dopacity, 0, 0,
//    dfeat(C), 0...]  (the column layout of the stream row).
//
// Layout: stream/starts/order as in stream_blend.cu; dl_dout (num_tiles, 256,
// C) f32, n_contrib (num_tiles, 256) i32, dt_tot and t_final (num_tiles, 256)
// f32, all at the tile's own position; grads (entries, ncols) f32, zeroed by
// the caller. Every entry row belongs to exactly one tile, so rows are
// written with plain stores: no atomics, and the result is deterministic.
// Rows of tiles that are not rendered, and rows past a tile's furthest
// contributor, keep the caller's zeros. (The TPU version writes whole chunks
// into uninitialised memory and so needs an ascending tile order and a
// "written" mask in its epilogue; neither has a counterpart here.)
//
// Design. One CTA per rendered 16x16 tile, one thread per pixel. The CTA
// reduces max n_contrib and walks only [s, s + min(e - s, max n_contrib)),
// staging chunk rows at a time in shared memory, last chunk first. Each
// thread keeps T_after, B and its C values of dL/dout in registers. Per
// entry the 6 + C per-pixel terms are reduced inside each warp with
// __shfl_down_sync; a warp whose pixels all have a == 0 skips the shuffles.
// Lane 0 of each warp stores the warp's partial sums in shared memory, and
// after the chunk the CTA adds the 8 partials of every (entry, column) and
// writes the chunk's rows with coalesced stores.
//
// What bounds it on Hopper. Every walked (entry, pixel) pair costs its alpha
// again (16 FP32 operations, one expf); a live pair costs 33 + 4C more, one
// of them a divide, and each warp with a live pixel does 5 * (6 + C) shuffles
// for the entry. The bytes are the stream rows read once and the gradient
// rows written once (80 B each at C = 12). With a few percent of the walked
// pairs live the floor of this work on an H100 is set by bytes on the learned
// streams and by operations on dense analytic ones; this first version is
// far above either, held by the warp shuffles and the serial walk.
// Later work: reduce across pixels with fewer shuffles (transposed
// partials), split long tiles over several CTAs.
//
// Numerics. -fmad=false, expf, IEEE divide. 1 / (1 - a) with a up to 0.99
// amplifies rounding over long ranges, so the kernel agrees with the plain
// PyTorch version (which forms the same products in another order) to a
// tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kWarps = kPix / 32;

template <int C>
__global__ void __launch_bounds__(kPix)
stream_blend_bwd_kernel(const float* __restrict__ stream, int ncols,
                        const int* __restrict__ starts,
                        const int* __restrict__ order, int grid_x, int chunk,
                        const float* __restrict__ dl_dout,
                        const int* __restrict__ n_contrib,
                        const float* __restrict__ dt_tot,
                        const float* __restrict__ t_final,
                        float* __restrict__ grads) {
  constexpr int kTerms = 6 + C;
  extern __shared__ float smem[];
  float* rows = smem;                          // chunk * ncols
  float* part = smem + (size_t)chunk * ncols;  // chunk * kWarps * kTerms
  __shared__ int warp_max[kWarps];

  const int tile = order[blockIdx.x];
  const int s = starts[tile];
  const int e = starts[tile + 1];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float px = (float)((tile % grid_x) * kTile + tid % kTile);
  const float py = (float)((tile / grid_x) * kTile + tid / kTile);
  const size_t pix = (size_t)tile * kPix + tid;

  const int nc = n_contrib[pix];
  int m = nc;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m = max(m, warp_max[w]);
  const int lim = min(e - s, m);  // entries past it have a == 0 everywhere
  if (lim <= 0) return;

  float dL[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dL[c] = dl_dout[pix * C + c];
  float T_after = t_final[pix];
  float B = T_after * dt_tot[pix];

  const int nch = (lim + chunk - 1) / chunk;
  for (int ch = nch - 1; ch >= 0; --ch) {
    const int off0 = ch * chunk;  // in-tile index of the chunk's first entry
    const int n = min(chunk, lim - off0);
    __syncthreads();  // the previous chunk's rows and partials are consumed
    const float* src = stream + (size_t)(s + off0) * ncols;
    for (int i = tid; i < n * ncols; i += kPix) rows[i] = src[i];
    __syncthreads();

    for (int j = n - 1; j >= 0; --j) {
      const float* r = rows + j * ncols;
      const float dx = r[0] - px;
      const float dy = r[1] - py;
      const float power =
          -0.5f * (r[2] * dx * dx + r[4] * dy * dy) - r[3] * dx * dy;
      const float gauss = expf(power);
      const float alpha_raw = r[5] * gauss;
      const float alpha = fminf(0.99f, alpha_raw);
      const bool live = !(power > 0.0f) && !(alpha < 1.0f / 255.0f) &&
                        (off0 + j < nc);
      float* dst = part + ((size_t)j * kWarps + warp) * kTerms;
      if (__ballot_sync(0xffffffffu, live) == 0u) {
        if (lane < kTerms) dst[lane] = 0.0f;
        continue;
      }
      float v[kTerms];
#pragma unroll
      for (int k = 0; k < kTerms; ++k) v[k] = 0.0f;
      if (live) {
        const float a = alpha;
        const float r_om = 1.0f / (1.0f - a);  // 1 - a >= 0.01
        const float T_excl = T_after * r_om;
        float G = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) G += r[8 + c] * dL[c];
        const float w = a * T_excl;
        const float dL_da = T_excl * G - B * r_om;
        if (alpha_raw < 0.99f) {
          const float dpow = dL_da * a;
          v[0] = -dpow * (r[2] * dx + r[3] * dy);
          v[1] = -dpow * (r[4] * dy + r[3] * dx);
          v[2] = -0.5f * dpow * dx * dx;
          v[3] = -dpow * dx * dy;
          v[4] = -0.5f * dpow * dy * dy;
          v[5] = dL_da * gauss;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) v[6 + c] = w * dL[c];
        B += w * G;
        T_after = T_excl;
      }
#pragma unroll
      for (int k = 0; k < kTerms; ++k) {
        float x = v[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          x += __shfl_down_sync(0xffffffffu, x, off);
        v[k] = x;
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kTerms; ++k) dst[k] = v[k];
      }
    }
    __syncthreads();

    // add the warps' partials and write the chunk's gradient rows
    float* out = grads + (size_t)(s + off0) * ncols;
    for (int i = tid; i < n * ncols; i += kPix) {
      const int j = i / ncols;
      const int col = i - j * ncols;
      int k = -1;
      if (col < 6) k = col;
      else if (col >= 8 && col < 8 + C) k = col - 2;
      float sum = 0.0f;
      if (k >= 0) {
        const float* p = part + (size_t)j * kWarps * kTerms + k;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += p[w * kTerms];
      }
      out[i] = sum;
    }
  }
}

template <int C>
cudaError_t launch(const float* stream, int ncols, const int* starts,
                   const int* order, int n_order, int grid_x, int chunk,
                   const float* dl_dout, const int* n_contrib,
                   const float* dt_tot, const float* t_final, float* grads,
                   cudaStream_t cuda_stream) {
  const size_t smem =
      ((size_t)chunk * ncols + (size_t)chunk * kWarps * (6 + C)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stream_blend_bwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the caller's next launch check sees it
    return err;
  }
  stream_blend_bwd_kernel<C><<<n_order, kPix, smem, cuda_stream>>>(
      stream, ncols, starts, order, grid_x, chunk, dl_dout, n_contrib, dt_tot,
      t_final, grads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t value: 0 on a successful launch.
int gpcr_stream_blend_bwd(const float* stream, int ncols, const int* starts,
                          const int* order, int n_order, int grid_x,
                          int channels, int chunk, const float* dl_dout,
                          const int* n_contrib, const float* dt_tot,
                          const float* t_final, float* grads,
                          void* cuda_stream) {
  if (n_order <= 0) return (int)cudaSuccess;
  if (chunk <= 0 || ncols < 8 + channels) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)cuda_stream;
#define GPCR_CASE(NC)                                                        \
  case NC:                                                                   \
    return (int)launch<NC>(stream, ncols, starts, order, n_order, grid_x,    \
                           chunk, dl_dout, n_contrib, dt_tot, t_final, grads, \
                           st);
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

const char* gpcr_bwd_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
