// Pieces shared by the stream blend kernels (stream_blend.cu and
// stream_blend_bwd.cu): the tile and warp-block geometry, cp.async staging,
// the warp-block cull predicate and the diagnostic span record.
// gpcr_tpu_torch/ops/cuda_build.py hashes this header with each source.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace gpcr {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kWarps = kPix / 32;

// Warp w of a CTA covers the 8x4 pixel block at ((w & 1) * 8, (w >> 1) * 4)
// of its 16x16 tile; lane l the pixel (l & 7, l >> 3) of that block.
struct WarpPixel {
  int lx, ly;  // in the tile
  int p;       // row-major position in the tile, ly * 16 + lx
};

__device__ __forceinline__ WarpPixel warp_pixel(int tid) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  WarpPixel o;
  o.lx = (warp & 1) * 8 + (lane & 7);
  o.ly = (warp >> 1) * 4 + (lane >> 3);
  o.p = o.ly * kTile + o.lx;
  return o;
}

// ---- cp.async staging ------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every copy group of this thread but the newest has landed
__device__ __forceinline__ void cp_async_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Copy n floats (a multiple of 4, both ends 16-byte aligned, when vec) and
// close the copy group.
__device__ __forceinline__ void stage(float* dst, const float* src, int n,
                                      bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < n / 4; i += kPix)
      cp_async16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = threadIdx.x; i < n; i += kPix) cp_async4(dst + i, src + i);
  }
  cp_async_commit();
}

// Rows can go 16 B per copy: whole rows are a multiple of 16 B and the
// stream starts on a 16-byte boundary.
inline bool rows_vectorizable(const float* stream, int ncols) {
  return ncols % 4 == 0 && ((uintptr_t)stream & 15) == 0;
}

// ---- the cull predicate ----------------------------------------------------

// Which 8x4 pixel blocks of the tile at (x0, y0) the entry's alpha can reach
// at >= 1/255 (bit w: the block of warp w, pixel centres at integer offsets
// 0..7 x 0..3 from (x0 + (w & 1) * 8, y0 + (w >> 1) * 4)). Mirrored op for op
// by gpcr_tpu_torch/ops/rasterize_stream.py::block_mask_plain.
//
// With q(d) = a dx^2 + 2 b dx dy + c dy^2 (power = -q / 2), the plain
// version composites a pair only if op * expf(power) >= 1/255 and power <= 0,
// i.e. (exactly) q <= 2 tau, tau = ln(255 op). Float rounding of power is at
// most 3 eps K q with K = (max(a, c) + |b|) / lambda_min, and that of expf,
// the product and the log a few eps: so q <= 2 tau_eff with tau_eff =
// (tau + 1e-5 |tau| + 2e-5) / (1 - 1e-5 K), which bounds |dx| by
// sqrt(2 tau_eff c / det) and |dy| by sqrt(2 tau_eff a / det) (det = ac - b^2),
// widened by 0.1% and 0.05 px for the rounding of the box itself. Where the
// conic is not clearly positive definite (det <= 1e-3 ac), 1e-5 K >= 0.5, or
// a value is not finite, nothing is culled; op <= 0 culls everything (alpha
// <= 0 < 1/255).
__device__ __forceinline__ unsigned block_mask(const float* r, float x0,
                                               float y0) {
  const float mx = r[0], my = r[1], a = r[2], b = r[3], c = r[4], op = r[5];
  const float det = a * c - b * b;
  if (!(a > 0.0f && c > 0.0f && det > 1e-3f * (a * c) &&
        fabsf(mx) < 1e30f && fabsf(my) < 1e30f && op == op))
    return 0xffu;
  if (!(op > 0.0f)) return 0u;
  const float hdif = 0.5f * (a - c);
  const float lmax = 0.5f * (a + c) + sqrtf(hdif * hdif + b * b);
  const float K = (fmaxf(a, c) + fabsf(b)) * lmax / det;  // over lambda_min
  const float shrink = 1.0f - 1e-5f * K;
  if (!(shrink > 0.5f)) return 0xffu;
  const float tau = logf(255.0f * op);
  const float tau_eff = (tau + 1e-5f * fabsf(tau) + 2e-5f) / shrink;
  if (tau_eff < 0.0f) return 0u;
  const float hx = sqrtf(2.0f * tau_eff * c / det) * 1.001f + 0.05f;
  const float hy = sqrtf(2.0f * tau_eff * a / det) * 1.001f + 0.05f;
  unsigned m = 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float bx = x0 + (float)((w & 1) * 8);
    const float by = y0 + (float)((w >> 1) * 4);
    if (mx - hx <= bx + 7.0f && mx + hx >= bx && my - hy <= by + 3.0f &&
        my + hy >= by)
      m |= 1u << w;
  }
  return m;
}

}  // namespace gpcr

// ---- diagnostic span record --------------------------------------------------

// Diagnostic build only (nvcc -DGPCR_DIAG; the shipped libraries are built
// without it): GPCR_DIAG_SPAN at the top of a kernel makes each CTA record
// its clock64() span, its start and end on the global timer (ns) and its SM
// in gpcr_diag_buf[4 * blockIdx.x + 0..3]. Each source exports a setter for
// the buffer.
#ifdef GPCR_DIAG
static __device__ unsigned long long* gpcr_diag_buf;
struct GpcrDiagSpan {
  unsigned long long c0, g0;
  __device__ GpcrDiagSpan() {
    c0 = clock64();
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  }
  __device__ ~GpcrDiagSpan() {
    if (threadIdx.x != 0) return;
    unsigned long long g1;
    unsigned int sm;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    unsigned long long* d = gpcr_diag_buf + 4 * (size_t)blockIdx.x;
    d[0] = clock64() - c0;
    d[1] = g0;
    d[2] = g1;
    d[3] = sm;
  }
};
#define GPCR_DIAG_SPAN GpcrDiagSpan gpcr_diag_span
#define GPCR_DIAG_SETTER(name)                                          \
  extern "C" int name(void* buf) {                                      \
    return (int)cudaMemcpyToSymbol(gpcr_diag_buf, &buf, sizeof(buf));   \
  }
#else
#define GPCR_DIAG_SPAN
#define GPCR_DIAG_SETTER(name)
#endif
