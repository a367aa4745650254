// Pieces shared by the stream blend kernels (stream_blend.cu and
// stream_blend_bwd.cu): the tile and warp-block geometry, cp.async staging,
// the warp-block cull predicate and the diagnostic span record; and the
// mbarrier and bulk-copy pieces of their chunk ring, which sparse_conv.cu's
// ring takes too. gpcr_tpu_torch/ops/cuda_build.py hashes this header with
// each source.

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
// <= 0 < 1/255). The six scalars come as values (the aligned blend's planar
// chunks hold them in six rows) or as a stream row.
__device__ __forceinline__ unsigned block_mask(float mx, float my, float a,
                                               float b, float c, float op,
                                               float x0, float y0) {
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

// The same for a stream row [x, y, conic x / y / z, opacity, ...].
__device__ __forceinline__ unsigned block_mask(const float* r, float x0,
                                               float y0) {
  return block_mask(r[0], r[1], r[2], r[3], r[4], r[5], x0, y0);
}

}  // namespace gpcr

// ---- diagnostic records ----------------------------------------------------

// Diagnostic build only (nvcc -DGPCR_DIAG; the shipped libraries are built
// without it). GPCR_DIAG_SPAN at the top of a kernel makes each CTA record
// in gpcr_diag_buf[4 * blockIdx.x + 0..3] its clock64() span, its start and
// end on the global timer (ns) and its SM; the span and the end are the
// largest over the CTA's warps (the buffer starts zeroed), so a CTA whose
// warps end at different times is timed to its last one. gpcr::WarpDiag
// records per warp w of CTA b, in gpcr_diag_warp_buf[4 * (b * kWarps + w) +
// 0..3]: the entries it visited (after culling, where the kernel culls), the
// clock64() cycles it spent waiting for a chunk (a CTA barrier or a ring
// stage), its cycles in all, and the chunks it walked. Each source exports
// a setter for each buffer. Without GPCR_DIAG every piece compiles to
// nothing.
#ifdef GPCR_DIAG
static __device__ unsigned long long* gpcr_diag_buf;
static __device__ unsigned long long* gpcr_diag_warp_buf;
struct GpcrDiagSpan {
  unsigned long long c0, g0;
  __device__ GpcrDiagSpan() {
    c0 = clock64();
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  }
  __device__ ~GpcrDiagSpan() {
    if ((threadIdx.x & 31) != 0) return;
    unsigned long long g1;
    unsigned int sm;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    unsigned long long* d = gpcr_diag_buf + 4 * (size_t)blockIdx.x;
    atomicMax(d, clock64() - c0);
    atomicMax(d + 2, g1);
    if (threadIdx.x == 0) {
      d[1] = g0;
      d[3] = sm;
    }
  }
};
#define GPCR_DIAG_SPAN GpcrDiagSpan gpcr_diag_span
#define GPCR_DIAG_SETTER(name)                                          \
  extern "C" int name(void* buf) {                                      \
    return (int)cudaMemcpyToSymbol(gpcr_diag_buf, &buf, sizeof(buf));   \
  }                                                                     \
  extern "C" int name##_warp(void* buf) {                               \
    return (int)cudaMemcpyToSymbol(gpcr_diag_warp_buf, &buf,            \
                                   sizeof(buf));                        \
  }
#else
#define GPCR_DIAG_SPAN
#define GPCR_DIAG_SETTER(name)
#endif

namespace gpcr {

struct WarpDiag {
#ifdef GPCR_DIAG
  unsigned long long visited = 0, wait = 0, chunks = 0, c0, t;
  __device__ WarpDiag() { c0 = clock64(); }
  __device__ void visit(unsigned n) { visited += n; }
  // counts the chunks in which some lane of the warp was live; every lane
  // of the warp calls it
  __device__ void chunk(bool live) {
    if (__any_sync(0xffffffffu, live)) ++chunks;
  }
  __device__ void wait_begin() { t = clock64(); }
  __device__ void wait_end() { wait += clock64() - t; }
  // lane 0 of each of the first kWarps warps writes its warp's record (the
  // visits: the most of any lane); every lane of the warp calls it
  __device__ void store() const {
    const unsigned v = __reduce_max_sync(0xffffffffu, (unsigned)visited);
    if ((threadIdx.x & 31) != 0 || (threadIdx.x >> 5) >= kWarps) return;
    unsigned long long* d =
        gpcr_diag_warp_buf +
        4 * ((size_t)blockIdx.x * kWarps + (threadIdx.x >> 5));
    d[0] = v;
    d[1] = wait;
    d[2] = clock64() - c0;
    d[3] = chunks;
  }
#else
  __device__ void visit(unsigned) {}
  __device__ void chunk(bool) {}
  __device__ void wait_begin() {}
  __device__ void wait_end() {}
  __device__ void store() const {}
#endif
};

}  // namespace gpcr

// ---- the chunk ring (contributor-count forward, aligned blend) -------------
//
// A CTA of kRingThreads: consumer warps 0..7 (one pixel per thread, the 8x4
// blocks of warp_pixel) and producer warp 8. The tile's chunks pass through
// a ring of S shared-memory stages, each guarded by three mbarriers: full,
// empty and ready. The producer copies chunk k into stage k % S once every
// consumer warp has released chunk k - S (empty), as one cp.async.bulk per
// block that completes on the full barrier's transaction count, or, where a
// block is not 16-byte sized and aligned, as 4-byte cp.async by all 32
// lanes that arrive on it (cp.async.mbarrier.arrive.noinc). The first
// consumer warp to reach a landed chunk (a per-stage claim, atomicMax)
// computes the cull masks of all its entries into the stage (block_mask,
// one entry per lane, all 8 blocks) and completes the ready barrier; the
// others wait on it, so the masks cost the CTA one warp's pass per chunk,
// paid by the warp furthest ahead. Each warp then walks the set bits of its
// own block kGroup at a time and arrives on the stage's empty barrier: no
// CTA-wide barrier per chunk, so a warp whose block sees few entries runs
// up to S - 1 chunks ahead, and the tile costs about its slowest warp's own
// walk, not the sum over chunks of each chunk's slowest warp.
//
// Deadlock rule. A warp whose pixels have all stopped leaves the walk and
// takes itself off a shared count of live warps; its lane 0 then keeps
// arriving on the empty barrier of every further chunk as that chunk lands,
// until the tile ends or no warp is live. The producer stops issuing once no
// warp is live (it polls the count while it waits for a stage), and before
// it leaves waits until every copy it issued has landed, so no copy writes
// into shared memory after the CTA is gone. A live warp waits only for
// chunks the producer will issue (it counts itself live) and for masks that
// a live warp is computing (only live warps claim a chunk).

namespace gpcr {

// The ring kernels declare __launch_bounds__(kRingThreads, 2): up to 112
// registers. Left to itself ptxas held them at 56 or 72 (4 or 3 CTAs per
// SM) and spilled up to 28 bytes at some channel counts.
constexpr int kRingThreads = kPix + 32;
constexpr int kRingStagesMax = 8;
// bytes of stages per CTA the ring aims at (2 stages at least)
constexpr size_t kRingBudget = 64 * 1024;
constexpr int kGroup = 4;  // visited entries whose alphas overlap

// The 8x4 block (warp_pixel's numbering) that consumer warp `warp` of the
// ring walks, and thread tid's pixel in it. Warps w and w + 4 share one of
// the SM's four schedulers (warp slots go round them); warp_pixel would give
// them the two blocks of one column, and a tile's busy side is often one
// half of it, so warps 4..7 take the blocks of the other column instead
// ((0, 0) with (8, 8), (8, 0) with (0, 8), ...): 1.05x on the count
// forward and the aligned blend at their view-0 shapes on an H100.
__device__ __forceinline__ int ring_block(int warp) {
  return warp ^ ((warp >> 2) & 1);
}
__device__ __forceinline__ WarpPixel ring_pixel(int tid) {
  return warp_pixel(ring_block(tid >> 5) * 32 + (tid & 31));
}

__host__ __device__ inline size_t round16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

// one stage: a chunk's rows_bytes, then one cull-mask byte per entry
__host__ __device__ inline size_t ring_stride(size_t rows_bytes, int chunk) {
  return round16(rows_bytes) + round16((size_t)chunk);
}

inline int ring_stages(size_t stride) {
  const size_t s = kRingBudget / stride;
  return (int)(s < 2 ? 2 : (s > (size_t)kRingStagesMax ? kRingStagesMax : s));
}

// the barriers (full[S], empty[S], ready[S]), the live-warp count and the
// claims (S ints), 16-byte padded
__host__ __device__ inline size_t ring_header(int stages) {
  return round16(28 * (size_t)stages + 4);
}

inline size_t ring_smem(int stages, size_t stride) {
  return ring_header(stages) + (size_t)stages * stride;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// true once the phase of this parity has completed
__device__ __forceinline__ bool mbar_try_wait(unsigned long long* bar,
                                              unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// global -> shared, completing on bar's transaction count (bytes a multiple
// of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// bar receives one arrival when every cp.async this thread issued so far
// has landed (counted in bar's expected arrivals)
__device__ __forceinline__ void cp_async_arrive_noinc(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// n floats by the 32 lanes of a warp, 4 B per copy
__device__ __forceinline__ void copy4_warp(float* dst, const float* src, int n,
                                           int lane) {
  for (int i = lane; i < n; i += 32) cp_async4(dst + i, src + i);
}

// ---- staged chunk views ----------------------------------------------------

struct Six {
  float x, y, a, b, c, op;  // mean, conic x / y / z, opacity
};

// Stream rows [x, y, conic(3), op, depth, 0, feat(C)] of ncols floats; kVec4:
// rows are a multiple of 16 B (and so is the stage), read with 16-byte loads.
template <bool kVec4>
struct RowView {
  // walk_chunk loads a group's features with its alphas (a row's are
  // contiguous: 3 16-byte loads at C = 12): 1.02x on the count forward at
  // the training view 0 and 1.06x at the 800K analytic shape on an H100
  static constexpr bool kPrefetch = true;
  const float* rows;
  int ncols;
  // the 8x4 blocks of the tile at (x0, y0) entry j can reach
  __device__ __forceinline__ unsigned mask(int j, float x0, float y0) const {
    const Six q = six(j);
    return block_mask(q.x, q.y, q.a, q.b, q.c, q.op, x0, y0);
  }
  __device__ __forceinline__ Six six(int j) const {
    const float* r = rows + j * ncols;
    if constexpr (kVec4) {
      const float4 g = *reinterpret_cast<const float4*>(r);
      const float2 h = *reinterpret_cast<const float2*>(r + 4);
      return Six{g.x, g.y, g.z, g.w, h.x, h.y};
    } else {
      return Six{r[0], r[1], r[2], r[3], r[4], r[5]};
    }
  }
  template <int C>
  __device__ __forceinline__ void feats(int j, float (&o)[C]) const {
    const float* f = rows + j * ncols + 8;
    if constexpr (kVec4) {
#pragma unroll
      for (int q = 0; q < (C + 3) / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(f)[q];
        const float fv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * q + k < C) o[4 * q + k] = fv[k];
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) o[c] = f[c];
    }
  }
};

// The aligned layout's chunk: 6 scalar rows then C feature rows of ch slots.
struct PlanarView {
  // a slot's features lie a chunk apart: walk_chunk reads them only for the
  // slots it composites (loading them with the alphas took 1.15x longer)
  static constexpr bool kPrefetch = false;
  const float* s;
  int ch;
  // block_mask, and none for a slot that pads a tile's last chunk (all
  // zero: power -0 and alpha 0 at every pixel, which the plain version
  // skips; block_mask itself keeps it, its conic being degenerate)
  __device__ __forceinline__ unsigned mask(int j, float x0, float y0) const {
    const Six q = six(j);
    if (q.op == 0.0f && q.a == 0.0f && q.b == 0.0f && q.c == 0.0f &&
        fabsf(q.x) < 1e30f && fabsf(q.y) < 1e30f)
      return 0u;
    return block_mask(q.x, q.y, q.a, q.b, q.c, q.op, x0, y0);
  }
  __device__ __forceinline__ Six six(int j) const {
    return Six{s[j], s[ch + j], s[2 * ch + j], s[3 * ch + j], s[4 * ch + j],
               s[5 * ch + j]};
  }
  template <int C>
  __device__ __forceinline__ void feats(int j, float (&o)[C]) const {
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = s[(6 + c) * ch + j];
  }
};

// ---- one warp's walk over a staged chunk -----------------------------------

template <int C>
struct PixelBlend {
  float T = 1.0f;
  float acc[C];
  int done = 0;
  __device__ PixelBlend() {
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  }
};

// Walk entries [0, n) of a staged chunk for this thread's pixel (px, py) of
// 8x4 block `block` of the tile: each 32-entry group is culled against the
// block (bit `block` of the chunk's masks, View::mask), and the set bits
// are visited kGroup at a time, their alphas (and, with View::kPrefetch,
// their features) loaded and computed before any is composited (the
// compositing, T's product, stays in order). Each alpha, skip test and T
// product rounds as the plain version's (-fmad=false, expf); acc takes
// fused multiply-adds. Returns the in-chunk index of the entry at which the
// pixel stopped (T * (1 - alpha) < 1e-4; not composited), or -1.
template <int C, class View>
__device__ __forceinline__ int walk_chunk(const View& v,
                                          const unsigned char* masks, int n,
                                          float px, float py, int block,
                                          int lane, PixelBlend<C>& pb,
                                          WarpDiag& wd) {
  int stop = -1;
  for (int jb = 0; jb < n; jb += 32) {
    const bool hit = jb + lane < n && ((masks[jb + lane] >> block) & 1u);
    unsigned bits = __ballot_sync(0xffffffffu, hit);
    while (bits) {
      int js[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        js[g] = bits ? jb + __ffs(bits) - 1 : -1;
        bits &= bits - 1u;
      }
      if (pb.done) continue;
      int nv = 0;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) nv += js[g] >= 0;
      wd.visit(nv);
      float alpha[kGroup], om[kGroup];
      bool keep[kGroup];
      float f[View::kPrefetch ? kGroup : 1][C];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {  // js[0] stands in for a gap
        const int j = max(js[g], js[0]);
        const Six q = v.six(j);
        const float dx = q.x - px;
        const float dy = q.y - py;
        const float power =
            -0.5f * (q.a * dx * dx + q.c * dy * dy) - q.b * dx * dy;
        alpha[g] = fminf(0.99f, q.op * expf(power));
        om[g] = 1.0f - alpha[g];
        keep[g] = js[g] >= 0 && !(power > 0.0f) && !(alpha[g] < 1.0f / 255.0f);
        if constexpr (View::kPrefetch) v.template feats<C>(j, f[g]);
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (!keep[g] || pb.done) continue;
        const float test_T = pb.T * om[g];
        if (test_T < 0.0001f) {
          pb.done = 1;
          stop = js[g];
          continue;
        }
        const float w = alpha[g] * pb.T;
        float* fg = f[View::kPrefetch ? g : 0];
        if constexpr (!View::kPrefetch) v.template feats<C>(js[g], f[0]);
#pragma unroll
        for (int c = 0; c < C; ++c) pb.acc[c] = fmaf(fg[c], w, pb.acc[c]);
        pb.T = test_T;
      }
    }
    if (__all_sync(0xffffffffu, pb.done)) break;
  }
  return stop;
}

// ---- the ring --------------------------------------------------------------

// Walk a tile's chunks through the ring in `smem` (ring_smem(stages,
// ring_stride(rows_bytes, chunks.chunk)) bytes, 16-byte aligned; rows_bytes
// is a whole chunk's). Every thread of the CTA calls it; Chunks gives
// count(), n(k) (entries of chunk k), chunk (its nominal length), bulk (its
// copies go as cp.async.bulk), issue(k, dst, bar, lane) (the producer
// warp's copy of chunk k) and view(stage), whose mask(j, x0, y0) is entry
// j's cull mask. Consumer threads (tid < kPix) return their pixel's blend in
// pb (for the pixel ring_pixel(tid)) and, if the pixel stopped, the
// in-tile index of the entry it stopped at in stop_at.
template <int C, class Chunks>
__device__ __forceinline__ void ring_walk(const Chunks& chunks, int stages,
                                          size_t rows_bytes,
                                          unsigned char* smem, float x0,
                                          float y0, PixelBlend<C>& pb,
                                          int& stop_at, WarpDiag& wd) {
  const int nch = chunks.count();
  if (nch == 0) return;  // the same in every thread
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + stages;
  unsigned long long* ready = empty + stages;
  volatile int* live = reinterpret_cast<volatile int*>(ready + stages);
  int* claim = const_cast<int*>(live) + 1;
  unsigned char* buf = smem + ring_header(stages);
  const size_t stride = ring_stride(rows_bytes, chunks.chunk);
  const size_t masks_at = round16(rows_bytes);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i, chunks.bulk ? 1u : 32u);
      mbar_init(empty + i, (unsigned)kWarps);
      mbar_init(ready + i, 1u);
      claim[i] = 0;
    }
    *live = kWarps;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {  // the producer
    int k = 0;
    for (; k < nch; ++k) {
      const int st = k % stages;
      int go = 1;
      if (lane == 0) {
        if (k >= stages) {  // every warp has released chunk k - S
          const unsigned par = (unsigned)((k / stages - 1) & 1);
          while (!mbar_try_wait(empty + st, par))
            if (*live == 0) break;
        }
        go = *live != 0;
      }
      go = __shfl_sync(0xffffffffu, go, 0);
      __syncwarp();
      if (!go) break;
      chunks.issue(k, buf + (size_t)st * stride, full + st, lane);
    }
    if (lane == 0)  // every issued copy has landed
      for (int j = k > stages ? k - stages : 0; j < k; ++j)
        while (!mbar_try_wait(full + j % stages,
                              (unsigned)((j / stages) & 1))) {
        }
    return;
  }

  const WarpPixel wp = ring_pixel(tid);
  const int block = ring_block(warp);
  const float px = x0 + (float)wp.lx;
  const float py = y0 + (float)wp.ly;
  for (int k = 0; k < nch; ++k) {
    const int st = k % stages;
    const unsigned par = (unsigned)((k / stages) & 1);
    unsigned char* stage = buf + (size_t)st * stride;
    const auto v = chunks.view(stage);
    unsigned char* masks = stage + masks_at;
    wd.wait_begin();
    while (!mbar_try_wait(full + st, par)) {
    }
    wd.wait_end();
    wd.chunk(true);
    int first = 0;  // the first warp here computes the chunk's masks
    if (lane == 0) first = atomicMax(claim + st, k + 1) <= k;
    if (__shfl_sync(0xffffffffu, first, 0)) {
      for (int j = lane; j < chunks.n(k); j += 32)
        masks[j] = (unsigned char)v.mask(j, x0, y0);
      __syncwarp();
      if (lane == 0) mbar_arrive(ready + st);
    } else {
      wd.wait_begin();
      while (!mbar_try_wait(ready + st, par)) {
      }
      wd.wait_end();
    }
    const int stop =
        walk_chunk<C>(v, masks, chunks.n(k), px, py, block, lane, pb, wd);
    if (stop >= 0) stop_at = k * chunks.chunk + stop;
    __syncwarp();  // every lane is done with the stage
    if (lane == 0) mbar_arrive(empty + st);
    if (__all_sync(0xffffffffu, pb.done)) {
      // the deadlock rule: release the further chunks as they land
      if (lane == 0) {
        atomicSub(const_cast<int*>(live), 1);
        for (++k; k < nch; ++k) {
          const int st2 = k % stages;
          bool landed;
          while (!(landed = mbar_try_wait(full + st2,
                                          (unsigned)((k / stages) & 1))))
            if (*live == 0) break;
          if (!landed) break;
          mbar_arrive(empty + st2);
        }
      }
      break;
    }
  }
}

}  // namespace gpcr
