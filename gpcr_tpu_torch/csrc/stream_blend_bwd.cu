// Replay backward of the stream blend: one gradient row per stream entry.
//
// Replaces the TPU kernel gpcr_tpu/ops/rasterize_stream_vjp.py::_bwd_kernel
// (launched by _blend_core_bwd through pl.pallas_call). No per-entry forward
// state is stored: each rendered tile's entry range is replayed from the
// forward's final transmittance and per-pixel contributor count
// (stream_blend.cu, the contributor-count kernel). With a_i the forward's
// alpha of entry i at a pixel (zero when the entry was skipped, lies at or
// past the pixel's contributor count, or is out of range) and
// G_i = feat_i . dL/dout[pixel]:
//   T_excl_i = prod_{k<i} (1 - a_k);
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
// the caller. Every entry row belongs to exactly one segment of one tile, so
// rows are written with plain stores by the one CTA that owns them: no
// atomics, and the same bits on every launch. Rows of tiles that are not
// rendered, and rows past a tile's furthest contributor, keep the caller's
// zeros. (The TPU version writes whole chunks into uninitialised memory and
// so needs an ascending tile order and a "written" mask in its epilogue;
// neither has a counterpart here.)
//
// What bounds it on Hopper. Every walked (entry, pixel) pair costs its alpha
// (16 FP32 operations, one expf); a live pair costs 33 + 4C more, one of them
// a divide, plus the sum over the tile's pixels of its 6 + C terms. The bytes
// are the stream rows read once and the gradient rows written once (80 B
// each at C = 12). With a few percent of the walked pairs live the floor is
// set by bytes on the learned streams. The first version (one CTA per tile)
// sat 148x above it: at the training shape 293 tiles (up to 11,339 entries,
// median 882) gave the 132 SMs a few CTAs each, the longest tile's serial
// walk was the whole kernel, and every live entry cost 5 * (6 + C) warp
// shuffles.
//
// Design.
// 1. Tile split. Each tile's walked range [0, lim) (lim = min(range, max
//    n_contrib over the tile's pixels)) is cut into segments of L entries,
//    L = the smallest multiple of the chunk that is >= kSegMin, and every
//    (tile, segment) gets a CTA of each pass. With P_k = prod_{i in k}
//    (1 - a_i) and S_k = sum_{i in k} a_i * t_i * G_i (t_i the product of
//    (1 - a) before i inside segment k):
//      T_end(k) = prod_{k' <= k} P_k'           (transmittance behind k),
//      B_end(k) = T_final * dT_tot + sum_{k' > k} T_end(k' - 1) * S_k'.
//    seg_summary_kernel writes (P_k, S_k) per (segment, pixel) into the
//    caller's scratch; seg_scan_kernel (one CTA per tile) turns them into
//    (T_end(k), B_end(k)) in place; stream_blend_bwd_kernel then walks its
//    segment back to front from (T_end, B_end) as the one-CTA-per-tile
//    version walked the whole range: T_excl_i = T_after / (1 - a_i),
//    B += a T_excl G. The divisions now run over at most L entries.
//    The wrapper lays out the segments: plan row 0 is the inclusive prefix
//    sum over order of the tiles' segment counts, row 1 each tile's lim. A
//    CTA finds its (tile, segment) by binary search in row 0, and the grid
//    is launched at the bound ceil(entries / L) + tiles, so the host never
//    waits for the count.
// 2. Reduce-scatter over pixels. Per live entry each warp sums its 32
//    pixels' 6 + C terms, padded to N = 16 or 32, with a butterfly in which
//    every round halves the values a lane holds: N - 1 shuffles (31 at
//    C = 12; 16 at C = 3 with the last half-warp exchange) instead of
//    5 * (6 + C), and lane k ends with term k and stores it. A warp whose
//    pixels all have a == 0 does no shuffle and stores nothing. After a chunk
//    the CTA adds the 8 warp partials of every (entry, column) and writes the
//    chunk's rows with coalesced stores.
// 3. Loads. Chunks are staged with cp.async into two shared-memory buffers,
//    16 B per copy when rows are a multiple of 16 B (C = 12: 80 B rows), so
//    the next chunk's copy runs while the current one is walked.
// 4. Culling, as in the serving blend: warp w covers the 8x4 pixel block of
//    blend_common.cuh, a chunk's entries get one bit per block
//    (gpcr::block_mask) and each warp visits only its set bits, below the
//    largest contributor count among its pixels: a culled or dead pair has
//    a == 0 and adds nothing to T, B or any row. Both per-segment passes
//    walk this way; the warp partials of a chunk start at zero.
//
// Numerics. -fmad=false, expf, IEEE divide. 1 / (1 - a) with a up to 0.99
// amplifies rounding over a range, and the segment factors form T in another
// order than the plain PyTorch version (which divides down from T_final over
// the whole range), so the two agree to a tolerance, not bit for bit.

#include "blend_common.cuh"

namespace {

using gpcr::kPix;
using gpcr::kTile;
using gpcr::kWarps;
constexpr int kSegMin = 128;  // entries per segment, at least

int segment_length(int chunk) {
  return chunk * ((kSegMin + chunk - 1) / chunk);
}

// ---- segment lookup --------------------------------------------------------

struct Segment {
  int g;   // position in order (-1: this CTA has no segment)
  int k0;  // first in-tile entry of the segment
  int k1;  // one past its last
};

// plan: row 0 the inclusive prefix sum over order of the tiles' segment
// counts, row 1 each tile's lim. The result is the same in every thread.
__device__ Segment find_segment(const int* __restrict__ plan, int n_order,
                                int seg_len) {
  __shared__ Segment sh;
  if (threadIdx.x == 0) {
    const int b = blockIdx.x;
    Segment r{-1, 0, 0};
    if (b < plan[n_order - 1]) {
      int lo = 0, hi = n_order - 1;  // the first g with plan[g] > b
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (plan[mid] > b) hi = mid;
        else lo = mid + 1;
      }
      r.g = lo;
      r.k0 = (b - (lo > 0 ? plan[lo - 1] : 0)) * seg_len;
      r.k1 = min(r.k0 + seg_len, plan[n_order + lo]);
    }
    sh = r;
  }
  __syncthreads();
  return sh;
}

// The forward's alpha of one staged row at pixel (px, py); live where the
// forward composited it (not skipped, before the pixel's contributor count).
struct Alpha {
  float dx, dy, gauss, raw, a;
  bool live;
};

__device__ __forceinline__ Alpha alpha_at(const float* r, float px, float py,
                                          bool before_count) {
  Alpha o;
  o.dx = r[0] - px;
  o.dy = r[1] - py;
  const float power =
      -0.5f * (r[2] * o.dx * o.dx + r[4] * o.dy * o.dy) - r[3] * o.dx * o.dy;
  o.gauss = expf(power);
  o.raw = r[5] * o.gauss;
  o.a = fminf(0.99f, o.raw);
  o.live = !(power > 0.0f) && !(o.a < 1.0f / 255.0f) && before_count;
  return o;
}

// G = feat . dL/dout at the pixel, with fused multiply-adds (only the alpha
// and the live test must round as the forward does)
template <int C>
__device__ __forceinline__ float feat_dot(const float* r, const float (&dL)[C]) {
  float G = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) G = fmaf(r[8 + c], dL[c], G);
  return G;
}

// ---- reduce-scatter over a warp ---------------------------------------------

// One butterfly round per H = N/2 .. 1: lanes that differ in bit H give each
// other the half they do not keep, so each keeps H sums of two lanes.
template <int H, int N>
struct ReduceScatter {
  static __device__ __forceinline__ void run(float (&v)[N], int lane) {
    const bool upper = (lane & H) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float give = upper ? v[i] : v[i + H];
      const float keep = upper ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, give, H);
    }
    ReduceScatter<H / 2, N>::run(v, lane);
  }
};
template <int N>
struct ReduceScatter<0, N> {
  static __device__ __forceinline__ void run(float (&)[N], int) {}
};

// The warp's sum of term (lane % N) of v (N = 16 or 32 values per lane).
template <int N>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[N],
                                                     int lane) {
  ReduceScatter<N / 2, N>::run(v, lane);
  float x = v[0];
  if (N == 16) x += __shfl_xor_sync(0xffffffffu, x, 16);
  return x;
}

// ---- the walk's pixel and its warp's reach ------------------------------------

// This thread's pixel (the 8x4 warp blocks of blend_common.cuh) in its tile,
// its contributor count, and the largest count among its warp's pixels:
// entries at or past it are dead for the whole warp.
struct PixelState {
  float x0, y0, px, py;
  size_t pix;  // tile * 256 + row-major position
  int p, nc, warp_nc;
};

__device__ __forceinline__ PixelState pixel_state(
    int tile, int grid_x, const int* __restrict__ n_contrib) {
  const gpcr::WarpPixel wp = gpcr::warp_pixel(threadIdx.x);
  PixelState o;
  o.x0 = (float)((tile % grid_x) * kTile);
  o.y0 = (float)((tile / grid_x) * kTile);
  o.px = o.x0 + (float)wp.lx;
  o.py = o.y0 + (float)wp.ly;
  o.p = wp.p;
  o.pix = (size_t)tile * kPix + wp.p;
  o.nc = n_contrib[o.pix];
  int m = o.nc;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  o.warp_nc = m;
  return o;
}

// One cull bit per warp block for each of the chunk's n staged rows.
__device__ __forceinline__ void chunk_masks(unsigned char* mask,
                                            const float* rows, int n,
                                            int ncols, float x0, float y0) {
  for (int j = threadIdx.x; j < n; j += kPix)
    mask[j] = (unsigned char)gpcr::block_mask(rows + j * ncols, x0, y0);
}

// The chunk's rows [jb, jb + 32) that this warp visits: its cull bit set
// and below both the chunk's end and the warp's reach.
__device__ __forceinline__ unsigned visit_bits(const unsigned char* mask,
                                               int jb, int n_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  return __ballot_sync(0xffffffffu, jb + lane < n_warp &&
                                        ((mask[jb + lane] >> warp) & 1u));
}

// ---- pass 1: per-segment factors ---------------------------------------------

// (at least two CTAs per SM: up to 128 registers, where C = 12 spilled at
// the 64 that ptxas chose by itself)
template <int C>
__global__ void __launch_bounds__(kPix, 2)
seg_summary_kernel(const float* __restrict__ stream, int ncols,
                   const int* __restrict__ starts,
                   const int* __restrict__ order, int n_order, int grid_x,
                   int chunk, int seg_len, bool vec,
                   const int* __restrict__ plan,
                   const float* __restrict__ dl_dout,
                   const int* __restrict__ n_contrib,
                   float* __restrict__ scratch) {
  extern __shared__ float4 smem4[];
  float* const base = reinterpret_cast<float*>(smem4);  // 2 x chunk rows
  unsigned char* const mask =
      reinterpret_cast<unsigned char*>(base + (size_t)2 * chunk * ncols);
  const Segment sg = find_segment(plan, n_order, seg_len);
  if (sg.g < 0) return;
  const int tile = order[sg.g];
  const int s = starts[tile];
  const PixelState ps = pixel_state(tile, grid_x, n_contrib);
  float dL[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dL[c] = dl_dout[ps.pix * C + c];

  float t = 1.0f, S = 0.0f;
  const int nch = (sg.k1 - sg.k0 + chunk - 1) / chunk;
  gpcr::stage(base, stream + (size_t)(s + sg.k0) * ncols,
              min(chunk, sg.k1 - sg.k0) * ncols, vec);
  for (int ch = 0; ch < nch; ++ch) {
    const int off0 = sg.k0 + ch * chunk;
    const int n = min(chunk, sg.k1 - off0);
    if (ch + 1 < nch) {
      gpcr::stage(base + (size_t)((ch + 1) & 1) * chunk * ncols,
                  stream + (size_t)(s + off0 + chunk) * ncols,
                  min(chunk, sg.k1 - off0 - chunk) * ncols, vec);
    } else {
      gpcr::cp_async_commit();  // an empty group keeps the wait uniform
    }
    gpcr::cp_async_wait_all_but_newest();
    __syncthreads();
    const float* rows = base + (size_t)(ch & 1) * chunk * ncols;
    chunk_masks(mask, rows, n, ncols, ps.x0, ps.y0);
    __syncthreads();
    const int n_warp = min(n, ps.warp_nc - off0);
    for (int jb = 0; jb < n_warp; jb += 32) {
      unsigned bits = visit_bits(mask, jb, n_warp);
      while (bits) {
        const int j = jb + __ffs(bits) - 1;
        bits &= bits - 1u;
        const float* r = rows + j * ncols;
        const Alpha al = alpha_at(r, ps.px, ps.py, off0 + j < ps.nc);
        if (al.live) {
          const float G = feat_dot<C>(r, dL);
          S += al.a * t * G;
          t = t * (1.0f - al.a);
        }
      }
    }
    __syncthreads();  // rows and masks are refilled for the chunk after next
  }
  float* out = scratch + (size_t)blockIdx.x * 2 * kPix;
  out[ps.p] = t;
  out[kPix + ps.p] = S;
}

// ---- pass 2: per-tile scan of the segment factors ----------------------------

__global__ void __launch_bounds__(kPix)
seg_scan_kernel(const int* __restrict__ order, const int* __restrict__ plan,
                const float* __restrict__ dt_tot,
                const float* __restrict__ t_final,
                float* __restrict__ scratch) {
  const int g = blockIdx.x;
  const int b0 = g > 0 ? plan[g - 1] : 0;
  const int b1 = plan[g];
  if (b1 == b0) return;
  const int p = threadIdx.x;  // row-major pixel position
  const size_t pix = (size_t)order[g] * kPix + p;
  float T = 1.0f;
  for (int b = b0; b < b1; ++b) {  // P_k -> T_end(k)
    float* q = scratch + (size_t)b * 2 * kPix + p;
    T = T * *q;
    *q = T;
  }
  float B = t_final[pix] * dt_tot[pix];
  for (int b = b1 - 1; b >= b0; --b) {  // S_k -> B_end(k)
    float* q = scratch + (size_t)b * 2 * kPix + kPix + p;
    const float S = *q;
    *q = B;
    const float t_in = b > b0 ? scratch[(size_t)(b - 1) * 2 * kPix + p] : 1.0f;
    B += t_in * S;
  }
}

// ---- pass 3: the back-to-front walk of one segment ---------------------------

template <int C>
__global__ void __launch_bounds__(kPix)
stream_blend_bwd_kernel(const float* __restrict__ stream, int ncols,
                        const int* __restrict__ starts,
                        const int* __restrict__ order, int n_order,
                        int grid_x, int chunk, int seg_len, bool vec,
                        const int* __restrict__ plan,
                        const float* __restrict__ dl_dout,
                        const int* __restrict__ n_contrib,
                        const float* __restrict__ scratch,
                        float* __restrict__ grads) {
  GPCR_DIAG_SPAN;
  constexpr int kTerms = 6 + C;
  constexpr int kN = kTerms <= 16 ? 16 : 32;
  extern __shared__ float4 smem4[];
  float* const base = reinterpret_cast<float*>(smem4);  // 2 x chunk rows
  float* const part = base + (size_t)2 * chunk * ncols;  // chunk x 8 x kTerms
  unsigned char* const mask =
      reinterpret_cast<unsigned char*>(part + (size_t)chunk * kWarps * kTerms);

  const Segment sg = find_segment(plan, n_order, seg_len);
  if (sg.g < 0) return;
  const int tile = order[sg.g];
  const int s = starts[tile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const PixelState ps = pixel_state(tile, grid_x, n_contrib);
  float dL[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dL[c] = dl_dout[ps.pix * C + c];
  const float* seg = scratch + (size_t)blockIdx.x * 2 * kPix;
  float T_after = seg[ps.p];
  float B = seg[kPix + ps.p];

  // the segment's chunks, last first
  const int nch = (sg.k1 - sg.k0 + chunk - 1) / chunk;
  const int last0 = sg.k0 + (nch - 1) * chunk;
  gpcr::stage(base, stream + (size_t)(s + last0) * ncols,
              (sg.k1 - last0) * ncols, vec);
  for (int i = 0; i < nch; ++i) {
    const int off0 = last0 - i * chunk;
    const int n = min(chunk, sg.k1 - off0);
    if (i + 1 < nch) {
      gpcr::stage(base + (size_t)((i + 1) & 1) * chunk * ncols,
                  stream + (size_t)(s + off0 - chunk) * ncols, chunk * ncols,
                  vec);
    } else {
      gpcr::cp_async_commit();  // an empty group keeps the wait uniform
    }
    gpcr::cp_async_wait_all_but_newest();
    __syncthreads();  // this chunk's rows are in; the last chunk's sums read
    const float* rows = base + (size_t)(i & 1) * chunk * ncols;
    chunk_masks(mask, rows, n, ncols, ps.x0, ps.y0);
    for (int k = threadIdx.x; k < n * kWarps * kTerms; k += kPix)
      part[k] = 0.0f;
    __syncthreads();

    const int n_warp = min(n, ps.warp_nc - off0);
    for (int jb = (n_warp - 1) & ~31; jb >= 0; jb -= 32) {
      unsigned bits = visit_bits(mask, jb, n_warp);
      while (bits) {
        const int hi = 31 - __clz(bits);
        bits &= ~(1u << hi);
        const int j = jb + hi;
        const float* r = rows + j * ncols;
        const Alpha al = alpha_at(r, ps.px, ps.py, off0 + j < ps.nc);
        if (__ballot_sync(0xffffffffu, al.live) == 0u) continue;
        float v[kN];
#pragma unroll
        for (int k = 0; k < kN; ++k) v[k] = 0.0f;
        if (al.live) {
          const float a = al.a;
          const float r_om = 1.0f / (1.0f - a);  // 1 - a >= 0.01
          const float T_excl = T_after * r_om;
          const float G = feat_dot<C>(r, dL);
          const float w = a * T_excl;
          const float dL_da = T_excl * G - B * r_om;
          if (al.raw < 0.99f) {
            const float dpow = dL_da * a;
            const float dx = al.dx, dy = al.dy;
            v[0] = -dpow * (r[2] * dx + r[3] * dy);
            v[1] = -dpow * (r[4] * dy + r[3] * dx);
            v[2] = -0.5f * dpow * dx * dx;
            v[3] = -dpow * dx * dy;
            v[4] = -0.5f * dpow * dy * dy;
            v[5] = dL_da * al.gauss;
          }
#pragma unroll
          for (int c = 0; c < C; ++c) v[6 + c] = w * dL[c];
          B += w * G;
          T_after = T_excl;
        }
        const float x = warp_reduce_scatter<kN>(v, lane);
        if (lane < kTerms) part[((size_t)j * kWarps + warp) * kTerms + lane] = x;
      }
    }
    __syncthreads();

    // add the warps' partials and write the chunk's gradient rows
    float* out = grads + (size_t)(s + off0) * ncols;
    for (int e = threadIdx.x; e < n * ncols; e += kPix) {
      const int j = e / ncols;
      const int col = e - j * ncols;
      int k = -1;
      if (col < 6) k = col;
      else if (col >= 8 && col < 8 + C) k = col - 2;
      float sum = 0.0f;
      if (k >= 0) {
        const float* q = part + (size_t)j * kWarps * kTerms + k;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += q[w * kTerms];
      }
      out[e] = sum;
    }
  }
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
                   const int* order, int n_order, int grid_x, int chunk,
                   const float* dl_dout, const int* n_contrib,
                   const float* dt_tot, const float* t_final, float* grads,
                   const int* plan, int n_seg_bound, float* scratch,
                   cudaStream_t st) {
  const int seg_len = segment_length(chunk);
  const bool vec = gpcr::rows_vectorizable(stream, ncols);
  const size_t rows = (size_t)2 * chunk * ncols * sizeof(float);
  const size_t part = (size_t)chunk * kWarps * (6 + C) * sizeof(float);
  cudaError_t err = allow_smem(seg_summary_kernel<C>, rows + chunk);
  if (err != cudaSuccess) return err;
  err = allow_smem(stream_blend_bwd_kernel<C>, rows + part + chunk);
  if (err != cudaSuccess) return err;
  seg_summary_kernel<C><<<n_seg_bound, kPix, rows + chunk, st>>>(
      stream, ncols, starts, order, n_order, grid_x, chunk, seg_len, vec,
      plan, dl_dout, n_contrib, scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  seg_scan_kernel<<<n_order, kPix, 0, st>>>(order, plan, dt_tot, t_final,
                                            scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  stream_blend_bwd_kernel<C><<<n_seg_bound, kPix, rows + part + chunk, st>>>(
      stream, ncols, starts, order, n_order, grid_x, chunk, seg_len, vec,
      plan, dl_dout, n_contrib, scratch, grads);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Entries per segment for a chunk size; the wrapper lays out plan and
// scratch with it.
int gpcr_bwd_segment_length(int chunk) {
  return chunk > 0 ? segment_length(chunk) : 0;
}

// plan (2, n_order) i32: row 0 the inclusive prefix sum over order of
// ceil(lim / L), row 1 each tile's lim = min(range, max n_contrib);
// n_seg_bound >= plan[0][n_order - 1] CTAs are launched for each per-segment
// pass; scratch holds n_seg_bound * 2 * 256 floats. Returns a cudaError_t
// value: 0 when the three kernels were launched.
int gpcr_stream_blend_bwd(const float* stream, int ncols, const int* starts,
                          const int* order, int n_order, int grid_x,
                          int channels, int chunk, const float* dl_dout,
                          const int* n_contrib, const float* dt_tot,
                          const float* t_final, float* grads, const int* plan,
                          int n_seg_bound, float* scratch, void* cuda_stream) {
  if (n_order <= 0 || n_seg_bound <= 0) return (int)cudaSuccess;
  if (chunk <= 0 || ncols < 8 + channels) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)cuda_stream;
#define GPCR_CASE(NC)                                                        \
  case NC:                                                                   \
    return (int)launch<NC>(stream, ncols, starts, order, n_order, grid_x,    \
                           chunk, dl_dout, n_contrib, dt_tot, t_final, grads, \
                           plan, n_seg_bound, scratch, st);
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

GPCR_DIAG_SETTER(gpcr_stream_blend_bwd_set_diag)
