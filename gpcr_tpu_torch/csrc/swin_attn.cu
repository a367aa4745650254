// Swin3D's window attention over sparse voxels with its contextual relative
// signal encoding (cRSE, "XYZ_RGB"), float32 (ops/swin_attn.py): for each
// window of a level's partition, each head h and each query i of the window,
// over every key j of the window (1 to w^3 of them, none dropped):
//   delta_a = clamp(floor((s_ia - s_ja) Q_a) + L_a / 2, 0, L_a - 1)
//   e_ij    = q'_i . k_j + sum_a (q'_i . Tq_a[delta_a] + k_j . Tk_a[delta_a])
//   o_i     = sum_j softmax_j(e_ij) (v_j + sum_a Tv_a[delta_a])
// with q' = d^-0.5 q and six axes a (x, y, z, r, g, b) whose bins lie one
// after another along the tables' first axis (rows = 3 lp + 3 lc). The bins
// are computed here from the points' signals: no per-pair tensor exists
// outside this kernel.
//
// Replaces no TPU kernel: the JAX package has no point transformer. The
// plain version (ops/swin_attn.py::window_attention_plain) computes the same
// form with torch ops over blocks of windows; the benchmark's reference
// (cellbench/reference/swin3d.py) gathers the table rows of every pair.
//
// Layout: qkv (n, 3C), C = H d, channel (s H + h) d + t; sig (n, 6); perm
// (n,) the points by window; chunks (c, 4): start in perm, occupancy m,
// first query, 0; tables (rows, H, d); out (n, C).
//
// Design. One CTA of 256 threads per (chunk of at most 32 queries of one
// window, head). The table dots are taken once per point and bin, not per
// pair:
//  A. sA[i][b] = q'_i . Tq[b] for the chunk's queries and every bin (lane =
//     query, warps split the bins; each table row is one broadcast read);
//  per tile of 32 keys (lane = key):
//  B. sB[b][j] = k_j . Tk[b] for every bin (warps split the bins);
//  C. each warp takes four queries in turn: per pair the six bins, the
//     logit q'.k + 6 A + 6 B, an online softmax over the tiles (warp max and
//     sum), the per-lane partial sum of p v (registers), and p added to the
//     query's histogram of bins sH[i][b] (shared atomics);
//  D. o_i = (sum over lanes of the partials + sum_b sH[i][b] Tv[b]) / l_i.
// Every per-pair read is conflict-free: sA's row is the query's own and a
// window's bins of one axis span at most 32 consecutive rows (w Q + 1 for a
// position, L = 32 for a colour), sB is stored bin-major so a lane reads its
// own bank, and sA / sH rows have an odd stride. What bounds it on Hopper:
// shared-memory instructions and the table dots (per point and head about
// 3 rows d FMAs for A, B and D, against 4 d + 19 per pair), float32 on the
// CUDA cores (the renderer pins TF32 off); the bytes (q, k, v and out once
// per point) are small beside them.
//
// Numerics: float32 sums in another order than the plain version and the
// reference; the histogram's shared atomics add in an order that may change
// from run to run; expf for exp. The bins are computed exactly as the plain
// version and the reference compute them (float32 difference times a power
// of two, floor).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;                 // queries per CTA
constexpr int kPerWarp = kChunk / kWarps;  // queries per warp in phase C
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* qkv;
  const float* sig;
  const int* perm;
  const int4* chunks;
  int heads;
  const float* tq;
  const float* tk;
  const float* tv;
  int lp, lc;
  float qp, qc, scale;
  float* out;
};

template <int D>
__device__ __forceinline__ void load_row(float (&dst)[D], const float* src) {
#pragma unroll
  for (int e = 0; e < D / 4; ++e) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(src) + e);
    dst[4 * e] = x.x;
    dst[4 * e + 1] = x.y;
    dst[4 * e + 2] = x.z;
    dst[4 * e + 3] = x.w;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

size_t smem_bytes(int rows, int d) {
  return sizeof(float) * ((size_t)2 * kChunk * (rows + 1) + (size_t)rows * 32
                          + 2 * kChunk * d + kChunk * 6);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) swin_attn_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int rows = 3 * a.lp + 3 * a.lc;
  const int rp = rows + 1;          // odd stride: a row's lanes on all banks
  float* sA = smem;                 // [kChunk][rp]: q'_i . Tq[b]
  float* sH = sA + kChunk * rp;     // [kChunk][rp]: sum_j p_ij [delta = b]
  float* sB = sH + kChunk * rp;     // [rows][32]: k_j . Tk[b], bin-major
  float* sQ = sB + rows * 32;       // [kChunk][D]: q'
  float* sO = sQ + kChunk * D;      // [kChunk][D]: sum_b sH Tv[b]
  float* sS = sO + kChunk * D;      // [kChunk][6]: the queries' signals

  const int4 ch = a.chunks[blockIdx.x];
  const int start = ch.x, m = ch.y, q0 = ch.z;
  const int h = blockIdx.y;
  const int C = a.heads * D;
  const size_t c3 = 3 * (size_t)C;
  const int nq = min(kChunk, m - q0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int e = tid; e < nq * D; e += kThreads) {
    const int i = e / D, t = e % D;
    const int p = a.perm[start + q0 + i];
    sQ[e] = __ldg(a.qkv + p * c3 + h * D + t) * a.scale;
  }
  for (int e = tid; e < nq * 6; e += kThreads)
    sS[e] = __ldg(a.sig + (size_t)a.perm[start + q0 + e / 6] * 6 + e % 6);
  for (int e = tid; e < kChunk * rp; e += kThreads) sH[e] = 0.f;
  __syncthreads();

  // ---- A: sA[i][b] = q'_i . Tq[b] ------------------------------------------
  if (lane < nq) {
    float qv[D];
#pragma unroll
    for (int t = 0; t < D; ++t) qv[t] = sQ[lane * D + t];
    for (int b = warp; b < rows; b += kWarps) {
      float tr[D];
      load_row<D>(tr, a.tq + ((size_t)b * a.heads + h) * D);
      float x = 0.f;
#pragma unroll
      for (int t = 0; t < D; ++t) x = __fmaf_rn(qv[t], tr[t], x);
      sA[lane * rp + b] = x;
    }
  }

  float mrun[kPerWarp], lrun[kPerWarp], acc[kPerWarp][D];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    mrun[r] = -INFINITY;
    lrun[r] = 0.f;
#pragma unroll
    for (int t = 0; t < D; ++t) acc[r][t] = 0.f;
  }

  for (int k0 = 0; k0 < m; k0 += 32) {
    const int j = k0 + lane;
    const bool valid = j < m;
    float kv[D], vv[D], sj[6];
    if (valid) {
      const int p = a.perm[start + j];
      const float* row = a.qkv + p * c3 + h * D;
      load_row<D>(kv, row + C);
      load_row<D>(vv, row + 2 * C);
#pragma unroll
      for (int t = 0; t < 6; ++t) sj[t] = __ldg(a.sig + (size_t)p * 6 + t);
    } else {
#pragma unroll
      for (int t = 0; t < D; ++t) kv[t] = vv[t] = 0.f;
#pragma unroll
      for (int t = 0; t < 6; ++t) sj[t] = 0.f;
    }
    __syncthreads();  // the last tile's sB is read no more (and sA is ready)

    // ---- B: sB[b][j] = k_j . Tk[b] -------------------------------------------
    for (int b = warp; b < rows; b += kWarps) {
      float tr[D];
      load_row<D>(tr, a.tk + ((size_t)b * a.heads + h) * D);
      float x = 0.f;
#pragma unroll
      for (int t = 0; t < D; ++t) x = __fmaf_rn(kv[t], tr[t], x);
      sB[b * 32 + lane] = x;
    }
    __syncthreads();

    // ---- C: logits, online softmax, p v and the histograms -----------------
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) {
      const int i = warp * kPerWarp + r;
      if (i < nq) {  // warp-uniform
        float e = -INFINITY;
        int idx[6];
        if (valid) {
          float x = 0.f;
#pragma unroll
          for (int t = 0; t < D; ++t) x = __fmaf_rn(sQ[i * D + t], kv[t], x);
#pragma unroll
          for (int ax = 0; ax < 6; ++ax) {
            const bool pos = ax < 3;
            const int len = pos ? a.lp : a.lc;
            const int off = pos ? ax * a.lp : 3 * a.lp + (ax - 3) * a.lc;
            int b = (int)floorf((sS[i * 6 + ax] - sj[ax]) * (pos ? a.qp : a.qc))
                    + len / 2;
            b = min(max(b, 0), len - 1);
            idx[ax] = off + b;
            x += sA[i * rp + idx[ax]] + sB[idx[ax] * 32 + lane];
          }
          e = x;
        }
        const float newm = fmaxf(mrun[r], warp_max(e));
        if (mrun[r] != newm && mrun[r] != -INFINITY) {  // warp-uniform
          const float alpha = expf(mrun[r] - newm);
          lrun[r] *= alpha;
#pragma unroll
          for (int t = 0; t < D; ++t) acc[r][t] *= alpha;
          for (int b = lane; b < rows; b += 32) sH[i * rp + b] *= alpha;
          __syncwarp();
        }
        mrun[r] = newm;
        const float p = valid ? expf(e - newm) : 0.f;
        lrun[r] += warp_sum(p);
#pragma unroll
        for (int t = 0; t < D; ++t) acc[r][t] = __fmaf_rn(p, vv[t], acc[r][t]);
        if (valid) {
#pragma unroll
          for (int ax = 0; ax < 6; ++ax) atomicAdd(sH + i * rp + idx[ax], p);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();  // every histogram is complete

  // ---- D: sO[i][t] = sum_b sH[i][b] Tv[b][t]; out = (sum p v + sO) / l -----
  if (lane < nq) {
    for (int t = warp; t < D; t += kWarps) {
      const float* col = a.tv + (size_t)h * D + t;
      const size_t step = (size_t)a.heads * D;
      float x = 0.f;
      for (int b = 0; b < rows; ++b)
        x = __fmaf_rn(sH[lane * rp + b], __ldg(col + b * step), x);
      sO[lane * D + t] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    const int i = warp * kPerWarp + r;
    if (i < nq) {
      float res[D];
#pragma unroll
      for (int t = 0; t < D; ++t) res[t] = warp_sum(acc[r][t]);
      if (lane == 0) {
        const int p = a.perm[start + q0 + i];
        float4* dst = reinterpret_cast<float4*>(a.out + (size_t)p * C + h * D);
#pragma unroll
        for (int e = 0; e < D / 4; ++e) {
          const float* o = sO + i * D + 4 * e;
          dst[e] = make_float4((res[4 * e] + o[0]) / lrun[r],
                               (res[4 * e + 1] + o[1]) / lrun[r],
                               (res[4 * e + 2] + o[2]) / lrun[r],
                               (res[4 * e + 3] + o[3]) / lrun[r]);
        }
      }
    }
  }
}

template <int D>
cudaError_t launch(const Args& a, int n_chunks, cudaStream_t st) {
  const size_t bytes = smem_bytes(3 * a.lp + 3 * a.lc, D);
  const cudaError_t e = cudaFuncSetAttribute(
      swin_attn_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return e;
  swin_attn_kernel<D><<<dim3(n_chunks, a.heads), kThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t value: 0 on a successful launch. d in 8, 16; lp and
// lc even; 3 lp + 3 lc rows at most 552 (the shared memory of a CTA);
// heads at most 65535.
int gpcr_swin_attn(const float* qkv, const float* sig, const int* perm,
                   const int* chunks, int n_chunks, int heads, int d,
                   const float* tq, const float* tk, const float* tv, int lp,
                   int lc, float qp, float qc, float scale, float* out,
                   void* cuda_stream) {
  if (n_chunks <= 0) return (int)cudaSuccess;
  if (heads <= 0 || heads > 65535 || lp <= 0 || lc <= 0 || lp % 2 || lc % 2
      || 3 * (lp + lc) > 552)
    return (int)cudaErrorInvalidValue;
  const void* aligned[] = {qkv, tq, tk, tv, out, chunks};
  for (const void* ptr : aligned)
    if ((size_t)ptr % 16) return (int)cudaErrorMisalignedAddress;
  Args a{qkv, sig, perm, reinterpret_cast<const int4*>(chunks), heads, tq, tk,
         tv, lp, lc, qp, qc, scale, out};
  cudaStream_t st = (cudaStream_t)cuda_stream;
  switch (d) {
    case 8: return (int)launch<8>(a, n_chunks, st);
    case 16: return (int)launch<16>(a, n_chunks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* gpcr_swin_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
