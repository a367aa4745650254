// Grouped vector attention of Point Transformer V2, float32, in its folded
// form (ops/gva.py): for each point i, its K nearest neighbours j and each
// group g of 8 channels,
//   h_ij   = ReLU(W1 delta_ij + b1)                       (C, BN folded)
//   u_ijg  = mk_j[g] - mq_i[g] + c0[g] + sum_c P[g][c] h_ij[c]
//   w_ijg  = bg2[g] + sum_g' Wg2[g][g'] ReLU(u_ijg')
//   a_ijg  = softmax over j of w_ijg
//   out_i[8g + t] = b2[8g + t] + sum_j a_ijg v_j[8g + t]
//                 + sum_c W2[8g + t][c] sum_j a_ijg h_ij[c]
// with mq = M q and mk = M k (G per point, cuBLAS before the launch) and P
// = M W2. Neither pe_ij = W2 h_ij + b2 (C per pair) nor any other (n, K, C)
// tensor is formed: the softmax needs every channel of every neighbour
// before any output channel, and the fold makes that a G-wide logit per
// pair; W2 is applied once per point to the per-group sums of h.
//
// Replaces no TPU kernel: the JAX package has no point transformer. The
// plain version (ops/gva.py::gva_plain) computes the same folded function
// with torch ops over blocks of points; the benchmark's reference
// (cellbench/reference/ptv2.py) computes the published unfolded one.
//
// Layout: mq, mk (n, G); v (n, C); nbr (n, S) int32 and delta (n, S, 3),
// of which the first K columns are used; w1 (C, 3), b1 (C), pt = P^T
// (C, G), c0 (G), wg2 (G, G), bg2 (G), w2t = W2^T (C, C), b2 (C); out
// (n, C). C = 8 G.
//
// Design. One CTA of 256 threads per tile of T points (T K pairs), in four
// phases over one shared table of the tile's pairs, pair p = j T + i:
//  A. logits: each thread takes PP pairs and GA groups; per channel c it
//     forms its pairs' h (3 FMAs and a max) and adds P[g][c] h for its
//     groups (P read as a warp-wide broadcast through L1);
//  B. the second Linear of the weight encoding, one pair per thread, in
//     place; C. the softmax over the K neighbours, one (point, group) per
//     thread;
//  D. output: each thread owns GO groups (8 GO outputs) of one point; the
//     value sum reads the neighbours' v rows; then per chunk of CC
//     channels the tile's h are staged in shared memory with the chunk of
//     W2^T, and each thread forms sum_j a h for its groups (K FMAs) and
//     adds W2 times it (8 FMAs a group).
// What bounds it on Hopper: float32 on the CUDA cores (the renderer pins
// TF32 off): the operations counted per pair are 8C + 4GC + 2G^2 + G and
// per point 2C^2 + 4GC; the bytes (q, k, v, out, the indices) are small
// beside them at every width but C = 48, where the two are of one size.
//
// Numerics: float32 sums in another order than the plain version (and the
// reference's unfolded form); expf for exp; the two differ by float32
// rounding, nothing else.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

struct Args {
  const float* mq;
  const float* mk;
  const float* v;
  const int* nbr;
  const float* delta;
  int stride;  // columns of nbr and delta
  int n;
  const float* w1;
  const float* b1;
  const float* pt;
  const float* c0;
  const float* wg2;
  const float* bg2;
  const float* w2t;
  const float* b2;
  float* out;
};

constexpr int pick_cc(int np, int c, int gp) {
  int cc = 16;
  while (cc > 1 && (cc * (np + c) > np * gp || c % cc)) cc /= 2;
  return cc;
}

template <int G, int K>
struct Shape {
  static constexpr int C = 8 * G;
  static constexpr int GO = (G % 4 == 0 && G >= 64) ? 4 : 3;  // phase D
  static constexpr int TPP = G / GO;         // threads per point in D
  static constexpr int T = kThreads / TPP;   // points per CTA
  static constexpr int NP = T * K;           // pairs per CTA
  static constexpr int GA = G > 32 ? G / 2 : G;  // groups per thread in A
  static constexpr int LANES = kThreads * GA / G;  // threads per slice
  static constexpr int PP = NP / LANES;      // pairs per thread in A
  static constexpr int GP = G + 1;           // padded row of the table
  static constexpr int CC = pick_cc(NP, C, GP);  // channels per chunk
  static constexpr int SMEM = (NP * GP + 4 * NP) * 4;
  static_assert(G % GO == 0 && kThreads % TPP == 0, "output split");
  static_assert(G % GA == 0 && NP % LANES == 0, "logit split");
  static_assert(C % CC == 0 && CC * (NP + C) <= NP * GP, "chunks");
  static_assert(T % 16 == 0, "a warp spans at most two groups in D");
};

template <int N>
__device__ __forceinline__ void load_row(float (&dst)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int e = 0; e < N / 4; ++e) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(src) + e);
      dst[4 * e] = x.x;
      dst[4 * e + 1] = x.y;
      dst[4 * e + 2] = x.z;
      dst[4 * e + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) dst[e] = __ldg(src + e);
  }
}

template <int G, int K>
__global__ void __launch_bounds__(kThreads, 2) gva_kernel(Args a) {
  using S = Shape<G, K>;
  constexpr int C = S::C, T = S::T, NP = S::NP, GP = S::GP;
  constexpr int GA = S::GA, LANES = S::LANES, PP = S::PP;
  constexpr int GO = S::GO, CC = S::CC;
  extern __shared__ __align__(16) float smem[];
  float* sU = smem;                    // [NP][GP]: logits, weights, softmax
  float* sD = smem + NP * GP;          // [3][NP]: relative positions
  int* sN = reinterpret_cast<int*>(sD + 3 * NP);  // [NP]: neighbour rows
  float* hcs = smem;                   // [CC][NP] in phase D (reuses sU)
  float* w2s = smem + CC * NP;         // [CC][C]

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * T;

  for (int p = tid; p < NP; p += kThreads) {
    const int j = p / T, i = p % T;
    const int pt = i0 + i;
    int row = 0;
    float dx = 0.f, dy = 0.f, dz = 0.f;
    if (pt < a.n) {
      const size_t at = (size_t)pt * a.stride + j;
      row = a.nbr[at];
      dx = a.delta[3 * at];
      dy = a.delta[3 * at + 1];
      dz = a.delta[3 * at + 2];
    }
    sN[p] = row;
    sD[p] = dx;
    sD[NP + p] = dy;
    sD[2 * NP + p] = dz;
  }
  __syncthreads();

  // ---- A: logits u = mk_j - mq_i + c0 + P h ------------------------------
  {
    const int g0 = (tid / LANES) * GA;  // warp-uniform slice of groups
    const int lane = tid % LANES;
    float u[PP][GA];
    float dx[PP], dy[PP], dz[PP];
    float cb[GA];
    load_row<GA>(cb, a.c0 + g0);
#pragma unroll
    for (int q = 0; q < PP; ++q) {
      const int p = lane + q * LANES;
      const int pt = min(i0 + p % T, a.n - 1);
      dx[q] = sD[p];
      dy[q] = sD[NP + p];
      dz[q] = sD[2 * NP + p];
      float mk[GA], mq[GA];
      load_row<GA>(mk, a.mk + (size_t)sN[p] * G + g0);
      load_row<GA>(mq, a.mq + (size_t)pt * G + g0);
#pragma unroll
      for (int g = 0; g < GA; ++g) u[q][g] = (mk[g] - mq[g]) + cb[g];
    }
    for (int c = 0; c < C; ++c) {
      const float wx = __ldg(a.w1 + 3 * c), wy = __ldg(a.w1 + 3 * c + 1);
      const float wz = __ldg(a.w1 + 3 * c + 2), bb = __ldg(a.b1 + c);
      float h[PP];
#pragma unroll
      for (int q = 0; q < PP; ++q)
        h[q] = fmaxf(((bb + wx * dx[q]) + wy * dy[q]) + wz * dz[q], 0.f);
      float pr[GA];
      load_row<GA>(pr, a.pt + (size_t)c * G + g0);
#pragma unroll
      for (int g = 0; g < GA; ++g) {
#pragma unroll
        for (int q = 0; q < PP; ++q) u[q][g] = __fmaf_rn(pr[g], h[q], u[q][g]);
      }
    }
#pragma unroll
    for (int q = 0; q < PP; ++q) {
      const int p = lane + q * LANES;
#pragma unroll
      for (int g = 0; g < GA; ++g) sU[p * GP + g0 + g] = fmaxf(u[q][g], 0.f);
    }
  }
  __syncthreads();

  // ---- B: w = Wg2 ReLU(u) + bg2, one pair per thread, in place ----------
  for (int p = tid; p < NP; p += kThreads) {
    float r[G];
#pragma unroll
    for (int g = 0; g < G; ++g) r[g] = sU[p * GP + g];
    for (int o = 0; o < G; ++o) {
      constexpr int W = G % 4 == 0 ? 4 : 2;  // a row read W floats at a time
      float acc = __ldg(a.bg2 + o);
#pragma unroll
      for (int g = 0; g < G; g += W) {
        float wr[W];
        load_row<W>(wr, a.wg2 + o * G + g);
#pragma unroll
        for (int e = 0; e < W; ++e) acc = __fmaf_rn(wr[e], r[g + e], acc);
      }
      sU[p * GP + o] = acc;
    }
  }
  __syncthreads();

  // ---- C: softmax over the K neighbours per (point, group) --------------
  for (int e = tid; e < T * G; e += kThreads) {
    const int i = e / G, g = e % G;
    float w[K];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      w[j] = sU[(j * T + i) * GP + g];
      mx = fmaxf(mx, w[j]);
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      w[j] = expf(w[j] - mx);
      sum += w[j];
    }
#pragma unroll
    for (int j = 0; j < K; ++j) sU[(j * T + i) * GP + g] = w[j] / sum;
  }
  __syncthreads();

  // ---- D: out = b2 + sum_j a v_j + W2 sum_j a h_j, GO groups a thread ----
  const int i = tid % T;
  const int gbase = (tid / T) * GO;
  const int pt = i0 + i;
  float aw[GO][K];
  float y[GO][8];
#pragma unroll
  for (int o = 0; o < GO; ++o) {
#pragma unroll
    for (int j = 0; j < K; ++j) aw[o][j] = sU[(j * T + i) * GP + gbase + o];
    load_row<8>(y[o], a.b2 + (gbase + o) * 8);
  }
  if (pt < a.n) {
    for (int j = 0; j < K; ++j) {
      const float* vr = a.v + (size_t)sN[j * T + i] * C;
#pragma unroll
      for (int o = 0; o < GO; ++o) {
        float vv[8];
        load_row<8>(vv, vr + (gbase + o) * 8);
#pragma unroll
        for (int t = 0; t < 8; ++t) y[o][t] = __fmaf_rn(aw[o][j], vv[t], y[o][t]);
      }
    }
  }
  __syncthreads();  // the pair table is free: h and W2 chunks reuse it

  for (int c0 = 0; c0 < C; c0 += CC) {
    for (int e = tid; e < CC * NP; e += kThreads) {
      const int c = c0 + e / NP, p = e % NP;
      const float wx = __ldg(a.w1 + 3 * c), wy = __ldg(a.w1 + 3 * c + 1);
      const float wz = __ldg(a.w1 + 3 * c + 2);
      hcs[e] = fmaxf(((__ldg(a.b1 + c) + wx * sD[p]) + wy * sD[NP + p])
                         + wz * sD[2 * NP + p], 0.f);
    }
    for (int e = tid; e < CC * C; e += kThreads)
      w2s[e] = __ldg(a.w2t + (size_t)c0 * C + e);
    __syncthreads();
#pragma unroll 4
    for (int cc = 0; cc < CC; ++cc) {
      float hs[GO];
#pragma unroll
      for (int o = 0; o < GO; ++o) hs[o] = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float hv = hcs[cc * NP + j * T + i];
#pragma unroll
        for (int o = 0; o < GO; ++o) hs[o] = __fmaf_rn(aw[o][j], hv, hs[o]);
      }
#pragma unroll
      for (int o = 0; o < GO; ++o) {
        const float4* wr =
            reinterpret_cast<const float4*>(w2s + cc * C + (gbase + o) * 8);
        const float4 w0 = wr[0], w1v = wr[1];
        y[o][0] = __fmaf_rn(w0.x, hs[o], y[o][0]);
        y[o][1] = __fmaf_rn(w0.y, hs[o], y[o][1]);
        y[o][2] = __fmaf_rn(w0.z, hs[o], y[o][2]);
        y[o][3] = __fmaf_rn(w0.w, hs[o], y[o][3]);
        y[o][4] = __fmaf_rn(w1v.x, hs[o], y[o][4]);
        y[o][5] = __fmaf_rn(w1v.y, hs[o], y[o][5]);
        y[o][6] = __fmaf_rn(w1v.z, hs[o], y[o][6]);
        y[o][7] = __fmaf_rn(w1v.w, hs[o], y[o][7]);
      }
    }
    __syncthreads();
  }

  if (pt < a.n) {
#pragma unroll
    for (int o = 0; o < GO; ++o) {
      float4* dst = reinterpret_cast<float4*>(a.out + (size_t)pt * C +
                                              (gbase + o) * 8);
      dst[0] = make_float4(y[o][0], y[o][1], y[o][2], y[o][3]);
      dst[1] = make_float4(y[o][4], y[o][5], y[o][6], y[o][7]);
    }
  }
}

template <int G, int K>
cudaError_t launch(const Args& a, cudaStream_t st) {
  using S = Shape<G, K>;
  const cudaError_t e = cudaFuncSetAttribute(
      gva_kernel<G, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (e != cudaSuccess) return e;
  const int blocks = (a.n + S::T - 1) / S::T;
  gva_kernel<G, K><<<blocks, kThreads, S::SMEM, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t value: 0 on a successful launch. groups in 6, 12,
// 24, 48, 64 (C = 8 groups); k 16, or 8 at 6 groups; stride >= k.
int gpcr_gva(const float* mq, const float* mk, const float* v, const int* nbr,
             const float* delta, int stride, int n, int groups, int k,
             const float* w1, const float* b1, const float* pt, const float* c0,
             const float* wg2, const float* bg2, const float* w2t,
             const float* b2, float* out, void* cuda_stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (stride < k) return (int)cudaErrorInvalidValue;
  const float* aligned[] = {mq, mk, v, pt, wg2, w2t, b2, out, c0};
  for (const float* ptr : aligned)
    if ((size_t)ptr % 16) return (int)cudaErrorMisalignedAddress;
  Args a{mq, mk, v, nbr, delta, stride, n, w1, b1, pt, c0, wg2, bg2, w2t, b2,
         out};
  cudaStream_t st = (cudaStream_t)cuda_stream;
  if (k == 8 && groups == 6) return (int)launch<6, 8>(a, st);
  if (k != 16) return (int)cudaErrorInvalidValue;
  switch (groups) {
    case 6: return (int)launch<6, 16>(a, st);
    case 12: return (int)launch<12, 16>(a, st);
    case 24: return (int)launch<24, 16>(a, st);
    case 48: return (int)launch<48, 16>(a, st);
    case 64: return (int)launch<64, 16>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* gpcr_gva_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
