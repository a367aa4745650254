// Serialized patch attention of Point Transformer V3, float32:
//   out[order[pos], h d + j] = sum_key softmax_key(q . k d^-0.5) v[key, j]
// over the K = min(patch size, N) consecutive serialized positions of each
// patch and each head h, with the 1,024^2 scores never written to memory.
//
// Replaces no TPU kernel: the JAX package has no attention. The port's plain
// version (ops/patch_attn.py::patch_attention_plain) gathers every patch's
// rows, writes its (heads, K, K) scores, and runs softmax and two products
// through cuBLAS; at the learned cell's cloud that is ~24 G scores per pass.
//
// Layout (ops/patch_attn.py): qkv (N, 3 C) in the voxel order, channel
// (s H + h) d + j for component s of q, k, v; order (N,) i32, the voxel row
// at each serialized position; out (N, C), channel h d + j, in the voxel
// order. Patch p starts at min(p K, N - K): the last patch is the last K
// points, and of it only the positions >= p K (the ones no earlier patch
// holds) are written, Pointcept's get_padding_and_inverse.
//
// Design. One CTA of 128 threads per (patch, head, block of 256 queries);
// each thread keeps two queries (q scaled by d^-0.5 log2 e, the running max,
// sum and the d-wide output) in registers, so every key read from shared
// memory (a warp-wide broadcast) feeds two queries. Keys and values stream
// through a 2-stage cp.async ring of 64 keys (gathered by order[] straight
// from qkv: no serialized copy is made). Per step of 16 keys a thread forms
// its 2 x 16 scores, rescales its outputs once by exp2(m_old - m_new), then
// adds p v for each key (FlashAttention's online softmax). Only the last
// tile of a patch whose K is not a multiple of 64 takes the masked step.
//
// What bounds it on Hopper: float32 on the CUDA cores (the renderer pins
// TF32 off): per (query, key) pair 2 d FMAs, one exponential (MUFU) and a
// few adds and compares; the operations counted are (4 d + 1) per pair,
// against 67 TFLOP/s. Bytes are small beside that (q, k, v read, out
// written; k and v re-read from L2 by each query block).
//
// Numerics. Scores and outputs accumulate in float32 in ascending lane
// and key order with one rounding per FMA (-fmad=false stops contraction,
// __fmaf_rn is still one FFMA); exp2f of log2-scaled scores stands for exp,
// and the output is divided by the sum once at the end. The plain version
// (softmax, then two cuBLAS products) rounds in another order: the two
// differ by float32 rounding, nothing else.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kQ = 2;                // queries per thread
constexpr int kBQ = kThreads * kQ;   // queries per CTA
constexpr int kBK = 64;              // keys per stage of the ring
constexpr int kSub = 16;             // keys per online-softmax step

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Args {
  const float* qkv;
  int row;  // floats per qkv row: 3 C
  const int* order;
  int n;
  int k;
  int heads;
  float qscale;  // d^-0.5 log2(e)
  float* out;    // (n, heads d)
  int qblocks;
};

template <int D>
struct Thread {
  float q[kQ][D];
  float o[kQ][D];
  float m[kQ];
  float l[kQ];
};

// One online-softmax step over keys j0 .. j0 + kSub - 1 of a tile; with
// MASK the keys at or past `valid` score -inf.
template <int D, bool MASK>
__device__ __forceinline__ void step(Thread<D>& t, const float* K,
                                     const float* V, int j0, int valid) {
  float s[kQ][kSub];
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const float4* kr = reinterpret_cast<const float4*>(K + (j0 + j) * D);
#pragma unroll
    for (int u = 0; u < kQ; ++u) s[u][j] = 0.f;
#pragma unroll
    for (int c4 = 0; c4 < D / 4; ++c4) {
      const float4 kv = kr[c4];
#pragma unroll
      for (int u = 0; u < kQ; ++u) {
        s[u][j] = __fmaf_rn(t.q[u][4 * c4 + 0], kv.x, s[u][j]);
        s[u][j] = __fmaf_rn(t.q[u][4 * c4 + 1], kv.y, s[u][j]);
        s[u][j] = __fmaf_rn(t.q[u][4 * c4 + 2], kv.z, s[u][j]);
        s[u][j] = __fmaf_rn(t.q[u][4 * c4 + 3], kv.w, s[u][j]);
      }
    }
    if (MASK && j0 + j >= valid) {
#pragma unroll
      for (int u = 0; u < kQ; ++u) s[u][j] = -INFINITY;
    }
  }
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    float mx = t.m[u];
#pragma unroll
    for (int j = 0; j < kSub; ++j) mx = fmaxf(mx, s[u][j]);
    const float corr = exp2f(t.m[u] - mx);  // 0 while m is -inf
    t.l[u] *= corr;
#pragma unroll
    for (int c = 0; c < D; ++c) t.o[u][c] *= corr;
    t.m[u] = mx;
  }
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    const float4* vr = reinterpret_cast<const float4*>(V + (j0 + j) * D);
    float p[kQ];
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      p[u] = exp2f(s[u][j] - t.m[u]);
      t.l[u] += p[u];
    }
#pragma unroll
    for (int c4 = 0; c4 < D / 4; ++c4) {
      const float4 vv = vr[c4];
#pragma unroll
      for (int u = 0; u < kQ; ++u) {
        t.o[u][4 * c4 + 0] = __fmaf_rn(p[u], vv.x, t.o[u][4 * c4 + 0]);
        t.o[u][4 * c4 + 1] = __fmaf_rn(p[u], vv.y, t.o[u][4 * c4 + 1]);
        t.o[u][4 * c4 + 2] = __fmaf_rn(p[u], vv.z, t.o[u][4 * c4 + 2]);
        t.o[u][4 * c4 + 3] = __fmaf_rn(p[u], vv.w, t.o[u][4 * c4 + 3]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 3) patch_attn_kernel(Args a) {
  __shared__ __align__(16) float Ks[2][kBK * D];
  __shared__ __align__(16) float Vs[2][kBK * D];
  constexpr int kChunks = D / 4;  // 16-byte copies per row slice

  const int tid = threadIdx.x;
  const int qb = blockIdx.x % a.qblocks;
  const int ph = blockIdx.x / a.qblocks;
  const int h = ph % a.heads;
  const int p = ph / a.heads;
  const int start = min(p * a.k, a.n - a.k);
  const int keep_from = p * a.k;  // earlier positions belong to patch p - 1
  const float* kbase = a.qkv + (a.heads + h) * D;
  const float* vbase = a.qkv + (2 * a.heads + h) * D;

  Thread<D> t;
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int i = qb * kBQ + u * kThreads + tid;
    if (i < a.k) {
      const int row = a.order[start + i];
      const float4* src = reinterpret_cast<const float4*>(
          a.qkv + (size_t)row * a.row + h * D);
#pragma unroll
      for (int c4 = 0; c4 < kChunks; ++c4) {
        const float4 v = src[c4];
        t.q[u][4 * c4 + 0] = v.x * a.qscale;
        t.q[u][4 * c4 + 1] = v.y * a.qscale;
        t.q[u][4 * c4 + 2] = v.z * a.qscale;
        t.q[u][4 * c4 + 3] = v.w * a.qscale;
      }
    } else {
#pragma unroll
      for (int c = 0; c < D; ++c) t.q[u][c] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < D; ++c) t.o[u][c] = 0.f;
    t.m[u] = -INFINITY;
    t.l[u] = 0.f;
  }

  auto load_tile = [&](int tile, int buf) {
    const int t0 = tile * kBK;
    for (int e = tid; e < kBK * 2 * kChunks; e += kThreads) {
      const int j = e / (2 * kChunks);
      const int which = (e / kChunks) & 1;  // 0: k, 1: v
      const int c4 = e % kChunks;
      const bool ok = t0 + j < a.k;
      const int row = ok ? a.order[start + t0 + j] : 0;
      const float* src = (which ? vbase : kbase) + (size_t)row * a.row + c4 * 4;
      float* dst = (which ? Vs[buf] : Ks[buf]) + j * D + c4 * 4;
      cp_async16(dst, src, ok ? 16 : 0);
    }
  };

  const int n_tiles = (a.k + kBK - 1) / kBK;
  load_tile(0, 0);
  cp_async_commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) load_tile(tile + 1, (tile + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this tile landed for every thread
    const float* K = Ks[tile & 1];
    const float* V = Vs[tile & 1];
    const int valid = min(kBK, a.k - tile * kBK);
    if (valid == kBK) {
      for (int j0 = 0; j0 < kBK; j0 += kSub) step<D, false>(t, K, V, j0, kBK);
    } else {
      for (int j0 = 0; j0 < valid; j0 += kSub) step<D, true>(t, K, V, j0, valid);
    }
    __syncthreads();  // the stage is free for the load two tiles on
  }

  const int C = a.heads * D;
#pragma unroll
  for (int u = 0; u < kQ; ++u) {
    const int i = qb * kBQ + u * kThreads + tid;
    if (i >= a.k || start + i < keep_from) continue;
    const int row = a.order[start + i];
    const float inv = 1.f / t.l[u];
    float4* dst = reinterpret_cast<float4*>(a.out + (size_t)row * C + h * D);
#pragma unroll
    for (int c4 = 0; c4 < kChunks; ++c4)
      dst[c4] = make_float4(t.o[u][4 * c4 + 0] * inv, t.o[u][4 * c4 + 1] * inv,
                            t.o[u][4 * c4 + 2] * inv, t.o[u][4 * c4 + 3] * inv);
  }
}

template <int D>
cudaError_t launch(const Args& a, int blocks, cudaStream_t st) {
  patch_attn_kernel<D><<<blocks, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t value: 0 on a successful launch. qkv (n, row) with
// row >= 3 heads head_dim; order (n,); 1 <= k <= n; out (n, heads head_dim);
// head_dim 16.
int gpcr_patch_attn(const float* qkv, int row, const int* order, int n, int k,
                    int heads, int head_dim, float qscale, float* out,
                    void* cuda_stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (k <= 0 || k > n || heads <= 0 || row < 3 * heads * head_dim ||
      row % 4)
    return (int)cudaErrorInvalidValue;
  if ((size_t)qkv % 16 || (size_t)out % 16)
    return (int)cudaErrorMisalignedAddress;
  const int patches = (n + k - 1) / k;
  Args a{qkv, row, order, n, k, heads, qscale, out, (k + kBQ - 1) / kBQ};
  const long long blocks = (long long)patches * heads * a.qblocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)cuda_stream;
  if (head_dim == 16) return (int)launch<16>(a, (int)blocks, st);
  return (int)cudaErrorInvalidValue;
}

const char* gpcr_patch_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
