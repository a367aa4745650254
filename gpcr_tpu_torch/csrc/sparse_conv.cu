// Sparse voxel convolution as one output-stationary implicit GEMM over a
// neighbour map built once per cloud:
//   out[r] = bias + sum_k sum_{j = map[r, k] hit} x[j] @ W[k]   (then ReLU, if asked)
//
// Replaces no TPU kernel: the JAX package's U-Net (gpcr_tpu/models/unet.py on
// gpcr_tpu/ops/sparse.py) runs XLA gathers, dots and segment sums. The port
// ran the same ops one by one (ops/sparse.py::conv_multi: per offset a gather
// of (N, Cin), a cuBLAS product and an add; conv_down / conv_up_generative:
// 8 boolean octant masks, each a host sync, and index_add_ atomics), some
// 4,500 launches and ~200 host syncs per U-Net pass at about 5% of the card's
// float32 rate. This kernel covers every sparse convolution of
// models/unet.py::SparseUNet.forward that needs no gradient: the 3^3 stride-1
// convs (27 offsets), the k2s2 down conv (8 children of a parent) and the
// generative k2s2 up conv (a fine row's parent, in its octant's column).
//
// The map (built by ops/sparse.py::tile_map at plan time):
//   nbr        (K, n_pad) i32: row i of the SORTED row order reads input row
//              nbr[k, i] at offset k; -1 is a miss (zero-filled here, no
//              padded zero row in memory);
//   rows       (n_pad,) i32: the output row (code order) of sorted row i; -1
//              pads the last tile;
//   tile_masks (n_pad / 64,) i32: bit k set where some row of the tile hits
//              offset k. Rows are sorted by their own hit mask, so a tile's
//              rows share most offsets and the kernel computes the tile's
//              rows x its mask's offsets ("slots"): 48-82% of them are pairs
//              at the learned cell's levels, 20-60% in code order.
//
// Design. One CTA per (tile of 64 sorted rows, block of BN output channels).
// It loads the tile's neighbour indices once, then walks its offsets and
// KC-channel chunks of Cin as one sequence of steps through a 2-stage
// cp.async ring in dynamic shared memory (step s + 1 loads while step s
// computes): per step the 64 neighbour rows'
// chunk (A, 64 x KC, zero-filled for misses and past Cin) and W[k]'s chunk
// (B, KC x BN, zero-filled past Cin and Cout), 16 bytes per copy where Cin /
// Cout are multiples of 4. Each thread keeps a TM x 4 register tile of the
// output (rows ty + i * 64 / TM, columns 4 tx .. 4 tx + 3) and accumulates
// with explicit fused multiply-adds (the library is built with -fmad=false,
// which only stops contraction: __fmaf_rn is still one FFMA). The epilogue
// adds the bias, applies the ReLU and stores each output row once at its
// code-order position: no atomics, so two launches give the same bits.
// The tile shape follows the weight's shape, one algorithm with other
// parameters: BN the smallest of 8, 16, 32, 64, 128 that holds Cout (TM 2,
// 4, 4, 8, 8), KC 8, 16 or 32 by Cin; 15 instantiations, built in ~14 s.
// On an H100 at the learned cell's shapes (PERF.md section 6), over a U-Net
// pass: KC 32 at Cin >= 32 beat KC 16 by 2.4%, TM 8 at BN 64 beat TM 4 on
// every Cout-64 conv by 1-7%, 2 stages beat 3 by 1.8% (faster on the
// gather-bound convs of Cout <= 32, slower on the widest), 4 were 6% slower.

// What bounds it on Hopper. Float32 on the CUDA cores: the configuration pins
// TF32 off, so no tensor core takes these products. 2 * Cin * Cout operations
// per computed slot at 67 TFLOP/s; the bytes are the gathered rows (Cin * 4
// per pair, mostly from L2), W and the outputs. At Cout >= 32 the FMAs bound
// it; at Cout 8-16 the gathers (A is reused across only BN columns).
//
// Numerics. Per output the sum runs over the tile's offsets in ascending k,
// within an offset over Cin in ascending order, in float32 with one rounding
// per FMA; the plain version (ops/sparse.py::conv_map_plain, or cuBLAS in the
// differentiable ops) sums in another order, so the two differ by float32
// rounding of the sum, nothing else.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;        // rows per tile: ops/sparse.py TILE_ROWS
constexpr int kStages = 2;       // cp.async ring depth
constexpr int kMaxOffsets = 27;  // 3^3

// 4- and 16-byte asynchronous copies; src_bytes 0 fills the destination with
// zeros and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

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
  const float* x;
  int cin;
  const float* w;  // (K, cin, cout)
  int cout;
  const float* bias;  // (cout,) or null
  const int* nbr;     // (K, n_pad)
  int n_pad;
  const int* rows;        // (n_pad,)
  const int* tile_masks;  // (n_pad / kRows,)
  int relu;
  float* out;  // (n_out, cout)
};

// BN output channels per CTA, TM rows and 4 columns per thread, KC input
// channels per step.
template <int BN, int TM, int KC>
struct Tiles {
  static constexpr int kThreadsN = BN / 4;
  static constexpr int kThreadsM = kRows / TM;
  static constexpr int kThreads = kThreadsN * kThreadsM;
  static constexpr int kApad = KC + 4;  // A row stride in shared memory
  static constexpr int kAFloats = kRows * kApad;
  static constexpr int kBFloats = KC * BN;
  static constexpr int kSmemBytes =
      kStages * (kAFloats + kBFloats) * 4 + kMaxOffsets * kRows * 4;
};

template <int BN, int TM, int KC>
__global__ void __launch_bounds__(Tiles<BN, TM, KC>::kThreads)
    sparse_conv_kernel(Args a, int col_blocks) {
  using Cfg = Tiles<BN, TM, KC>;
  constexpr int NT = Cfg::kThreads;
  constexpr int kApad = Cfg::kApad;
  extern __shared__ __align__(16) float smem[];
  float* const As = smem;                                 // [kStages][kAFloats]
  float* const Bs = smem + kStages * Cfg::kAFloats;       // [kStages][kBFloats]
  int(*const sidx)[kRows] =
      reinterpret_cast<int(*)[kRows]>(Bs + kStages * Cfg::kBFloats);

  const int tid = threadIdx.x;
  const int tile = blockIdx.x / col_blocks;
  const int n0 = (blockIdx.x % col_blocks) * BN;
  const int base = tile * kRows;
  const unsigned mask = (unsigned)a.tile_masks[tile];
  const int n_offsets = __popc(mask);
  const int n_chunks = (a.cin + KC - 1) / KC;
  const int n_steps = n_offsets * n_chunks;

  // the tile's neighbour rows, by the ordinal of their offset in the mask
  {
    unsigned m = mask;
    for (int o = 0; m; ++o) {
      const int k = __ffs(m) - 1;
      m &= m - 1;
      for (int r = tid; r < kRows; r += NT)
        sidx[o][r] = a.nbr[(size_t)k * a.n_pad + base + r];
    }
  }
  __syncthreads();

  // 16-byte copies where whole 4-channel groups are aligned
  const bool vec_a = (a.cin % 4 == 0) && ((size_t)a.x % 16 == 0);
  const bool vec_b = (a.cout % 4 == 0) && (n0 % 4 == 0) && ((size_t)a.w % 16 == 0);

  // load cursor: offset ordinal, offset, first channel of the chunk
  unsigned ld_mask = mask;
  int ld_o = 0, ld_k = ld_mask ? __ffs(ld_mask) - 1 : 0, ld_c0 = 0;

  auto load_step = [&](int stage) {
    float* A = As + stage * Cfg::kAFloats;
    float* B = Bs + stage * Cfg::kBFloats;
    const int* idx = sidx[ld_o];
    if (vec_a) {
      for (int e = tid; e < kRows * KC / 4; e += NT) {
        const int r = e / (KC / 4), c = ld_c0 + (e % (KC / 4)) * 4;
        const int j = idx[r];
        const bool ok = j >= 0 && c < a.cin;
        cp_async16(A + r * kApad + (c - ld_c0),
                   ok ? a.x + (size_t)j * a.cin + c : a.x, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kRows * KC; e += NT) {
        const int r = e / KC, c = ld_c0 + e % KC;
        const int j = idx[r];
        const bool ok = j >= 0 && c < a.cin;
        cp_async4(A + r * kApad + (c - ld_c0),
                  ok ? a.x + (size_t)j * a.cin + c : a.x, ok ? 4 : 0);
      }
    }
    const float* wk = a.w + (size_t)ld_k * a.cin * a.cout;
    if (vec_b) {
      for (int e = tid; e < KC * BN / 4; e += NT) {
        const int kk = e / (BN / 4), n = (e % (BN / 4)) * 4;
        const int c = ld_c0 + kk, col = n0 + n;
        const bool ok = c < a.cin && col < a.cout;
        cp_async16(B + kk * BN + n, ok ? wk + (size_t)c * a.cout + col : a.w,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < KC * BN; e += NT) {
        const int kk = e / BN, n = e % BN;
        const int c = ld_c0 + kk, col = n0 + n;
        const bool ok = c < a.cin && col < a.cout;
        cp_async4(B + kk * BN + n, ok ? wk + (size_t)c * a.cout + col : a.w,
                  ok ? 4 : 0);
      }
    }
    // advance: the next chunk, else the next offset of the mask
    ld_c0 += KC;
    if (ld_c0 >= a.cin) {
      ld_c0 = 0;
      ++ld_o;
      ld_mask &= ld_mask - 1;
      ld_k = ld_mask ? __ffs(ld_mask) - 1 : 0;
    }
  };

  const int tx = tid % Cfg::kThreadsN;
  const int ty = tid / Cfg::kThreadsN;
  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_steps) load_step(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step s landed for all; step s - 1's stage is free
    if (s + kStages - 1 < n_steps) load_step((s + kStages - 1) % kStages);
    cp_async_commit();
    const float* A = As + (s % kStages) * Cfg::kAFloats;
    const float* B = Bs + (s % kStages) * Cfg::kBFloats;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(
            A + (ty + i * Cfg::kThreadsM) * kApad + kk);
      float4 bv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        bv[q] = *reinterpret_cast<const float4*>(B + (kk + q) * BN + tx * 4);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float ai[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][0] = __fmaf_rn(ai[q], bv[q].x, acc[i][0]);
          acc[i][1] = __fmaf_rn(ai[q], bv[q].y, acc[i][1]);
          acc[i][2] = __fmaf_rn(ai[q], bv[q].z, acc[i][2]);
          acc[i][3] = __fmaf_rn(ai[q], bv[q].w, acc[i][3]);
        }
      }
    }
  }

  // epilogue: bias, ReLU, one store per output at its code-order row
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = a.rows[base + ty + i * Cfg::kThreadsM];
    if (r < 0) continue;
    float* o = a.out + (size_t)r * a.cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= a.cout) continue;
      float v = acc[i][j];
      if (a.bias) v = v + a.bias[col];
      if (a.relu && v < 0.f) v = 0.f;
      o[col] = v;
    }
  }
}

template <int BN, int TM, int KC>
cudaError_t launch(const Args& a, int n_tiles, cudaStream_t st) {
  using Cfg = Tiles<BN, TM, KC>;
  const auto kernel = sparse_conv_kernel<BN, TM, KC>;
  if (Cfg::kSmemBytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemBytes);
    if (e != cudaSuccess) return e;
  }
  const int col_blocks = (a.cout + BN - 1) / BN;
  kernel<<<n_tiles * col_blocks, Cfg::kThreads, Cfg::kSmemBytes, st>>>(
      a, col_blocks);
  return cudaGetLastError();
}

// The tile shape from the weight's shape: BN the smallest of 8 ... 128 that
// holds Cout (wider Cout in blocks of 128), KC the chunk that Cin fills.
template <int KC>
cudaError_t by_cout(const Args& a, int n_tiles, cudaStream_t st) {
  if (a.cout <= 8) return launch<8, 2, KC>(a, n_tiles, st);
  if (a.cout <= 16) return launch<16, 4, KC>(a, n_tiles, st);
  if (a.cout <= 32) return launch<32, 4, KC>(a, n_tiles, st);
  if (a.cout <= 64) return launch<64, 8, KC>(a, n_tiles, st);
  return launch<128, 8, KC>(a, n_tiles, st);
}

}  // namespace

extern "C" {

// Returns a cudaError_t value: 0 on a successful launch. n_pad = 64 * n_tiles;
// k_offsets <= 27; out (n_out, cout) gets every row that rows[] names.
int gpcr_sparse_conv(const float* x, int cin, const float* w, int cout,
                     const float* bias, const int* nbr, int k_offsets,
                     const int* rows, const int* tile_masks, int n_tiles,
                     int relu, float* out, void* cuda_stream) {
  if (n_tiles <= 0) return (int)cudaSuccess;
  if (cin <= 0 || cout <= 0 || k_offsets <= 0 || k_offsets > kMaxOffsets)
    return (int)cudaErrorInvalidValue;
  Args a{x, cin, w, cout, bias, nbr, n_tiles * kRows, rows, tile_masks,
         relu, out};
  cudaStream_t st = (cudaStream_t)cuda_stream;
  if (cin <= 8) return (int)by_cout<8>(a, n_tiles, st);
  if (cin <= 16) return (int)by_cout<16>(a, n_tiles, st);
  return (int)by_cout<32>(a, n_tiles, st);
}

// Rows per tile the kernel was built for (the plan's tiles must match).
int gpcr_sparse_conv_tile_rows() { return kRows; }

const char* gpcr_sparse_conv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
