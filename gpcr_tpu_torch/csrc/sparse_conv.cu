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
// generative k2s2 up conv (a fine row's parent, in its octant's column); and
// PTv3's 5^3 stem (five launches of 25 offsets) and CPE convs.
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
// Design: a warp-specialised ring. One CTA per (tile of 64 sorted rows, block
// of G * BN output channels) walks the tile's offsets (ascending k) and the
// KC-channel chunks of Cin as one sequence of steps. Its last two warps are
// producers: for each step they copy the 64 neighbour rows' chunk (A, 64 x
// KC; a lane per row) and W[k]'s chunk (B, KC x G * BN) into one of S
// shared-memory stages, each guarded by two mbarriers (full, empty). The
// rows go as 16-byte cp.async (4-byte where Cin is not a multiple of 4),
// zero-filled for misses and past Cin, and each producer lane reports their
// landing to the full barrier (cp.async.mbarrier.arrive.noinc);
// W goes as cp.async.bulk (one per chunk where the block holds every column,
// else one per row) that completes on the full barrier's transaction count,
// its rows past Cin stored as zeros by the producers (4-byte cp.async where
// Cout is not a multiple of 4). A bulk copy per gathered row was 1.24x slower
// over a U-Net pass on an H100 than 16-byte cp.async. The other warps are
// consumers in G groups of BN columns; they never load from device memory
// and never meet at a CTA barrier in the step loop: each waits on a stage's
// full barrier, runs its FFMAs from the stage and arrives on its empty
// barrier, and the producers refill a stage once every consumer warp has
// released it. So the gathers of the next S - 1 steps stay in flight while
// the consumers multiply, and one stage's gathered rows feed all G groups
// (PTv3's 256- and 512-channel CPE convs gather each row chunk once for 256
// columns, not once per 128).
//
// Each consumer thread keeps a TM x TN register tile of the output: rows ty +
// i * 64 / TM, and TN / 4 runs of 4 columns (TN 8: columns 4 tx .. 4 tx + 3
// of each half of the group's BN, so that 8 neighbouring threads read 128
// contiguous bytes of B). It accumulates with explicit fused multiply-adds
// (the library is built with -fmad=false, which only stops contraction:
// __fmaf_rn is still one FFMA). The epilogue adds the bias, applies the ReLU
// and stores each output once at its code-order row: no atomics, so two
// launches give the same bits. The parameters follow the weight's shape, one
// algorithm with other parameters (Shape below): BN the smallest of 8, 16,
// 32, 64, 128 that holds Cout, G up to 2 groups of 128 past that, KC 8, 16
// or 32 by Cin, S as deep as the SM's occupancy leaves room for (ring_of);
// 15 instantiations.
//
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

#include "blend_common.cuh"  // the mbarrier and bulk-copy pieces of the ring

namespace {

using gpcr::bulk_copy;
using gpcr::cp_async_arrive_noinc;
using gpcr::mbar_arrive;
using gpcr::mbar_arrive_expect_tx;
using gpcr::mbar_init;
using gpcr::mbar_try_wait;

constexpr int kRows = 64;        // rows per tile: ops/sparse.py TILE_ROWS
constexpr int kMaxOffsets = 27;  // 3^3
constexpr int kMaxStages = 4;
constexpr int kProducers = 2;  // producer warps per CTA
constexpr int kOwnRows = kRows / kProducers;  // rows each producer gathers
static_assert(kOwnRows == 32, "a producer lane per row");

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

// orders this thread's generic accesses to shared memory before its later
// async-proxy (bulk copy) accesses
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// One consumer group: BN output channels, a TM x TN register tile per thread,
// KC input channels per step; up to MaxGroups groups share a stage.
template <int BN, int TM, int TN, int KC, int MaxGroups>
struct Shape {
  static constexpr int kBN = BN;
  static constexpr int kKC = KC;
  static constexpr int kMaxGroups = MaxGroups;
  static constexpr int kThreadsN = BN / TN;
  static constexpr int kThreadsM = kRows / TM;
  static constexpr int kGroupThreads = kThreadsN * kThreadsM;
  static_assert(kGroupThreads % 32 == 0, "a group is whole warps");
  static constexpr int kGroupWarps = kGroupThreads / 32;
  static constexpr int kRuns = TN / 4;         // runs of 4 columns
  static constexpr int kRunStride = BN / kRuns;  // columns between runs
  static constexpr int kApad = KC + 4;  // A row stride in shared memory
  static constexpr int kAFloats = kRows * kApad;
  static constexpr int kMaxThreads =
      MaxGroups * kGroupThreads + 32 * kProducers;
};

// The ring's layout in dynamic shared memory: full[S], empty[S] mbarriers,
// the producers' 64 neighbour rows of the current offset, then S stages of
// A (kAFloats) and B (KC x nb) floats; every piece 16-byte aligned.
__host__ __device__ inline int ring_head_bytes(int stages) {
  return 16 * stages + kRows * 4;
}

struct Ring {
  int groups, nb, stages, smem_bytes;
};

// G groups of BN columns hold Cout (at most kMaxGroups). The stages: 2, and
// then as many more (up to kMaxStages) as keep the SM's resident CTAs at
// their number with 2: the registers or the threads mostly set that number,
// and the shared memory they leave holds a deeper ring at no cost. Found
// once per instantiation and group count with the occupancy calculator.
template <class Sh>
cudaError_t ring_of(const void* kernel, int cout, Ring* r) {
  const int g = (cout + Sh::kBN - 1) / Sh::kBN;
  r->groups = g > Sh::kMaxGroups ? Sh::kMaxGroups : g;
  r->nb = r->groups * Sh::kBN;
  const int threads = r->groups * Sh::kGroupThreads + 32 * kProducers;
  const int stage_bytes = (Sh::kAFloats + Sh::kKC * r->nb) * 4;
  auto bytes = [&](int s) { return ring_head_bytes(s) + s * stage_bytes; };
  static int known[Sh::kMaxGroups + 1];  // stages by group count; 0: not yet
  if (!known[r->groups]) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    int most = kMaxStages;
    while (most > 2 && bytes(most) > optin) --most;
    if (e == cudaSuccess)  // every ring up to the card's limit may launch
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    int resident = 0, stages = 2;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                        threads, bytes(2));
    for (int s = 3; e == cudaSuccess && s <= most; ++s) {
      int n = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                        bytes(s));
      if (e != cudaSuccess || n < resident) break;
      stages = s;
    }
    if (e != cudaSuccess) return e;
    known[r->groups] = stages;
  }
  r->stages = known[r->groups];
  r->smem_bytes = bytes(r->stages);
  return cudaSuccess;
}

template <int BN, int TM, int TN, int KC, int kMaxGroups>
__global__ void __launch_bounds__(
    Shape<BN, TM, TN, KC, kMaxGroups>::kMaxThreads)
    sparse_conv_kernel(Args a, int groups, int stages, int col_blocks) {
  using Sh = Shape<BN, TM, TN, KC, kMaxGroups>;
  constexpr int kApad = Sh::kApad;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* const full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* const empty = full + stages;
  int* const pidx = reinterpret_cast<int*>(empty + stages);
  float* const ring = reinterpret_cast<float*>(smem + ring_head_bytes(stages));
  const int nb = groups * BN;  // B columns per stage
  const int stage_floats = Sh::kAFloats + KC * nb;
  const int consumer_warps = groups * Sh::kGroupWarps;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tile = blockIdx.x / col_blocks;
  const int n0 = (blockIdx.x % col_blocks) * nb;
  const int base = tile * kRows;
  const unsigned mask = (unsigned)a.tile_masks[tile];

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      // per producer warp its lane 0 (with the bulk bytes it expects), and
      // its 32 lanes once their cp.async copies have landed
      mbar_init(full + i, 33u * kProducers);
      mbar_init(empty + i, (unsigned)consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the only CTA barrier: the ring's barriers exist

  if (warp >= consumer_warps) {  // a producer
    constexpr int kLanes = 32 * kProducers;
    const int pw = warp - consumer_warps;
    const int pl = pw * 32 + lane;  // lane among the producers
    // 16-byte copies where whole 4-channel groups are aligned
    const bool vec_a = (a.cin % 4 == 0) && ((size_t)a.x % 16 == 0);
    const bool vec_b = (a.cout % 4 == 0) && ((size_t)a.w % 16 == 0);
    const int ncol = min(nb, a.cout - n0);  // real columns of the block
    int* const idx = pidx + pw * kOwnRows;  // this warp's rows' neighbours
    float* const own = ring + pw * kOwnRows * kApad;  // and their stage rows
    unsigned m = mask;
    int st = 0, lap = 0;
    // the neighbour of this lane's row at the next offset, one offset ahead
    auto next_row = [&](unsigned rest) {
      return a.nbr[(size_t)(__ffs(rest) - 1) * a.n_pad + base + pw * kOwnRows +
                   lane];
    };
    int jn = m ? next_row(m) : -1;
    while (m) {
      const int k = __ffs(m) - 1;
      m &= m - 1;
      __syncwarp();  // the last offset's reads of idx are done
      idx[lane] = jn;
      __syncwarp();
      if (m) jn = next_row(m);
      const float* wk = a.w + (size_t)k * a.cin * a.cout;
      for (int c0 = 0; c0 < a.cin; c0 += KC) {
        if (lap > 0)  // every consumer warp has released this stage
          while (!mbar_try_wait(empty + st, (unsigned)((lap - 1) & 1))) {
          }
        float* const A = own + (size_t)st * stage_floats;
        float* const B = ring + (size_t)st * stage_floats + Sh::kAFloats;
        unsigned long long* const bar = full + st;
        const int nv = min(KC, a.cin - c0);  // real channels of the chunk
        const float* const wsrc = wk + (size_t)c0 * a.cout + n0;
        const bool whole = ncol == a.cout && ncol == nb;  // one W copy
        // W rows past Cin as zeros (generic stores), and the bulk bytes
        // this warp will issue
        unsigned bytes = 0;
        if (vec_b) {
          for (int e = pl; e < (KC - nv) * (nb / 4); e += kLanes)
            reinterpret_cast<float4*>(B + nv * nb)[e] =
                make_float4(0.f, 0.f, 0.f, 0.f);
          if (whole)
            bytes = pl == 0 ? (unsigned)(nv * nb * 4) : 0u;
          else
            for (int kk = pl; kk < nv; kk += kLanes) bytes += ncol * 4u;
          bytes = __reduce_add_sync(0xffffffffu, bytes);
          fence_proxy_async();  // the zeros before any later bulk copy
        }
        __syncwarp();  // the zeros precede lane 0's (releasing) arrival
        if (lane == 0) mbar_arrive_expect_tx(bar, bytes);
        __syncwarp();  // the bytes are expected before any copy lands
        if (vec_a) {
          for (int e = lane; e < kOwnRows * KC / 4; e += 32) {
            const int r = e / (KC / 4), c = (e % (KC / 4)) * 4;
            const int j = idx[r];
            const bool ok = j >= 0 && c < nv;
            cp_async16(A + r * kApad + c,
                       ok ? a.x + (size_t)j * a.cin + c0 + c : a.x,
                       ok ? 16 : 0);
          }
        } else {
          for (int e = lane; e < kOwnRows * KC; e += 32) {
            const int r = e / KC, c = e % KC;
            const int j = idx[r];
            const bool ok = j >= 0 && c < nv;
            cp_async4(A + r * kApad + c,
                      ok ? a.x + (size_t)j * a.cin + c0 + c : a.x,
                      ok ? 4 : 0);
          }
        }
        if (vec_b) {
          if (whole) {
            if (pl == 0) bulk_copy(B, wsrc, (unsigned)(nv * nb * 4), bar);
          } else {
            for (int kk = pl; kk < nv; kk += kLanes)
              bulk_copy(B + kk * nb, wsrc + (size_t)kk * a.cout,
                        (unsigned)ncol * 4u, bar);
          }
        } else {
          for (int e = pl; e < KC * nb; e += kLanes) {
            const int kk = e / nb, n = e % nb;
            const bool ok = kk < nv && n0 + n < a.cout;
            cp_async4(B + e, ok ? wsrc + (size_t)kk * a.cout + n : a.w,
                      ok ? 4 : 0);
          }
        }
        cp_async_arrive_noinc(bar);
        if (++st == stages) {
          st = 0;
          ++lap;
        }
      }
    }
    // no copy of this thread may land after the CTA is gone
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // a consumer: group g, thread t of the group
  const int g = warp / Sh::kGroupWarps;
  const int t = tid - g * Sh::kGroupThreads;
  const int tx = t % Sh::kThreadsN;
  const int ty = t / Sh::kThreadsN;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int n_steps = __popc(mask) * ((a.cin + KC - 1) / KC);
  int st = 0, lap = 0;
  for (int s = 0; s < n_steps; ++s) {
    while (!mbar_try_wait(full + st, (unsigned)(lap & 1))) {
    }
    const float* A = ring + (size_t)st * stage_floats;
    const float* B = A + Sh::kAFloats + g * BN + tx * 4;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 4) {
      float4 bv[4][Sh::kRuns];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int h = 0; h < Sh::kRuns; ++h)
          bv[q][h] = *reinterpret_cast<const float4*>(
              B + (kk + q) * nb + h * Sh::kRunStride);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 av = *reinterpret_cast<const float4*>(
            A + (ty + i * Sh::kThreadsM) * kApad + kk);
        const float ai[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int h = 0; h < Sh::kRuns; ++h) {
            acc[i][4 * h] = __fmaf_rn(ai[q], bv[q][h].x, acc[i][4 * h]);
            acc[i][4 * h + 1] =
                __fmaf_rn(ai[q], bv[q][h].y, acc[i][4 * h + 1]);
            acc[i][4 * h + 2] =
                __fmaf_rn(ai[q], bv[q][h].z, acc[i][4 * h + 2]);
            acc[i][4 * h + 3] =
                __fmaf_rn(ai[q], bv[q][h].w, acc[i][4 * h + 3]);
          }
      }
    }
    __syncwarp();  // every lane is done with the stage
    if (lane == 0) mbar_arrive(empty + st);
    if (++st == stages) {
      st = 0;
      ++lap;
    }
  }

  // epilogue: bias, ReLU, one store per output at its code-order row
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = a.rows[base + ty + i * Sh::kThreadsM];
    if (r < 0) continue;
    float* o = a.out + (size_t)r * a.cout;
#pragma unroll
    for (int h = 0; h < Sh::kRuns; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + g * BN + h * Sh::kRunStride + tx * 4 + j;
        if (col >= a.cout) continue;
        float v = acc[i][4 * h + j];
        if (a.bias) v = v + a.bias[col];
        if (a.relu && v < 0.f) v = 0.f;
        o[col] = v;
      }
  }
}

template <int BN, int TM, int TN, int KC, int kMaxGroups>
cudaError_t launch(const Args& a, int n_tiles, cudaStream_t st, int* info) {
  using Sh = Shape<BN, TM, TN, KC, kMaxGroups>;
  const auto kernel = sparse_conv_kernel<BN, TM, TN, KC, kMaxGroups>;
  Ring r;
  const cudaError_t e = ring_of<Sh>((const void*)kernel, a.cout, &r);
  if (e != cudaSuccess) return e;
  const int threads = r.groups * Sh::kGroupThreads + 32 * kProducers;
  if (info) {  // the plan, for reports: BN, TM, TN, KC, G, S, threads, smem
    const int v[8] = {BN, TM, TN, KC, r.groups, r.stages, threads,
                      r.smem_bytes};
    for (int i = 0; i < 8; ++i) info[i] = v[i];
    return cudaSuccess;
  }
  const int col_blocks = (a.cout + r.nb - 1) / r.nb;
  kernel<<<n_tiles * col_blocks, threads, r.smem_bytes, st>>>(
      a, r.groups, r.stages, col_blocks);
  return cudaGetLastError();
}

// The shape from the weight's shape: BN the smallest of 8 ... 128 that holds
// Cout (wider Cout in up to 2 groups of 128 per CTA, then in blocks of 256),
// KC the chunk that Cin fills. The register tile: 8 x 8 at BN 128 (its 152
// registers still leave two CTAs of 6 warps on an SM); at BN 64 8 x 4, since
// 8 x 8 leaves two consumer warps a CTA and ran 1.3x slower over a U-Net
// pass's BN 64 convs on an H100.
template <int KC>
cudaError_t by_cout(const Args& a, int n_tiles, cudaStream_t st, int* info) {
  if (a.cout <= 8) return launch<8, 2, 4, KC, 1>(a, n_tiles, st, info);
  if (a.cout <= 16) return launch<16, 4, 4, KC, 1>(a, n_tiles, st, info);
  if (a.cout <= 32) return launch<32, 4, 4, KC, 1>(a, n_tiles, st, info);
  if (a.cout <= 64) return launch<64, 8, 4, KC, 1>(a, n_tiles, st, info);
  return launch<128, 8, 8, KC, 2>(a, n_tiles, st, info);
}

cudaError_t dispatch(const Args& a, int n_tiles, cudaStream_t st, int* info) {
  if (a.cin <= 8) return by_cout<8>(a, n_tiles, st, info);
  if (a.cin <= 16) return by_cout<16>(a, n_tiles, st, info);
  return by_cout<32>(a, n_tiles, st, info);
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
  return (int)dispatch(a, n_tiles, (cudaStream_t)cuda_stream, nullptr);
}

// The kernel's parameters for (cin, cout), without a launch: info[0..7] =
// BN, TM, TN, KC, groups, stages, threads, dynamic shared bytes.
int gpcr_sparse_conv_plan(int cin, int cout, int* info) {
  if (cin <= 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  Args a{};
  a.cin = cin;
  a.cout = cout;
  return (int)dispatch(a, 0, nullptr, info);
}

// Rows per tile the kernel was built for (the plan's tiles must match).
int gpcr_sparse_conv_tile_rows() { return kRows; }

const char* gpcr_sparse_conv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
