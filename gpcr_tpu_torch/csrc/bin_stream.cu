// Binning of one view into the tile-sorted stream of the blend kernels:
// emit a (tile, rank) entry for each of the first min(area, cap) tiles of
// every presorted splat's rect, sort the entries by tile, find each tile's
// start, and write the stream rows [x, y, conic(3), op, depth, 0, feat(C)].
//
// Replaces no TPU kernel: the JAX package bins with XLA sorts and gathers
// (gpcr_tpu/ops/rasterize_stream.py::bin_sorted_stream), and the port's plain
// version (ops/rasterize_stream.py::bin_sorted_stream_plain) does the same in
// PyTorch: ten E-sized int64 temporaries in the emit, a radix sort over all
// 64 bits of a unique (tile, rank) key, a cat of an (n, 8 + C) table of every
// splat and a double gather into the stream.
//
// The key fact: the caller presorts splats by (depth, index) and the emit
// walks them in that rank order, so a STABLE sort by the tile alone gives
// the order of the unique key tile * (n + 1) + rank. The sort takes uint32
// tile keys and int32 rank values over bits [0, bit_length(count)) only
// (CUB's onesweep radix sort: 2 passes of 8-bit digits up to 16 bits; the
// reference rasterizer sorts 32 + getHigherMsb(numTiles) bits the same way,
// rasterizer_impl.cu:300-308).
//
// Kernels, in stream order on the caller's CUDA stream:
// 1. count: per presorted rank r (one thread), min(area, cap) entries of
//    splat gidx_s[r] if valid, else 0, and the dup-cap overflow summed per
//    CTA and added with one atomic. The wrapper scans the counts
//    (torch.cumsum) and reads the total once: it sizes the entry arrays.
// 2. emit: each rank's entries at its offset, row-major over its rect, one
//    warp per 32 ranks walking their entries 32 at a time: key = the tile's
//    id in the window [base, base + count), or count (a sentinel bucket
//    that sorts last) for a tile outside it; value = r.
// 3. sort: cub::DeviceRadixSort::SortPairs over a DoubleBuffer (the result
//    lies in the buffer the returned selector names).
// 4. starts: one thread per sorted position i in [0, E] fills starts[t] = i
//    for the tiles t in (key[i - 1], key[i]] (empty tiles take the next
//    tile's start; i = E closes the list at count), cut to kb when a budget
//    is given; the one thread that writes starts[count] adds the cut
//    entries to the overflow.
// 5. rows: one CTA per 128 sorted entries gathers its rows straight from the
//    preprocess outputs (any strides) into a (128, 8 + C) tile in shared
//    memory, then stores the tile in 16-byte words: a row of 8 + C floats is
//    no multiple of 16 bytes (68 B at C = 9), a block of 128 rows is.
//
// What bounds it on Hopper: bytes. At the learned view 0 (E = 4.75M entries,
// C = 12): the emit writes 8 B per entry, each sort pass reads and writes 8
// B per entry, the stream write is 80 B per entry, the rows read 12 B of
// rank and gidx_s per entry. The splat fields the rows gather (n = 717K
// splats of 76 B) are read once per entry, in 4-48 B pieces: they are
// largely L2 hits, but each row touches about seven 32 B sectors.
//
// Numerics: none. Every stream value is a copied float32; the order is the
// plain version's, so stream, starts, overflow and the sorted ranks are
// bit-equal to it.

#include <cuda_runtime.h>
#include <cub/device/device_radix_sort.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerCta = 128;
// dynamic shared memory of the row tile: 128 rows of up to 88 floats, with
// the 1 KB of g_row inside the default 48 KB
constexpr size_t kTileBytes = 45056;

__global__ void __launch_bounds__(kThreads)
count_kernel(const int* __restrict__ rect, const unsigned char* __restrict__ valid,
             const long long* __restrict__ gidx_s, int n, int cap,
             long long* __restrict__ area, unsigned long long* overflow) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  long long over = 0;
  if (r < n) {
    const long long g = gidx_s[r];
    long long a = 0;
    if (valid[g]) {
      const int* rc = rect + 4 * g;
      const long long raw = (long long)(rc[2] - rc[0]) * (rc[3] - rc[1]);
      a = raw < cap ? raw : (long long)cap;
      over = raw > cap ? raw - cap : 0;
    }
    area[r] = a;
  }
  for (int o = 16; o > 0; o >>= 1) over += __shfl_down_sync(0xffffffffu, over, o);
  __shared__ long long part[kThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) part[warp] = over;
  __syncthreads();
  if (warp == 0) {
    over = lane < kThreads / 32 ? part[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) over += __shfl_down_sync(0xffffffffu, over, o);
    if (lane == 0 && over) atomicAdd(overflow, (unsigned long long)over);
  }
}

// One warp per 32 consecutive ranks: the warp walks its ranks' entries
// [start of lane 0, end of lane 31) 32 at a time, so its stores are
// coalesced and a splat of 256 tiles costs its warp 8 steps, not 256. The
// lane that owns entry e is the last whose start is <= e (a lane with no
// entries shares its start with the next lane, and the search takes the
// later one), found by a binary search over the lanes' starts.
__global__ void __launch_bounds__(kThreads)
emit_kernel(const int* __restrict__ rect, const long long* __restrict__ gidx_s,
            const long long* __restrict__ incl, int n, int grid_x, int base,
            int count, unsigned* __restrict__ keys, int* __restrict__ vals) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x % 32;
  if (r - lane >= n) return;  // the whole warp is past the end
  const long long start = r == 0 ? 0 : incl[min(r, n) - 1];
  int x0 = 0, y0 = 0, rw = 1;
  if (r < n && incl[r] > start) {
    const int* rc = rect + 4 * gidx_s[r];
    x0 = rc[0];
    y0 = rc[1];
    rw = max(rc[2] - x0, 1);
  }
  const unsigned full = 0xffffffffu;
  const long long first = __shfl_sync(full, start, 0);
  const long long last = __shfl_sync(full, r < n ? incl[r] : start, 31);
  for (long long e = first + lane; e - lane < last; e += 32) {
    int owner = 0;
    for (int step = 16; step > 0; step >>= 1) {
      const long long s_cand = __shfl_sync(full, start, owner + step);
      if (s_cand <= e) owner += step;
    }
    const int k = (int)(e - __shfl_sync(full, start, owner));
    const int ox0 = __shfl_sync(full, x0, owner);
    const int oy0 = __shfl_sync(full, y0, owner);
    const int orw = __shfl_sync(full, rw, owner);
    if (e < last) {
      const int local = (oy0 + k / orw) * grid_x + ox0 + k % orw - base;
      keys[e] = (local >= 0 && local < count) ? (unsigned)local
                                              : (unsigned)count;
      vals[e] = r - lane + owner;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
starts_kernel(const unsigned* __restrict__ keys, int total, int count,
              long long kb, int* __restrict__ starts, long long* overflow) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i > total) return;
  const int lo = i == 0 ? 0 : (int)keys[i - 1] + 1;
  const int hi = i == total ? count : (int)keys[i];
  if (lo > hi) return;  // the same tile as entry i - 1, or past count
  const bool cut = kb >= 0 && i > kb;
  const int s = cut ? (int)kb : i;
  for (int t = lo; t <= hi; ++t) starts[t] = s;
  if (hi == count && cut) *overflow += i - kb;
}

struct RowSources {
  const float* mean2d;
  const float* conic;
  const float* opacity;
  const float* depth;
  const float* feat;
  // element strides: mean2d (row, col), conic (row, col), opacity, depth,
  // feat (row, col)
  long long s[8];
};

// Column block [col, col + width) of the CTA's rows from one source, into
// the CTA's row tile: neighbouring threads read neighbouring columns of a
// row, then the next row.
__device__ __forceinline__ void gather_columns(
    const float* __restrict__ src, long long s_row, long long s_col,
    int width, int col, int rows, int ncol, const long long* g_row,
    float* tile) {
  for (int t = threadIdx.x; t < rows * width; t += kThreads) {
    const int j = t / width, c = t - j * width;
    tile[j * ncol + col + c] = src[g_row[j] * s_row + c * s_col];
  }
}

// One CTA per kRowsPerCta sorted entries: gidx_s[rank] of each row into
// shared memory, the rows gathered field by field into a (rows, 8 + C)
// tile there, then the tile stored in 16-byte words (the CTA's first row
// starts at a multiple of 512 (8 + C) bytes) and the last 0-3 floats one
// by one.
__global__ void __launch_bounds__(kThreads)
rows_kernel(const int* __restrict__ ranks, const long long* __restrict__ gidx_s,
            int kept, int channels, RowSources src, float* __restrict__ out) {
  extern __shared__ float4 tile4[];
  float* tile = reinterpret_cast<float*>(tile4);
  __shared__ long long g_row[kRowsPerCta];
  const int row0 = blockIdx.x * kRowsPerCta;
  const int rows = min(kRowsPerCta, kept - row0);
  if ((int)threadIdx.x < rows) g_row[threadIdx.x] = gidx_s[ranks[row0 + threadIdx.x]];
  __syncthreads();
  const int ncol = 8 + channels;
  gather_columns(src.mean2d, src.s[0], src.s[1], 2, 0, rows, ncol, g_row, tile);
  gather_columns(src.conic, src.s[2], src.s[3], 3, 2, rows, ncol, g_row, tile);
  gather_columns(src.opacity, src.s[4], 0, 1, 5, rows, ncol, g_row, tile);
  gather_columns(src.depth, src.s[5], 0, 1, 6, rows, ncol, g_row, tile);
  gather_columns(src.feat, src.s[6], src.s[7], channels, 8, rows, ncol, g_row,
                 tile);
  for (int j = threadIdx.x; j < rows; j += kThreads) tile[j * ncol + 7] = 0.0f;
  __syncthreads();
  const int floats = rows * ncol;
  float* dst = out + (long long)row0 * ncol;
  float4* dst4 = reinterpret_cast<float4*>(dst);
  for (int q = threadIdx.x; q < floats / 4; q += kThreads) dst4[q] = tile4[q];
  for (int e = floats / 4 * 4 + threadIdx.x; e < floats; e += kThreads)
    dst[e] = tile[e];
}

int blocks_for(long long items, int per_block) {
  return (int)((items + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

// Returns a cudaError_t value: 0 on a successful launch. rect (n, 4) i32,
// valid (n,) bool, gidx_s (n,) i64 (rank -> splat), area (n,) i64 out,
// overflow () i64 (added to).
int gpcr_bin_count(const int* rect, const unsigned char* valid,
                   const long long* gidx_s, int n, int cap, long long* area,
                   long long* overflow, void* cuda_stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (cap < 0) return (int)cudaErrorInvalidValue;
  count_kernel<<<blocks_for(n, kThreads), kThreads, 0,
                 (cudaStream_t)cuda_stream>>>(
      rect, valid, gidx_s, n, cap, area, (unsigned long long*)overflow);
  return (int)cudaGetLastError();
}

// Bytes of CUB scratch that gpcr_bin_sort needs for ``total`` entries and
// ``bits`` key bits (host only: no launch).
int gpcr_bin_sort_temp_bytes(int total, int bits, size_t* bytes) {
  cub::DoubleBuffer<unsigned> k(nullptr, nullptr);
  cub::DoubleBuffer<int> v(nullptr, nullptr);
  return (int)cub::DeviceRadixSort::SortPairs(nullptr, *bytes, k, v, total, 0,
                                              bits);
}

// Emit, sort and starts. incl (n,) i64 is the inclusive scan of
// gpcr_bin_count's area and total its last value; keys0 / vals0 and keys1 /
// vals1 (total,) the two halves of the sort's double buffer; starts
// (count + 1,) i32 out; kb < 0 for no budget; overflow () i64 (added to);
// *selector out: 0 if the sorted entries are in keys0 / vals0, 1 if in
// keys1 / vals1.
int gpcr_bin_sort(const int* rect, const long long* gidx_s,
                  const long long* incl, int n, int grid_x, int base,
                  int count, unsigned* keys0, int* vals0, unsigned* keys1,
                  int* vals1, int total, int bits, void* temp,
                  size_t temp_bytes, long long kb, int* starts,
                  long long* overflow, int* selector, void* cuda_stream) {
  *selector = 0;
  if (count <= 0 || total < 0 || bits < 1 || bits > 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)cuda_stream;
  if (total > 0) {
    emit_kernel<<<blocks_for(n, kThreads), kThreads, 0, st>>>(
        rect, gidx_s, incl, n, grid_x, base, count, keys0, vals0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cub::DoubleBuffer<unsigned> k(keys0, keys1);
    cub::DoubleBuffer<int> v(vals0, vals1);
    err = cub::DeviceRadixSort::SortPairs(temp, temp_bytes, k, v, total, 0,
                                          bits, st);
    if (err != cudaSuccess) return (int)err;
    *selector = k.selector;
  }
  const unsigned* sorted = *selector ? keys1 : keys0;
  starts_kernel<<<blocks_for((long long)total + 1, kThreads), kThreads, 0,
                  st>>>(sorted, total, count, kb, starts, overflow);
  return (int)cudaGetLastError();
}

// The stream rows of the first ``kept`` sorted entries: ranks (kept,) i32
// (the sorted values), gidx_s (n,) i64, the five float32 sources with their
// element strides (8 values, RowSources::s), out (kept, 8 + channels) f32.
int gpcr_bin_rows(const int* ranks, const long long* gidx_s, int kept,
                  int channels, const float* mean2d, const float* conic,
                  const float* opacity, const float* depth, const float* feat,
                  const long long* strides, float* out, void* cuda_stream) {
  if (kept <= 0) return (int)cudaSuccess;
  // the row tile in the default 48 KB of shared memory
  if (channels < 0 || (size_t)kRowsPerCta * (8 + channels) * 4 > kTileBytes)
    return (int)cudaErrorInvalidValue;
  if ((size_t)out % 16) return (int)cudaErrorMisalignedAddress;
  RowSources src{mean2d, conic, opacity, depth, feat, {}};
  for (int i = 0; i < 8; ++i) src.s[i] = strides[i];
  rows_kernel<<<blocks_for(kept, kRowsPerCta), kThreads,
                (size_t)kRowsPerCta * (8 + channels) * 4,
                (cudaStream_t)cuda_stream>>>(ranks, gidx_s, kept, channels,
                                             src, out);
  return (int)cudaGetLastError();
}

const char* gpcr_bin_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
