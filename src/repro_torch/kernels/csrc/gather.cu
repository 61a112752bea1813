// Row gather for Hopper (sm_90a): out[n] = table[ids[n]], zero rows for
// ids outside [0, V).
//
// Replaces, on the card, the TPU kernel
// repro/kernels/gather.py::onehot_gather_kernel (via onehot_gather_pallas
// and the wrapper gather_kernel_ops.py::pallas_onehot_gather), which
// computes the same rows as a one-hot product on the MXU:
// out[n] = onehot(ids[n]) @ table.  That product sums exactly one nonzero
// term, table[ids[n]] times 1.0, so it equals a copy of the row bitwise,
// and a row of zeros where the id matches no row.  The card has a gather
// (the paper's finding is that direct loads win there), so this kernel
// copies rows and does not rebuild the one-hot product.
//
// Design.  The copy is spread over the output's units, not over rows: a
// unit is 16 bytes where the row's bytes and both pointers allow it (D =
// 768 is 96 units a row in bf16, 192 in f32), else one element.  A block
// is 4 warps; warp threadIdx.y owns one row (blockIdx.y * 4 +
// threadIdx.y) and lane threadIdx.x the units x0 + lane + 32 k, k < U, of
// it, where x0 = blockIdx.x * 32 U: a grid over (row, unit) that needs no
// integer division.  A thread reads its row's id once (__ldg), issues
// its U loads into registers, then its U stores, so a launch keeps every
// load of a row in flight at once instead of walking a row in dependent
// steps.  The launcher picks U (4, 2 or 1) as the largest that still
// gives the card two blocks per SM, so a prompt of N = 512 rows fills
// all 132 SMs and a long batch moves 64 bytes per thread.  An id outside
// [0, V) reads nothing and writes zero bits (+0.0 in float32 and
// bfloat16).  Units are copied as raw bits, so the copy is bitwise in
// both dtypes.
//
// Bound: the bytes, N D itemsize read + N D itemsize written + N 8 bytes
// of ids, over 3.35 TB/s.  A decode tick (N = 4) moves 12 KB in bf16,
// far below a launch's fixed cost; a prompt of 8192 tokens 25 MB (7.5 us).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kRowsPerBlock = 4;    // warps per block, one row each
constexpr int kMaxGridY = 65535;
constexpr int kBlocksPerSM = 16;  // the backward's grid: resident blocks an SM

template <typename Unit, int U>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    gather_rows_kernel(const Unit* __restrict__ table,
                       const int64_t* __restrict__ ids,
                       Unit* __restrict__ out, long long n, long long V,
                       int units) {
  const int u0 = blockIdx.x * (32 * U) + threadIdx.x;
  for (long long row =
           static_cast<long long>(blockIdx.y) * kRowsPerBlock + threadIdx.y;
       row < n; row += static_cast<long long>(gridDim.y) * kRowsPerBlock) {
    const long long id = __ldg(ids + row);
    const bool ok = id >= 0 && id < V;
    const Unit* src = table + static_cast<size_t>(ok ? id : 0) * units;
    Unit* dst = out + static_cast<size_t>(row) * units;
    Unit v[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int u = u0 + 32 * k;
      v[k] = ok && u < units ? __ldg(src + u) : Unit{};
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int u = u0 + 32 * k;
      if (u < units) dst[u] = v[k];
    }
  }
}

template <typename Unit, int U>
void launch_u(const void* table, const void* ids, void* out, long long n,
              long long V, int units, const dim3& grid,
              cudaStream_t stream) {
  gather_rows_kernel<Unit, U><<<grid, dim3(32, kRowsPerBlock), 0, stream>>>(
      static_cast<const Unit*>(table), static_cast<const int64_t*>(ids),
      static_cast<Unit*>(out), n, V, units);
}

// The grid over (row, unit) for `units` units a row: the largest U of
// 4, 2, 1 whose grid still has two blocks on every SM (U = 1 where none
// has).
template <typename Unit>
int launch(const void* table, const void* ids, void* out, long long n,
           long long V, int units, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long row_blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  const dim3 base(1, static_cast<unsigned>(
                         std::min<long long>(row_blocks, kMaxGridY)));
  auto grid = [&](int u) {
    return dim3(static_cast<unsigned>((units + 32 * u - 1) / (32 * u)),
                base.y);
  };
  auto blocks = [&](int u) {
    return static_cast<long long>(grid(u).x) * row_blocks;
  };
  auto st = static_cast<cudaStream_t>(stream);
  if (blocks(4) >= 2LL * sms)
    launch_u<Unit, 4>(table, ids, out, n, V, units, grid(4), st);
  else if (blocks(2) >= 2LL * sms)
    launch_u<Unit, 2>(table, ids, out, n, V, units, grid(2), st);
  else
    launch_u<Unit, 1>(table, ids, out, n, V, units, grid(1), st);
  return static_cast<int>(cudaGetLastError());
}

template <typename Elem>
int launch_rows(const void* table, const void* ids, void* out, long long n,
                long long V, int D, int vec16, void* stream) {
  if (vec16)
    return launch<uint4>(table, ids, out, n, V,
                         static_cast<int>(D * sizeof(Elem) / 16), stream);
  return launch<Elem>(table, ids, out, n, V, D, stream);
}

// ---------------------------------------------------------------------
// The backward (kernel row 9b): d table = onehot(ids)^T d out, the
// gradient of the one-hot product the reference differentiates
// (repro/core/gather_ops.py::onehot_gather under jax.grad; the TPU
// kernel has no backward).  Row v of d table is the sum of the rows of
// d out whose id is v: zero where no id hits v, and ids outside [0, V)
// add to no row.  It sums in float32, in position order, and rounds once
// to the table's dtype (round to nearest even), as the reference's bf16
// oh^T g does.  Every row is written exactly once; there is no V x D
// float32 buffer (1.07 GB at chatglm3-6b's table) and there are no
// atomics: the sum's order, and so its bits, is fixed.
//
// Bound: the bytes.  The V D itemsize write of d table (a dense
// gradient), the N D itemsize read of d out and the ids; at 50304 x 768
// bf16 the write is 77 MB, 0.023 ms at 3.35 TB/s; at 65024 x 4096 bf16
// 533 MB, 0.16 ms.
//
// Design, N <= kBlockMaxN (every training batch the repo runs): two
// launches, no library sort and no search over V.
// 1. grad_sort_kernel, one block, sorts and compacts.  It zeroes a V-bit
//    hit map, loads the N ids, drops those outside [0, V) and packs each
//    into one 32-bit key, id << kPosBits | position (every vocabulary in
//    configs/ is under 2^18, and N <= 2^14), so a key sort is a stable
//    sort of the ids.  It sorts the keys in shared memory (bitonic, N
//    rounded up to a power of two; the stages of stride <= 32 in
//    registers, a warp a 64-key block), then writes the positions in
//    sorted order, each run's first sorted index and row, the count of
//    runs (hit rows) and the hit map.
// 2. grad_rows_kernel writes every row of d table once, launched as the
//    sort's programmatic dependent (its blocks are placed while the sort
//    runs; 1.1-1.2 us a call on the H100).  Its first blocks sum the
//    hit rows, a unit a thread (n D itemsize / 16 threads): the float32
//    sum of that unit of the run's rows of d out, in position order,
//    rounded once; every thread's loads are its own, so every hit row's
//    whole width is loaded at once.  They run before the zeros' stream
//    fills the memory system's queues: summed among the zeros, a hit
//    row's loads wait behind the writes (on the H100, 512 hit rows cost
//    3.2 us a MB of them so).  The other blocks each own a group of rows
//    within one hit-map word, the most (a power of two up to 32) that
//    fit kGroupBytes (16 KB: 8 rows at 768 bf16, 2 at 4096 bf16, 1 at
//    4096 f32; on the H100 8 and 32 KB time the same, 64 KB slower, and
//    one persistent block an SM striding over the groups 1-7 % slower),
//    and write zeros over its rows that no id hits with 16-byte stores
//    in address order, as a memset does, reading no per-row index.
// Bytes in flight: an SM must keep ~25 GB/s x ~1 us = 25 KB of stores
// moving to reach its share of the HBM write rate (3.35 TB/s / 132).  A
// zero block issues its 16 KB waiting on no load but the one hit-map
// word, several blocks sit on each SM, and blocks start in order, so the
// card writes one dense front of the table at a time.
//
// Above kBlockMaxN ids the launcher takes the sort path: it sorts the
// ids with torch.sort (stable); starts_kernel finds each row's run by a
// binary search (starts[v] = the first sorted position with id >= v, for
// v in [0, V]); gather_grad_kernel walks the rows, a warp a row, each
// lane U units of it, adding the run's rows in position order.

__global__ void starts_kernel(const int64_t* __restrict__ sorted,
                              int64_t* __restrict__ starts, long long n,
                              long long V) {
  const long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (v > V) return;
  long long lo = 0, hi = n;          // first position with sorted >= v
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (__ldg(sorted + mid) < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  starts[v] = lo;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

// float32 -> the table's dtype, rounding to nearest even (bfloat16 as
// PyTorch rounds it; NaN stays a quiet NaN).
__device__ __forceinline__ void narrow(float x, float* out) { *out = x; }
__device__ __forceinline__ void narrow(float x, uint16_t* out) {
  const uint32_t u = __float_as_uint(x);
  *out = (u & 0x7fffffffu) > 0x7f800000u
             ? static_cast<uint16_t>(0x7fc0u)
             : static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

template <typename Elem, int kVec, int U>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    gather_grad_kernel(const int64_t* __restrict__ starts,
                       const int64_t* __restrict__ perm,
                       const Elem* __restrict__ dout,
                       Elem* __restrict__ dtable, long long V, int D) {
  const int col0 = (blockIdx.x * 32 * U + threadIdx.x) * kVec;
  if (col0 >= D) return;
  for (long long v =
           static_cast<long long>(blockIdx.y) * kRowsPerBlock + threadIdx.y;
       v < V; v += static_cast<long long>(gridDim.y) * kRowsPerBlock) {
    const long long lo = __ldg(starts + v), hi = __ldg(starts + v + 1);
    float acc[U][kVec];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[u][e] = 0.0f;
    for (long long k = lo; k < hi; ++k) {
      const Elem* src = dout + static_cast<size_t>(__ldg(perm + k)) * D;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int col = col0 + 32 * kVec * u;
        if (col >= D) break;
        alignas(16) Elem x[kVec];
        if constexpr (kVec * sizeof(Elem) == 16) {
          *reinterpret_cast<uint4*>(x) =
              __ldg(reinterpret_cast<const uint4*>(src + col));
        } else {
#pragma unroll
          for (int e = 0; e < kVec; ++e) x[e] = src[col + e];
        }
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[u][e] += widen(x[e]);
      }
    }
    Elem* dst = dtable + static_cast<size_t>(v) * D;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int col = col0 + 32 * kVec * u;
      if (col >= D) break;
      alignas(16) Elem y[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) narrow(acc[u][e], &y[e]);
      if constexpr (kVec * sizeof(Elem) == 16) {
        *reinterpret_cast<uint4*>(dst + col) =
            *reinterpret_cast<const uint4*>(y);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) dst[col + e] = y[e];
      }
    }
  }
}

// kVec16 = 16 / sizeof(Elem) columns a lane where D * itemsize is a
// multiple of 16 and both pointers are 16-byte aligned, else one.
template <typename Elem>
int launch_grad(const void* sorted, const void* perm, const void* dout,
                void* starts, void* dtable, long long n, long long V, int D,
                int vec16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const long long sblocks = (V + 1 + 255) / 256;
  starts_kernel<<<static_cast<unsigned>(sblocks), 256, 0, st>>>(
      static_cast<const int64_t*>(sorted), static_cast<int64_t*>(starts), n,
      V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kVec16 = 16 / sizeof(Elem);
  int sms = 0, dev = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // U = 4 units a lane where a row has 128 or more (a warp then covers
  // 2 KB of it), else 1; the rows are walked by a grid of kBlocksPerSM
  // blocks an SM, not a block per four rows (whose launches would cost
  // more than their stores).
  const int vec = vec16 ? kVec16 : 1;
  const int units = (D + vec - 1) / vec;
  const int U = units >= 32 * 4 ? 4 : 1;
  const unsigned gx = static_cast<unsigned>((units + 32 * U - 1) / (32 * U));
  const long long row_blocks = (V + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long want = std::max<long long>(
      1, static_cast<long long>(kBlocksPerSM) * sms / gx);
  const dim3 grid(gx, static_cast<unsigned>(std::min<long long>(
                          std::min(row_blocks, want), kMaxGridY)));
  const dim3 block(32, kRowsPerBlock);
  const auto* s = static_cast<const int64_t*>(starts);
  const auto* p = static_cast<const int64_t*>(perm);
  const auto* g = static_cast<const Elem*>(dout);
  auto* out = static_cast<Elem*>(dtable);
  if (vec16 && U == 4)
    gather_grad_kernel<Elem, kVec16, 4><<<grid, block, 0, st>>>(s, p, g, out,
                                                                V, D);
  else if (vec16)
    gather_grad_kernel<Elem, kVec16, 1><<<grid, block, 0, st>>>(s, p, g, out,
                                                                V, D);
  else if (U == 4)
    gather_grad_kernel<Elem, 1, 4><<<grid, block, 0, st>>>(s, p, g, out, V,
                                                           D);
  else
    gather_grad_kernel<Elem, 1, 1><<<grid, block, 0, st>>>(s, p, g, out, V,
                                                           D);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kPosBits = 14;                     // a key's position bits
constexpr uint32_t kPosMask = (1u << kPosBits) - 1u;
constexpr long long kBlockMaxN = 1LL << kPosBits;
constexpr uint32_t kNoKey = 0xffffffffu;          // an id outside [0, V)
constexpr int kSortThreads = 1024;
constexpr int kSortMinThreads = 256;
constexpr int kWriterWarps = 8;
constexpr long long kGroupBytes = 16384;          // a zero group's

// One compare-exchange of a bitonic stage of stride < 32 within a warp:
// key x at index i against its partner at i ^ stride (lane ^ stride);
// the pair's lower index keeps the smaller key where the pair sorts up
// ((i & size) == 0), the larger where it sorts down.
__device__ __forceinline__ uint32_t exchange(uint32_t x, int i, int stride,
                                             int size) {
  const uint32_t y = __shfl_xor_sync(0xffffffffu, x, stride);
  return (((i & stride) == 0) == ((i & size) == 0)) ? min(x, y) : max(x, y);
}

// keys and run ids in dynamic shared memory, p2 each (N rounded up to a
// power of two, at least 64; E = max(1, p2 / blockDim.x) keys a thread,
// none for the threads past p2).
// Writes hitmap[V / 32 words], head[run] (its first sorted index; head[H]
// = the count of ids in range), pos[sorted index], run_row[run] (its
// row) and n_runs[0] = H.
__global__ void __launch_bounds__(kSortThreads)
    grad_sort_kernel(const int64_t* __restrict__ ids, long long n,
                     long long V, int p2, uint32_t* __restrict__ hitmap,
                     int* __restrict__ head, int* __restrict__ pos,
                     int* __restrict__ run_row, int* __restrict__ runs) {
  // The row writer may be placed on the other SMs now; it waits for
  // this grid's results before it reads them.
  asm volatile("griddepcontrol.launch_dependents;\n");
  extern __shared__ uint32_t sm[];
  uint32_t* keys = sm;
  uint32_t* run_id = sm + p2;
  __shared__ int warp_sum[32];
  __shared__ int n_runs;
  const int T = blockDim.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  // The ids' loads go out first, then the hit map's zeroing.
  constexpr int kMaxE = kBlockMaxN / kSortThreads;
  const int E = max(1, p2 / T);                // keys a thread
  long long id[kMaxE];
#pragma unroll
  for (int e = 0; e < kMaxE; ++e) {
    const int k = t + e * T;
    id[e] = e < E && k < n ? ids[k] : -1;
  }
  const long long words = (V + 31) / 32;
  for (long long wd = t; wd < words; wd += T) hitmap[wd] = 0u;
  int n_in = 0;                               // ids in [0, V)
#pragma unroll
  for (int e = 0; e < kMaxE; ++e) {
    if (e < E) {
      const int k = t + e * T;
      const bool in = id[e] >= 0 && id[e] < V;
      if (k < p2)
        keys[k] = in ? static_cast<uint32_t>(id[e]) << kPosBits |
                           static_cast<uint32_t>(k)
                     : kNoKey;
      n_in += __syncthreads_count(in);
    }
  }
  // Bitonic sort, ascending.  The stages of stride >= 64 work on shared
  // memory, a block barrier each; those of stride <= 32 of each size run
  // in registers, a warp a 64-key block (a lane its keys i and i + 32),
  // through shuffles, with one barrier after them.
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride >= 64; stride >>= 1) {
      for (int q = t; q < (p2 >> 1); q += T) {
        const int lo = ((q & ~(stride - 1)) << 1) | (q & (stride - 1));
        const int hi = lo + stride;
        const uint32_t a = keys[lo], c = keys[hi];
        if ((a > c) == ((lo & size) == 0)) {
          keys[lo] = c;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
    for (int blk = warp; blk < (p2 >> 6); blk += T >> 5) {
      const int i0 = (blk << 6) + lane, i1 = i0 + 32;
      uint32_t x0 = keys[i0], x1 = keys[i1];
      for (int stride = min(size >> 1, 32); stride > 0; stride >>= 1) {
        if (stride == 32) {
          if ((x0 > x1) == ((i0 & size) == 0)) {
            const uint32_t y = x0;
            x0 = x1;
            x1 = y;
          }
        } else {
          x0 = exchange(x0, i0, stride, size);
          x1 = exchange(x1, i1, stride, size);
        }
      }
      keys[i0] = x0;
      keys[i1] = x1;
    }
    __syncthreads();
  }
  // Runs: a sorted index whose id differs from the one before starts
  // one.  Thread t owns sorted indices [t E, t E + E).
  const int k0 = t * E;
  int count = 0;
  for (int e = 0; e < E; ++e) {
    const int k = k0 + e;
    count += k < n_in &&
             (k == 0 || (keys[k] >> kPosBits) != (keys[k - 1] >> kPosBits));
  }
  int incl = count;                           // block-wide exclusive scan
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int x = lane < (T >> 5) ? warp_sum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    warp_sum[lane] = x;
  }
  __syncthreads();
  int run = incl - count + (warp > 0 ? warp_sum[warp - 1] : 0);
  if (t == T - 1) n_runs = run + count;
  for (int e = 0; e < E; ++e) {
    const int k = k0 + e;
    if (k >= n_in) break;
    const uint32_t key = keys[k];
    pos[k] = static_cast<int>(key & kPosMask);
    if (k == 0 || (key >> kPosBits) != (keys[k - 1] >> kPosBits)) {
      head[run] = k;
      run_id[run] = key >> kPosBits;
      run_row[run] = static_cast<int>(key >> kPosBits);
      ++run;
    }
  }
  __syncthreads();
  const int H = n_runs;
  if (t == 0) {
    head[H] = n_in;
    runs[0] = H;
  }
  // Each word's first run sets the word's bits from its runs' rows.
  for (int h = t; h < H; h += T) {
    const uint32_t wd = run_id[h] >> 5;
    if (h > 0 && (run_id[h - 1] >> 5) == wd) continue;
    uint32_t bits = 0u;
    for (int h2 = h; h2 < H && (run_id[h2] >> 5) == wd; ++h2)
      bits |= 1u << (run_id[h2] & 31u);
    hitmap[wd] = bits;
  }
}

// Unit: 16 bytes (uint4) where the launcher allows it, else one Elem.
// Unit x = h units + col of the runs' rows: the float32 sum of unit col
// of the rows of d out at run h's positions, in position order, rounded
// once, into unit col of run h's row.
template <typename Elem, typename Unit>
__device__ __forceinline__ void write_run_unit(
    long long x, const int* __restrict__ head, const int* __restrict__ pos,
    const int* __restrict__ run_row, const Unit* __restrict__ dout,
    Unit* __restrict__ dtable, int units) {
  constexpr int kVec = sizeof(Unit) / sizeof(Elem);
  const int h = static_cast<int>(x / units);
  const int col = static_cast<int>(x - static_cast<long long>(h) * units);
  const int lo = __ldg(head + h), hi = __ldg(head + h + 1);
  float acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.0f;
#pragma unroll 4
  for (int k = lo; k < hi; ++k) {
    alignas(sizeof(Unit)) Elem el[kVec];
    *reinterpret_cast<Unit*>(el) =
        __ldg(dout + static_cast<size_t>(__ldg(pos + k)) * units + col);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] += widen(el[e]);
  }
  alignas(sizeof(Unit)) Elem y[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) narrow(acc[e], &y[e]);
  dtable[static_cast<size_t>(__ldg(run_row + h)) * units + col] =
      *reinterpret_cast<const Unit*>(y);
}

// Group g is rows [g 2^rows_log2, (g + 1) 2^rows_log2) (2^rows_log2 <=
// 32: within one hit-map word): the block writes zeros over its rows
// that no id hits, in address order, as a memset writes.
template <typename Unit>
__device__ __forceinline__ void write_zeros(long long g,
                                            const uint32_t* __restrict__ hitmap,
                                            Unit* __restrict__ dtable,
                                            long long V, int units,
                                            int rows_log2) {
  const long long v0 = g << rows_log2;
  const long long left = V - v0;
  const int rows = left < (1LL << rows_log2) ? static_cast<int>(left)
                                             : 1 << rows_log2;
  const int shift = static_cast<int>(v0 & 31);
  const uint32_t word = __ldg(hitmap + (v0 >> 5));
  const uint32_t mine =
      rows_log2 == 5 ? word : (word >> shift) & ((1u << (1 << rows_log2)) - 1u);
  Unit* base = dtable + static_cast<size_t>(v0) * units;
  const int total = rows * units;
  if (mine == 0u) {
#pragma unroll 4
    for (int u = threadIdx.x; u < total; u += 32 * kWriterWarps)
      base[u] = Unit{};
    return;
  }
  for (int u = threadIdx.x; u < total; u += 32 * kWriterWarps)
    if (!((mine >> (u / units)) & 1u)) base[u] = Unit{};
}

// Launched as the sort kernel's programmatic dependent: its blocks are
// placed while the sort runs and wait for its results here.  The first
// run_blocks blocks sum the hit rows, a unit a thread (they start first,
// before the zeros' stream fills the memory system's queues: a hit
// row's loads then take a round trip, not a wait behind the writes);
// the others write the groups' zeros, block b group b - run_blocks.
template <typename Elem, typename Unit>
__global__ void __launch_bounds__(32 * kWriterWarps)
    grad_rows_kernel(const uint32_t* __restrict__ hitmap,
                     const int* __restrict__ head,
                     const int* __restrict__ pos,
                     const int* __restrict__ run_row,
                     const int* __restrict__ runs,
                     const Unit* __restrict__ dout, Unit* __restrict__ dtable,
                     long long V, int units, int rows_log2,
                     int run_blocks) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (static_cast<int>(blockIdx.x) < run_blocks) {
    const long long x =
        static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (x < static_cast<long long>(__ldg(runs)) * units)
      write_run_unit<Elem, Unit>(x, head, pos, run_row, dout, dtable, units);
    return;
  }
  write_zeros<Unit>(blockIdx.x - run_blocks, hitmap, dtable, V, units,
                    rows_log2);
}

// The scratch, int32: hitmap (V / 32 words, rounded up), head (n + 1),
// pos (n), run_row (n), runs (1).
template <typename Elem>
int launch_grad_block(const void* ids, const void* dout, void* scratch,
                      void* dtable, long long n, long long V, int D,
                      int vec16, void* stream) {
  if (n > kBlockMaxN || V > (1LL << (32 - kPosBits)) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  int p2 = 64;
  while (p2 < n) p2 <<= 1;
  // At least kSortMinThreads, so that zeroing the hit map is short.
  const int threads = std::max(kSortMinThreads, std::min(kSortThreads,
                                                         p2 / 2));
  const int smem = 2 * p2 * static_cast<int>(sizeof(uint32_t));
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(grad_sort_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long words = (V + 31) / 32;
  auto* hitmap = static_cast<uint32_t*>(scratch);
  int* head = reinterpret_cast<int*>(hitmap + words);
  int* pos = head + n + 1;
  int* run_row = pos + n;
  int* runs = run_row + n;
  grad_sort_kernel<<<1, threads, smem, st>>>(
      static_cast<const int64_t*>(ids), n, V, p2, hitmap, head, pos, run_row,
      runs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // Rows a zero group: the most (a power of two, at most a word's 32)
  // whose bytes fit kGroupBytes.  Run blocks: a thread for each unit of
  // the n rows at most hit.
  const long long row_bytes = static_cast<long long>(D) * sizeof(Elem);
  int rows_log2 = 0;
  while (rows_log2 < 5 && (row_bytes << (rows_log2 + 1)) <= kGroupBytes)
    ++rows_log2;
  const int units = vec16 ? static_cast<int>(row_bytes / 16) : D;
  const int run_blocks = static_cast<int>(
      (n * units + 32 * kWriterWarps - 1) / (32 * kWriterWarps));
  const long long blocks = run_blocks + ((V - 1) >> rows_log2) + 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(32 * kWriterWarps);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (vec16)
    err = cudaLaunchKernelEx(
        &cfg, grad_rows_kernel<Elem, uint4>,
        static_cast<const uint32_t*>(hitmap), static_cast<const int*>(head),
        static_cast<const int*>(pos), static_cast<const int*>(run_row),
        static_cast<const int*>(runs), static_cast<const uint4*>(dout),
        static_cast<uint4*>(dtable), V, units, rows_log2, run_blocks);
  else
    err = cudaLaunchKernelEx(
        &cfg, grad_rows_kernel<Elem, Elem>,
        static_cast<const uint32_t*>(hitmap), static_cast<const int*>(head),
        static_cast<const int*>(pos), static_cast<const int*>(run_row),
        static_cast<const int*>(runs), static_cast<const Elem*>(dout),
        static_cast<Elem*>(dtable), V, units, rows_log2, run_blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes.  table: (V, D); ids: (n,)
// int64; out: (n, D) in the table's dtype; all contiguous on the device
// of `stream`.  vec16 = 1 only when D * itemsize is a multiple of 16 and
// table and out are 16-byte aligned (the launcher checks).  Launch on
// `stream`, neither synchronise nor allocate, return a cudaError_t value.
extern "C" int onehot_gather_f32_launch(const void* table, const void* ids,
                                        void* out, long long n, long long V,
                                        int D, int vec16, void* stream) {
  return launch_rows<uint32_t>(table, ids, out, n, V, D, vec16, stream);
}

extern "C" int onehot_gather_bf16_launch(const void* table, const void* ids,
                                         void* out, long long n, long long V,
                                         int D, int vec16, void* stream) {
  return launch_rows<uint16_t>(table, ids, out, n, V, D, vec16, stream);
}

// The backward's entry points.  sorted, perm: (n,) int64, the flat ids
// sorted stably and the positions they came from (torch.sort); dout:
// (n, D) in the table's dtype; starts: (V + 1,) int64 scratch; dtable:
// (V, D) out.  vec16 = 1 only when D * itemsize is a multiple of 16 and
// dout and dtable are 16-byte aligned (the launcher checks).  Two
// launches in order on `stream`; return a cudaError_t value.
extern "C" int onehot_gather_grad_f32_launch(const void* sorted,
                                             const void* perm,
                                             const void* dout, void* starts,
                                             void* dtable, long long n,
                                             long long V, int D, int vec16,
                                             void* stream) {
  return launch_grad<float>(sorted, perm, dout, starts, dtable, n, V, D,
                            vec16, stream);
}

extern "C" int onehot_gather_grad_bf16_launch(const void* sorted,
                                              const void* perm,
                                              const void* dout, void* starts,
                                              void* dtable, long long n,
                                              long long V, int D, int vec16,
                                              void* stream) {
  return launch_grad<uint16_t>(sorted, perm, dout, starts, dtable, n, V, D,
                               vec16, stream);
}

// The one-block path (n <= 2^14 ids, V <= 2^18 - 1: no id in range
// packs to kNoKey).  ids: (n,) int64;
// dout: (n, D) in the table's dtype; scratch: ceil(V / 32) + 3 n + 2
// int32; dtable: (V, D) out.  vec16 as above.  Two launches in order on
// `stream`; return a cudaError_t value.
extern "C" int onehot_gather_grad_block_f32_launch(
    const void* ids, const void* dout, void* scratch, void* dtable,
    long long n, long long V, int D, int vec16, void* stream) {
  return launch_grad_block<float>(ids, dout, scratch, dtable, n, V, D,
                                  vec16, stream);
}

extern "C" int onehot_gather_grad_block_bf16_launch(
    const void* ids, const void* dout, void* scratch, void* dtable,
    long long n, long long V, int D, int vec16, void* stream) {
  return launch_grad_block<uint16_t>(ids, dout, scratch, dtable, n, V, D,
                                     vec16, stream);
}
