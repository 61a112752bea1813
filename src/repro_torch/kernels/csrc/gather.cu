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
// add to no row.  It sums in float32 and rounds once to the table's
// dtype (round to nearest even), as the reference's bf16 oh^T g does.
//
// Design.  The wrapper sorts the flat ids once (torch.sort, stable), so
// the positions of each id form one run of `sorted`, in position order.
// starts_kernel finds each row's run by a binary search (starts[v] =
// the first sorted position with id >= v, for v in [0, V]).  Then a
// grid over (row, column unit), as the forward's: warp threadIdx.y owns
// a row of d table at a time, each lane U units of 16 bytes (or of one
// element) of it; it adds the run's rows of d out in position order, in
// float32, and writes its units once.  Every row is written
// exactly once, and no V x D float32 buffer is needed (1.07 GB at
// chatglm3-6b's table), nor atomics: the sum's order, and so its bits,
// is fixed.
//
// Bound: the bytes.  The V D itemsize write of d table (a dense
// gradient), the N D itemsize read of d out and the ids; at 65024 x
// 4096 bf16 the write alone is 533 MB, 0.16 ms at 3.35 TB/s.

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
