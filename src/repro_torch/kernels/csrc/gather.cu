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
