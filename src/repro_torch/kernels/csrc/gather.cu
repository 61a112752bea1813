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
// Design.  One warp owns one output row: its 32 lanes copy the row with
// 16-byte vector loads and stores when the row's bytes and both pointers
// allow it (D = 768 is 1536 bytes a row in bf16, 3072 in f32), else one
// element a lane at a time.  An id outside [0, V) writes zeros and reads
// nothing.  Instances for float32 and bfloat16 tables; ids are int64.
//
// Bound: the bytes, N D itemsize read + N D itemsize written + N 8 bytes
// of ids, over 3.35 TB/s.  A decode tick (N = 4) moves 12 KB in bf16,
// far below a launch's fixed cost; a prompt of 8192 tokens 25 MB (7.5 us).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void onehot_gather_kernel(const T* __restrict__ table,
                                     const int64_t* __restrict__ ids,
                                     T* __restrict__ out, long long n,
                                     long long V, int D, int vec16) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const long long id = __ldg(ids + row);
  const bool ok = id >= 0 && id < V;
  T* dst = out + static_cast<size_t>(row) * D;
  if (vec16) {
    const int nv = static_cast<int>(D * sizeof(T) / 16);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    if (ok) {
      const uint4* s4 = reinterpret_cast<const uint4*>(
          table + static_cast<size_t>(id) * D);
      for (int k = lane; k < nv; k += 32) d4[k] = __ldg(s4 + k);
    } else {
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      for (int k = lane; k < nv; k += 32) d4[k] = zero;
    }
  } else {
    if (ok) {
      const T* src = table + static_cast<size_t>(id) * D;
      for (int k = lane; k < D; k += 32) dst[k] = src[k];
    } else {
      // Zero bits: +0.0 in both float32 and bfloat16.
      unsigned char* bytes = reinterpret_cast<unsigned char*>(dst);
      const int nb = static_cast<int>(D * sizeof(T));
      for (int k = lane; k < nb; k += 32) bytes[k] = 0;
    }
  }
}

template <typename T>
int launch(const void* table, const void* ids, void* out, long long n,
           long long V, int D, int vec16, void* stream) {
  const long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  onehot_gather_kernel<T><<<static_cast<unsigned>(blocks),
                            32 * kWarpsPerBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int64_t*>(ids),
      static_cast<T*>(out), n, V, D, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes.  table: (V, D); ids: (n,)
// int64; out: (n, D) in the table's dtype; all contiguous on the device
// of `stream`.  vec16 = 1 only when D * itemsize is a multiple of 16 and
// table and out are 16-byte aligned (the launcher checks).  Launch on
// `stream`, neither synchronise nor allocate, return cudaGetLastError().
extern "C" int onehot_gather_f32_launch(const void* table, const void* ids,
                                        void* out, long long n, long long V,
                                        int D, int vec16, void* stream) {
  return launch<float>(table, ids, out, n, V, D, vec16, stream);
}

extern "C" int onehot_gather_bf16_launch(const void* table, const void* ids,
                                         void* out, long long n, long long V,
                                         int D, int vec16, void* stream) {
  return launch<__nv_bfloat16>(table, ids, out, n, V, D, vec16, stream);
}
