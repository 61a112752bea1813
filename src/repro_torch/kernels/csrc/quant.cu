// Per-row int8 error-feedback encoder for Hopper (sm_90a).
//
// Encodes a (P, rows, cols) float32 stack of padded projections into
// int8 codes on a per-row affine grid plus a (P, 2, rows) float32 block
// ([p][0] = scale, [p][1] = offset), the int8 projection wire that
// backproject.cu decodes.  It replaces, on the card, the lax.scan of
// repro/quant.py::quantize_rows (which has no Pallas kernel) and
// computes exactly what repro_torch/quant.py::quantize_rows_ref does:
//
//   lo = min(min(row), 0), hi = max(max(row), 0)
//   scale = max(hi - lo, 1e-30) / 254,  offset = lo + 127 scale
//   (symmetric: scale = max(max|row|, 1e-30) / 127, offset = 0)
//   err = 0; for each column c, left to right:
//     xp = x[c] + err
//     q = clamp(rint((xp - offset) / scale), -127, 127)
//     err = xp - (q scale + offset)
//
// Design.  One thread owns one (p, row): pass 1 finds the row's range,
// pass 2 runs the error-feedback chain along the columns.  Every float
// operation is an explicit round-to-nearest intrinsic in the plain
// version's order (no FMA contraction, an IEEE division, rintf rounding
// half to even as torch.round does), so codes, scales and offsets equal
// the plain version bitwise.
//
// Bound: the bytes, P rows cols (4 read + 1 written) + P rows 8, over
// 3.35 TB/s (about 7 us for a full-width P = 4 batch).  With one thread
// per row a P = 4 batch has 3848 threads, under 2 % of the card's
// resident threads, each running a dependent chain of `cols` steps
// whose loads are strided by a row across the warp: the kernel is
// latency-bound far above that.  A later design splits pass 1 across a
// warp and stages column tiles in shared memory.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kEpsScale = 1e-30f;

__global__ void quantize_rows_kernel(const float* __restrict__ x,
                                     int8_t* __restrict__ codes,
                                     float* __restrict__ scales,
                                     int n_rows, int rows, int cols,
                                     int symmetric) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  const int p = i / rows;
  const int r = i - p * rows;
  const float* row = x + static_cast<size_t>(i) * cols;
  int8_t* out = codes + static_cast<size_t>(i) * cols;

  float scale, offset;
  if (symmetric) {
    float amax = 0.0f;
    for (int c = 0; c < cols; ++c) amax = fmaxf(amax, fabsf(__ldg(row + c)));
    scale = __fdiv_rn(fmaxf(amax, kEpsScale), 127.0f);
    offset = 0.0f;
  } else {
    float lo = 0.0f, hi = 0.0f;
    for (int c = 0; c < cols; ++c) {
      const float v = __ldg(row + c);
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
    scale = __fdiv_rn(fmaxf(__fsub_rn(hi, lo), kEpsScale), 254.0f);
    offset = __fadd_rn(lo, __fmul_rn(127.0f, scale));
  }

  float err = 0.0f;
  for (int c = 0; c < cols; ++c) {
    const float xp = __fadd_rn(__ldg(row + c), err);
    float q = rintf(__fdiv_rn(__fsub_rn(xp, offset), scale));
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    out[c] = static_cast<int8_t>(q);
    err = __fsub_rn(xp, __fadd_rn(__fmul_rn(q, scale), offset));
  }
  scales[(static_cast<size_t>(p) * 2) * rows + r] = scale;
  scales[(static_cast<size_t>(p) * 2 + 1) * rows + r] = offset;
}

}  // namespace

// Plain C entry point, bound with ctypes.  x: (P, rows, cols) f32;
// codes: (P, rows, cols) int8; scales: (P, 2, rows) f32; all contiguous
// and on the device of `stream`.  Launches on `stream`, neither
// synchronises nor allocates, and returns cudaGetLastError().
extern "C" int quantize_rows_launch(const void* x, void* codes,
                                    void* scales, int P, int rows, int cols,
                                    int symmetric, void* stream) {
  const int n_rows = P * rows;
  const int block = 128;
  const int grid = (n_rows + block - 1) / block;
  quantize_rows_kernel<<<grid, block, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(codes),
      static_cast<float*>(scales), n_rows, rows, cols, symmetric);
  return static_cast<int>(cudaGetLastError());
}
