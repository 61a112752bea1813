// Arithmetic shared by the back-projection kernels (backproject.cu and
// backproject_strip.cu).  Every float operation is an explicit
// round-to-nearest intrinsic in the order of the plain PyTorch version
// (repro_torch/kernels/backproject_ref.py), so no multiply and add
// contract into an FMA and every kernel agrees with its plain version
// bitwise.  Build without --use_fast_math: 1 / w must stay an IEEE
// division.
#pragma once

#include <cuda_runtime.h>

namespace bp {

constexpr float kEpsW = 1e-6f;

__device__ __forceinline__ float dot_row(const float* a, float wx, float wy,
                                         float wz) {
  // ((wx a0 + wy a1) + wz a2) + a3, each product and sum rounded.
  float t = __fadd_rn(__fmul_rn(wx, a[0]), __fmul_rn(wy, a[1]));
  t = __fadd_rn(t, __fmul_rn(wz, a[2]));
  return __fadd_rn(t, a[3]);
}

__device__ __forceinline__ float world(int i, float O, float MM) {
  return __fadd_rn(O, __fmul_rn(static_cast<float>(i), MM));
}

__device__ __forceinline__ bool inside(int i, int n) {
  return i >= 0 && i < n;
}

// The reciprocal trick: r = w > eps ? 1 / w : 0.
__device__ __forceinline__ float recip_w(float w) {
  return w > kEpsW ? __fdiv_rn(1.0f, w) : 0.0f;
}

// acc + bilinear(bl, br, tl, tr; sx, sy) * r^2, the plain version's
// order: ((1 - sx) bl + sx br) and the same for the top row, blended
// with (1 - sy) and sy.
__device__ __forceinline__ float fold_taps(float acc, float bl, float br,
                                           float tl, float tr, float sx,
                                           float sy, float r) {
  const float ox = __fsub_rn(1.0f, sx);
  const float valb = __fadd_rn(__fmul_rn(ox, bl), __fmul_rn(sx, br));
  const float valt = __fadd_rn(__fmul_rn(ox, tl), __fmul_rn(sx, tr));
  const float val = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, sy), valb),
                              __fmul_rn(sy, valt));
  return __fadd_rn(acc, __fmul_rn(val, __fmul_rn(r, r)));
}

}  // namespace bp
