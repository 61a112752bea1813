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

// dot_row split where z enters: the partial sum wx a0 + wy a1, which a
// thread folding a run of voxels along z computes once per projection,
// and from it ((t + wz a2) + a3), the same rounded steps as dot_row.
__device__ __forceinline__ float dot_xy(float a0, float a1, float wx,
                                        float wy) {
  return __fadd_rn(__fmul_rn(wx, a0), __fmul_rn(wy, a1));
}

__device__ __forceinline__ float dot_z(float t, float a2, float a3,
                                       float wz) {
  return __fadd_rn(__fadd_rn(t, __fmul_rn(wz, a2)), a3);
}

// The padded tap index floor(v) + 1, one conversion (rounding down);
// a v past the int range saturates and the + 1 wraps (unsigned), so
// the index of a tap far off the image stays off it.
__device__ __forceinline__ int tap_index(float v) {
  return static_cast<int>(static_cast<unsigned>(__float2int_rd(v)) + 1u);
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

// recip_w's value with no branch around the division: 1 / w is taken
// for every w and dropped where w <= eps.
__device__ __forceinline__ float recip_w_select(float w) {
  const float r = __fdiv_rn(1.0f, w);
  return w > kEpsW ? r : 0.0f;
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
