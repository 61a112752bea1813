// Batched cone-beam back projection for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/backproject.py::
// backproject_kernel_batch (and ::backproject_kernel, which is this
// kernel launched with P = 1).  It computes, for every voxel of a
// (nz, L, L) volume slab whose first global plane is z0,
//
//     vol[z, y, x] += sum_p bilinear(img_p, ix_p, iy_p) * (1 / w_p)^2
//
// with Listing-1 semantics: floor taps, zero outside the detector, and
// the reciprocal trick r = w > 1e-6 ? 1 / w : 0, ix = u r, iy = v r.
//
// Design.  The TPU kernel moved a (band, width) strip into VMEM with a
// DMA and selected the four taps with a one-hot matmul, because a TPU
// has no gather.  A GPU has one, so here each thread owns one voxel
// (x fastest, so volume reads and writes coalesce), reads the four taps
// straight from the zero-bordered image, and keeps the voxel in a
// register while the P projections of the launch fold into it: the
// volume is read once and written once per launch (DESIGN.md §7).  The
// P x 12 matrices are staged in shared memory by the block.  A tap
// outside the padded buffer reads 0, which with the 1-pixel zero border
// is exactly the zero-outside rule, so no strip planner is needed.
//
// Every float operation is written with explicit round-to-nearest
// intrinsics in the order of the plain PyTorch version, so no multiply
// and add contract into an FMA: the kernel's taps and weights agree
// bitwise with repro_torch/kernels/backproject_ref.py.  Build without
// --use_fast_math: 1 / w must stay an IEEE division.
//
// Bound per launch: the larger of FLOPs / 67 TFLOP/s (FP32 outside the
// tensor cores) and bytes / 3.35 TB/s (volume read + written once,
// each image read once).  At L = 512 both are near 0.3 ms for P = 4.
// The gathers make the kernel latency-bound well above that; a later
// design stages each block's image footprint in shared memory with TMA
// and picks pbatch so the volume traffic is amortised further.

#include <cuda_runtime.h>

namespace {

constexpr float kEpsW = 1e-6f;

__device__ __forceinline__ float dot_row(const float* a, float wx, float wy,
                                         float wz) {
  // ((wx a0 + wy a1) + wz a2) + a3, each product and sum rounded.
  float t = __fadd_rn(__fmul_rn(wx, a[0]), __fmul_rn(wy, a[1]));
  t = __fadd_rn(t, __fmul_rn(wz, a[2]));
  return __fadd_rn(t, a[3]);
}

__device__ __forceinline__ float tap(const float* img, int r, int c,
                                     int rows, int cols) {
  return (r >= 0 && r < rows && c >= 0 && c < cols)
             ? __ldg(img + static_cast<size_t>(r) * cols + c)
             : 0.0f;
}

__global__ void backproject_batch_kernel(float* __restrict__ vol,
                                         const float* __restrict__ imgs,
                                         const float* __restrict__ mats,
                                         int P, int L, int z0, int rows,
                                         int cols, float O, float MM) {
  extern __shared__ float smats[];
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < P * 12; i += nthreads) smats[i] = mats[i];
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int zi = blockIdx.z;
  if (x >= L || y >= L) return;

  const float wx = __fadd_rn(O, __fmul_rn(static_cast<float>(x), MM));
  const float wy = __fadd_rn(O, __fmul_rn(static_cast<float>(y), MM));
  const float wz = __fadd_rn(O, __fmul_rn(static_cast<float>(z0 + zi), MM));

  const size_t vidx = (static_cast<size_t>(zi) * L + y) * L + x;
  float acc = vol[vidx];
  const size_t img_stride = static_cast<size_t>(rows) * cols;

  for (int p = 0; p < P; ++p) {
    const float* A = smats + p * 12;
    const float u = dot_row(A, wx, wy, wz);
    const float v = dot_row(A + 4, wx, wy, wz);
    const float w = dot_row(A + 8, wx, wy, wz);
    const float r = w > kEpsW ? __fdiv_rn(1.0f, w) : 0.0f;
    const float ix = __fmul_rn(u, r);
    const float iy = __fmul_rn(v, r);

    const float fx = floorf(ix);
    const float fy = floorf(iy);
    const float sx = __fsub_rn(ix, fx);
    const float sy = __fsub_rn(iy, fy);
    // Padded tap coordinates (+1 for the zero border).  Floors far off
    // the buffer map to -2 before the int conversion; all their taps
    // then read 0, as they would unclamped.
    const int c = (fx >= -2.0f && fx <= static_cast<float>(cols))
                      ? static_cast<int>(fx) + 1 : -2;
    const int rr = (fy >= -2.0f && fy <= static_cast<float>(rows))
                       ? static_cast<int>(fy) + 1 : -2;

    const float* img = imgs + p * img_stride;
    const float bl = tap(img, rr, c, rows, cols);
    const float br = tap(img, rr, c + 1, rows, cols);
    const float tl = tap(img, rr + 1, c, rows, cols);
    const float tr = tap(img, rr + 1, c + 1, rows, cols);

    const float ox = __fsub_rn(1.0f, sx);
    const float valb = __fadd_rn(__fmul_rn(ox, bl), __fmul_rn(sx, br));
    const float valt = __fadd_rn(__fmul_rn(ox, tl), __fmul_rn(sx, tr));
    const float val = __fadd_rn(__fmul_rn(__fsub_rn(1.0f, sy), valb),
                                __fmul_rn(sy, valt));
    acc = __fadd_rn(acc, __fmul_rn(val, __fmul_rn(r, r)));
  }
  vol[vidx] = acc;
}

}  // namespace

// Plain C entry point, bound with ctypes.  vol: (nz, L, L) f32;
// imgs: (P, rows, cols) f32 zero-bordered; mats: (P, 3, 4) f32; all
// contiguous and on the device of `stream`.  Launches on `stream`,
// neither synchronises nor allocates, and returns cudaGetLastError().
extern "C" int backproject_batch_launch(void* vol, const void* imgs,
                                        const void* mats, int P, int L,
                                        int nz, int z0, int rows, int cols,
                                        float O, float MM, void* stream) {
  const dim3 block(128, 4, 1);
  const dim3 grid((L + block.x - 1) / block.x, (L + block.y - 1) / block.y,
                  nz);
  const size_t smem = static_cast<size_t>(P) * 12 * sizeof(float);
  backproject_batch_kernel<<<grid, block, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(vol), static_cast<const float*>(imgs),
      static_cast<const float*>(mats), P, L, z0, rows, cols, O, MM);
  return static_cast<int>(cudaGetLastError());
}
