// Batched cone-beam back projection for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/backproject.py::
// backproject_kernel_batch (and ::backproject_kernel, which is this
// kernel launched with P = 1), and the int8/bf16 projection wire of
// every variant, ::_dequant_strip.  It computes, for every voxel of a
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
// The wire.  The kernel is a template over a tap loader, one instance
// per projection wire, each with a plain C entry point:
//   f32   the zero-bordered float32 images;
//   bf16  the same in bfloat16, widened to float32 exactly;
//   int8  per-row affine codes (repro_torch/quant.py) with a (P, 2, rows)
//         float32 block, [p][0] = scale, [p][1] = offset: a tap decodes
//         in registers as code * scale[row] + offset[row], two rounded
//         steps, with the row's scale and offset read once per tap row.
// Only the tap values differ between the instances; the arithmetic
// around them is the same.  Taps outside the buffer read exactly 0 on
// every wire (the decoded border of a non-zero int8 row is not 0, as
// in the reference).
//
// Every float operation is written with explicit round-to-nearest
// intrinsics in the order of the plain PyTorch version
// (backproject_common.cuh), so the kernel's taps and weights agree
// bitwise with repro_torch/kernels/backproject_ref.py.
//
// Bound per launch: the larger of FLOPs / 67 TFLOP/s (FP32 outside the
// tensor cores) and bytes / 3.35 TB/s (volume read + written once,
// each image read once).  At L = 512 both are near 0.3 ms for P = 4;
// a narrower wire cuts only the image bytes, which are small beside
// the 1.07 GB volume pass, and int8 adds 2 FLOPs per tap.  The gathers
// and the instruction count make the kernel slower than that bound; a
// later design stages each block's image footprint in shared memory
// with TMA and picks pbatch so the volume traffic is amortised further.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "backproject_common.cuh"

namespace {

using bp::inside;

// Tap loaders: taps (r, c) and (r, c + 1) of projection p, 0 outside
// the (rows, cols) padded buffer.
struct F32Taps {
  const float* __restrict__ imgs;
  __device__ __forceinline__ void row(int p, int r, int c, int rows,
                                      int cols, float& a, float& b) const {
    const float* img = imgs + static_cast<size_t>(p) * rows * cols;
    const bool ok = inside(r, rows);
    a = ok && inside(c, cols)
            ? __ldg(img + static_cast<size_t>(r) * cols + c) : 0.0f;
    b = ok && inside(c + 1, cols)
            ? __ldg(img + static_cast<size_t>(r) * cols + c + 1) : 0.0f;
  }
};

struct Bf16Taps {
  const unsigned short* __restrict__ imgs;   // bfloat16 bit patterns
  __device__ __forceinline__ float at(size_t i) const {
    return __bfloat162float(__ushort_as_bfloat16(__ldg(imgs + i)));
  }
  __device__ __forceinline__ void row(int p, int r, int c, int rows,
                                      int cols, float& a, float& b) const {
    const size_t base = (static_cast<size_t>(p) * rows + r) * cols;
    const bool ok = inside(r, rows);
    a = ok && inside(c, cols) ? at(base + c) : 0.0f;
    b = ok && inside(c + 1, cols) ? at(base + c + 1) : 0.0f;
  }
};

struct Int8Taps {
  const int8_t* __restrict__ codes;
  const float* __restrict__ scales;          // (P, 2, rows)
  __device__ __forceinline__ void row(int p, int r, int c, int rows,
                                      int cols, float& a, float& b) const {
    a = b = 0.0f;
    if (!inside(r, rows)) return;
    const float s = __ldg(scales + (static_cast<size_t>(p) * 2) * rows + r);
    const float o =
        __ldg(scales + (static_cast<size_t>(p) * 2 + 1) * rows + r);
    const int8_t* line = codes + (static_cast<size_t>(p) * rows + r) * cols;
    if (inside(c, cols))
      a = __fadd_rn(__fmul_rn(static_cast<float>(__ldg(line + c)), s), o);
    if (inside(c + 1, cols))
      b = __fadd_rn(__fmul_rn(static_cast<float>(__ldg(line + c + 1)), s),
                    o);
  }
};

template <typename Taps>
__global__ void backproject_batch_kernel(float* __restrict__ vol,
                                         const Taps taps,
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

  const float wx = bp::world(x, O, MM);
  const float wy = bp::world(y, O, MM);
  const float wz = bp::world(z0 + zi, O, MM);

  const size_t vidx = (static_cast<size_t>(zi) * L + y) * L + x;
  float acc = vol[vidx];

  for (int p = 0; p < P; ++p) {
    const float* A = smats + p * 12;
    const float u = bp::dot_row(A, wx, wy, wz);
    const float v = bp::dot_row(A + 4, wx, wy, wz);
    const float w = bp::dot_row(A + 8, wx, wy, wz);
    const float r = bp::recip_w(w);
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

    float bl, br, tl, tr;
    taps.row(p, rr, c, rows, cols, bl, br);
    taps.row(p, rr + 1, c, rows, cols, tl, tr);
    acc = bp::fold_taps(acc, bl, br, tl, tr, sx, sy, r);
  }
  vol[vidx] = acc;
}

template <typename Taps>
int launch(void* vol, const Taps& taps, const void* mats, int P, int L,
           int nz, int z0, int rows, int cols, float O, float MM,
           void* stream) {
  const dim3 block(128, 4, 1);
  const dim3 grid((L + block.x - 1) / block.x, (L + block.y - 1) / block.y,
                  nz);
  const size_t smem = static_cast<size_t>(P) * 12 * sizeof(float);
  backproject_batch_kernel<Taps><<<grid, block, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(vol), taps, static_cast<const float*>(mats), P,
      L, z0, rows, cols, O, MM);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, bound with ctypes.  vol: (nz, L, L) f32;
// imgs: (P, rows, cols) zero-bordered, in the entry's wire type;
// mats: (P, 3, 4) f32; scales (int8 only): (P, 2, rows) f32; all
// contiguous and on the device of `stream`.  Each launches on `stream`,
// neither synchronises nor allocates, and returns cudaGetLastError().
extern "C" int backproject_batch_launch(void* vol, const void* imgs,
                                        const void* mats, int P, int L,
                                        int nz, int z0, int rows, int cols,
                                        float O, float MM, void* stream) {
  return launch(vol, F32Taps{static_cast<const float*>(imgs)}, mats, P, L,
                nz, z0, rows, cols, O, MM, stream);
}

extern "C" int backproject_batch_bf16_launch(void* vol, const void* imgs,
                                             const void* mats, int P, int L,
                                             int nz, int z0, int rows,
                                             int cols, float O, float MM,
                                             void* stream) {
  return launch(vol, Bf16Taps{static_cast<const unsigned short*>(imgs)},
                mats, P, L, nz, z0, rows, cols, O, MM, stream);
}

extern "C" int backproject_batch_int8_launch(void* vol, const void* codes,
                                             const void* scales,
                                             const void* mats, int P, int L,
                                             int nz, int z0, int rows,
                                             int cols, float O, float MM,
                                             void* stream) {
  return launch(vol,
                Int8Taps{static_cast<const int8_t*>(codes),
                         static_cast<const float*>(scales)},
                mats, P, L, nz, z0, rows, cols, O, MM, stream);
}
