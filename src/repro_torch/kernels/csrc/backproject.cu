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
// has no gather.  A GPU has one, so each thread reads its taps straight
// from the zero-bordered image (a tap outside the padded buffer reads
// 0, which with the 1-pixel zero border is exactly the zero-outside
// rule, so no strip planner is needed) and keeps its voxels in
// registers while the P projections of the launch fold into them: the
// volume is read once and written once per launch (DESIGN.md §7).  The
// P x 12 matrices are staged in shared memory by the block.
//
// The kernel is issue-bound: at L = 512 a P = 4 launch folds 537 M
// (voxel, projection) pairs, and its bytes take 0.33 ms.  So the design
// cuts the instructions each pair costs:
//   * a thread folds a run of kRun voxels along z at fixed (x, y), the
//     warp along x so the volume stays coalesced.  Per projection it
//     computes wx a0 + wy a1 of each 3x4 row once, so a voxel's u, v, w
//     cost ((t + wz a2) + a3) each: no shared-memory load and 9
//     operations where three whole dot rows took 12 loads and 18;
//   * the IEEE reciprocal 1 / w is taken for every voxel and dropped
//     where w <= 1e-6 (bp::recip_w_select): no branch around it;
//   * a tap's floor and its index are one conversion each
//     (bp::tap_index), with no range clamp: an index past the image
//     saturates or wraps to one the quad test refuses.  (Magic-number
//     adds with a clamp keep the conversion pipe free but cost more
//     issue slots, and timed slower.);
//   * one unsigned test admits the whole 2x2 quad, whose four loads then
//     need no checks, at 32-bit offsets from a per-projection base;
//     the per-tap tests run only when that test fails (taps at the
//     image's edge or off it);
//   * on the int8 wire a tap row's scale and offset are read once per
//     tap row, from the same per-projection base.
// The voxels of a run keep the plain version's order: each starts from
// its volume value and adds p = 0 .. P-1 in turn.  A last run shorter
// than kRun folds its last plane again and does not store the copies.
//
// The wire.  The kernel is a template over a tap loader, one instance
// per projection wire, each with a plain C entry point:
//   f32   the zero-bordered float32 images;
//   bf16  the same in bfloat16, widened to float32 exactly;
//   int8  per-row affine codes (repro_torch/quant.py) with a (P, 2, rows)
//         float32 block, [p][0] = scale, [p][1] = offset: a tap decodes
//         in registers as code * scale[row] + offset[row], two rounded
//         steps.
// Only the tap values differ between the instances; the arithmetic
// around them is the same.  Taps outside the buffer read exactly 0 on
// every wire (the decoded border of a non-zero int8 row is not 0, as
// in the reference).
//
// Every float operation is written with explicit round-to-nearest
// intrinsics in the order of the plain PyTorch version
// (backproject_common.cuh), so the kernel's taps and weights agree
// bitwise with repro_torch/kernels/backproject_ref.py.  A tap index
// that saturated or wrapped lies outside the image with its neighbour,
// so its quad reads four zeros and adds +0, as the plain version does.
//
// Bound per launch: the larger of FLOPs / 67 TFLOP/s (FP32 outside the
// tensor cores) and bytes / 3.35 TB/s (volume read + written once,
// each image read once).  At L = 512 both are near 0.3 ms for P = 4;
// a narrower wire cuts only the image bytes, which are small beside
// the 1.07 GB volume pass, and int8 adds 2 FLOPs per tap.  What the
// card reaches is set by the instructions issued per pair, counted
// from the SASS in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "backproject_common.cuh"

namespace {

using bp::inside;

// Voxels one thread folds along z, and the block: a warp along x.
constexpr int kRun = 8;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// Tap loaders.  view(p) gives projection p's base; row() reads taps
// (r, c) and (r, c + 1), each 0 outside the (rows, cols) padded buffer;
// quad() reads the 2x2 quad at (r, c) when all four taps lie inside,
// from the unsigned offsets o = r cols + c and o1 = o + cols.  Offsets
// are unsigned and wrap before they meet the pointer, so a tap index
// off the image never overflows and the tap beside one at c = -1 is
// read at its own offset.
struct F32Taps {
  const float* __restrict__ imgs;
  using View = const float*;
  __device__ __forceinline__ View view(int p, int rows, int cols) const {
    return imgs + static_cast<size_t>(p) * rows * cols;
  }
  __device__ __forceinline__ void row(View v, int r, int c, int rows,
                                      int cols, float& a, float& b) const {
    const bool ok = inside(r, rows);
    const unsigned o = static_cast<unsigned>(r) * cols + c;
    a = ok && inside(c, cols) ? __ldg(v + o) : 0.0f;
    b = ok && inside(c + 1, cols) ? __ldg(v + (o + 1u)) : 0.0f;
  }
  __device__ __forceinline__ void quad(View v, unsigned o, unsigned o1, int,
                                       float& bl, float& br, float& tl,
                                       float& tr) const {
    bl = __ldg(v + o);
    br = __ldg(v + o + 1);
    tl = __ldg(v + o1);
    tr = __ldg(v + o1 + 1);
  }
};

struct Bf16Taps {
  const unsigned short* __restrict__ imgs;   // bfloat16 bit patterns
  using View = const unsigned short*;
  __device__ __forceinline__ static float at(View q) {
    return __bfloat162float(__ushort_as_bfloat16(__ldg(q)));
  }
  __device__ __forceinline__ View view(int p, int rows, int cols) const {
    return imgs + static_cast<size_t>(p) * rows * cols;
  }
  __device__ __forceinline__ void row(View v, int r, int c, int rows,
                                      int cols, float& a, float& b) const {
    const bool ok = inside(r, rows);
    const unsigned o = static_cast<unsigned>(r) * cols + c;
    a = ok && inside(c, cols) ? at(v + o) : 0.0f;
    b = ok && inside(c + 1, cols) ? at(v + (o + 1u)) : 0.0f;
  }
  __device__ __forceinline__ void quad(View v, unsigned o, unsigned o1, int,
                                       float& bl, float& br, float& tl,
                                       float& tr) const {
    bl = at(v + o);
    br = at(v + o + 1);
    tl = at(v + o1);
    tr = at(v + o1 + 1);
  }
};

struct Int8Taps {
  const int8_t* __restrict__ codes;
  const float* __restrict__ scales;          // (P, 2, rows)
  struct View {
    const int8_t* codes;
    const float* scale;
    const float* offset;
  };
  __device__ __forceinline__ static float decode(const int8_t* q, float s,
                                                 float o) {
    return __fadd_rn(__fmul_rn(static_cast<float>(__ldg(q)), s), o);
  }
  __device__ __forceinline__ View view(int p, int rows, int cols) const {
    const float* s = scales + static_cast<size_t>(p) * 2 * rows;
    return {codes + static_cast<size_t>(p) * rows * cols, s, s + rows};
  }
  __device__ __forceinline__ void row(const View& v, int r, int c, int rows,
                                      int cols, float& a, float& b) const {
    a = b = 0.0f;
    if (!inside(r, rows)) return;
    const float s = __ldg(v.scale + r);
    const float o = __ldg(v.offset + r);
    const unsigned q = static_cast<unsigned>(r) * cols + c;
    if (inside(c, cols)) a = decode(v.codes + q, s, o);
    if (inside(c + 1, cols)) b = decode(v.codes + (q + 1u), s, o);
  }
  __device__ __forceinline__ void quad(const View& v, unsigned o,
                                       unsigned o1, int r, float& bl,
                                       float& br, float& tl,
                                       float& tr) const {
    const float* s = v.scale + static_cast<unsigned>(r);
    const float* f = v.offset + static_cast<unsigned>(r);
    const float s0 = __ldg(s), s1 = __ldg(s + 1);
    const float f0 = __ldg(f), f1 = __ldg(f + 1);
    bl = decode(v.codes + o, s0, f0);
    br = decode(v.codes + o + 1, s0, f0);
    tl = decode(v.codes + o1, s1, f1);
    tr = decode(v.codes + o1 + 1, s1, f1);
  }
};

// The four taps of the quad at padded (r, c): one unsigned test admits
// the whole quad, and only a quad at or past the buffer's edge pays the
// per-tap tests.
template <typename Taps>
__device__ __forceinline__ void quad_taps(const Taps& taps,
                                          const typename Taps::View& v,
                                          int r, int c, int rows, int cols,
                                          unsigned rlim, unsigned clim,
                                          float& bl, float& br, float& tl,
                                          float& tr) {
  if (static_cast<unsigned>(r) <= rlim && static_cast<unsigned>(c) <= clim) {
    const unsigned o = static_cast<unsigned>(r) * cols + c;
    taps.quad(v, o, o + cols, r, bl, br, tl, tr);
  } else {
    taps.row(v, r, c, rows, cols, bl, br);
    taps.row(v, r + 1, c, rows, cols, tl, tr);
  }
}

template <typename Taps>
__global__ void __launch_bounds__(kBlockX * kBlockY)
backproject_batch_kernel(float* __restrict__ vol, const Taps taps,
                         const float* __restrict__ mats, int P, int L,
                         int nz, int z0, int rows, int cols, float O,
                         float MM) {
  extern __shared__ float4 smats[];          // P x 3 rows of 4
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  float* flat = reinterpret_cast<float*>(smats);
  for (int i = tid; i < P * 12; i += kBlockX * kBlockY) flat[i] = mats[i];
  __syncthreads();

  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= L || y >= L) return;
  const int zr = blockIdx.z * kRun;          // the run's first slab plane
  const float wx = bp::world(x, O, MM);
  const float wy = bp::world(y, O, MM);
  const size_t plane = static_cast<size_t>(L) * L;
  float* const column = vol + static_cast<size_t>(y) * L + x;

  float wz[kRun], acc[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int zi = min(zr + j, nz - 1);
    wz[j] = bp::world(z0 + zi, O, MM);
    acc[j] = column[zi * plane];
  }

  // A quad lies inside when r <= rlim and c <= clim.
  const unsigned rlim = rows - 2, clim = cols - 2;
  for (int p = 0; p < P; ++p) {
    const float4 au = smats[3 * p], av = smats[3 * p + 1],
                 aw = smats[3 * p + 2];
    const float tu = bp::dot_xy(au.x, au.y, wx, wy);
    const float tv = bp::dot_xy(av.x, av.y, wx, wy);
    const float tw = bp::dot_xy(aw.x, aw.y, wx, wy);
    const typename Taps::View view = taps.view(p, rows, cols);
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const float u = bp::dot_z(tu, au.z, au.w, wz[j]);
      const float v = bp::dot_z(tv, av.z, av.w, wz[j]);
      const float r = bp::recip_w_select(bp::dot_z(tw, aw.z, aw.w, wz[j]));
      const float ix = __fmul_rn(u, r);
      const float iy = __fmul_rn(v, r);
      const int c = bp::tap_index(ix), rr = bp::tap_index(iy);
      const float sx = __fsub_rn(ix, floorf(ix));
      const float sy = __fsub_rn(iy, floorf(iy));
      float bl, br, tl, tr;
      quad_taps(taps, view, rr, c, rows, cols, rlim, clim, bl, br, tl, tr);
      acc[j] = bp::fold_taps(acc[j], bl, br, tl, tr, sx, sy, r);
    }
  }
#pragma unroll
  for (int j = 0; j < kRun; ++j)
    if (zr + j < nz) column[(zr + j) * plane] = acc[j];
}

template <typename Taps>
int launch(void* vol, const Taps& taps, const void* mats, int P, int L,
           int nz, int z0, int rows, int cols, float O, float MM,
           void* stream) {
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid((L + kBlockX - 1) / kBlockX, (L + kBlockY - 1) / kBlockY,
                  (nz + kRun - 1) / kRun);
  const size_t smem = static_cast<size_t>(P) * 12 * sizeof(float);
  backproject_batch_kernel<Taps><<<grid, block, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(vol), taps, static_cast<const float*>(mats), P,
      L, nz, z0, rows, cols, O, MM);
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
