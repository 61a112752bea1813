// Strip-staged cone-beam back projection for Hopper (sm_90a): the
// kernels K3 strip_db, K4 strip_micro and K5 strip_shared.
//
// They replace the TPU kernels of repro/kernels/backproject.py that read
// their taps from a detector window staged in fast memory:
//   K3 strip_db      ::backproject_kernel_batch_db (:594), and at P = 1
//                    ::backproject_kernel_db (:376);
//   K4 strip_micro   ::backproject_kernel_batch_micro (:714, with
//                    ::_micro_tile_accumulate :253), and at P = 1
//                    ::backproject_kernel_micro (:319);
//   K5 strip_shared  ::backproject_kernel_batch_shared (:758).
// Each computes, like backproject.cu, for every voxel of a (nz, L, L)
// slab whose first global plane is z0,
//
//     vol[z, y, x] += sum_p bilinear(img_p, ix_p, iy_p) * (1 / w_p)^2,
//
// except that a tap reads its value from shared memory, and reads 0 when
// it lies outside its window.  The windows are
// the reference's (repro_torch/kernels/backproject_ref.py, module
// docstring): per (ty, chunk) voxel tile of one z-plane and per
// projection a (band, width) strip at the corner-based origin (K3, K4);
// inside it a (gband, gwidth) micro window per run of `group` x-voxels
// (K4); or one (band, width) window per projection of the launch, all at
// the minimum of the launch's corner origins (K5).  The wrapper checks
// every window against the strip planner first, so no tap is dropped.
//
// Design.  A block owns one tile at a time, one thread per voxel (x
// fastest), and keeps the voxel in a register while the P projections
// fold into it.  The staged data keeps the wire's type (float32, bfloat16
// or int8 codes); an int8 code decodes in registers with the scale and
// offset of its global padded row.  The arithmetic is backproject.cu's
// (backproject_common.cuh), so each kernel equals its plain version
// bitwise on every wire, and row 1 too where the windows cover every tap.
//   K3: persistent blocks walk the global (tile, projection) sequence
//       t = step * P + p of their tiles through a `depth`-slot ring,
//       `depth - 1` fetches ahead across tile boundaries (cp.async with
//       commit_group / wait_group).  At P = 1 the prefetch crosses
//       tiles, which is what gives it meaning there.
//   K4: one tile per block through a 2-slot ring; each run of `group`
//       lanes finds its micro window with __reduce_min_sync (a group
//       that does not divide the warp reduces through shared memory).
//   K3 and K4 stage per (tile, projection) item only the box of taps
//   the tile's voxels read, cut to the item's window and to the image,
//   not the whole window.  On a z-plane u/w and v/w are linear-
//   fractional in (x, y), so where w > 0 on the tile (w is affine: at
//   its four corners) their extremes lie at the four corner voxels: the
//   box is rows [floor(min iy) + 1, floor(max iy) + 3) and the same for
//   the columns, widened by kBoxMargin on each side against the float32
//   rounding of the voxels' own coordinates.  A tile with a corner at
//   w <= 1e-6 stages its whole window.  Four lanes of each warp evaluate
//   the four corners and reduce by shuffles, once per item; thread 0
//   keeps the item (window origin, box) in shared memory beside its
//   slot.  Rows arrive re-pitched to whole 16-byte units (pitch_stack),
//   and a box row is staged from the 16-byte unit holding its first
//   element, one cp.async.cg of 16 bytes per unit, so every copy lies
//   inside the stack.  A slot holds the largest box of the launch's
//   matrices (repro_torch/core/clipping.py::strip_box_slots); a box
//   larger than its slot is cut and counted in `clamps`, which the
//   caller requires to stay 0.  A tap reads its value only inside the
//   box (and, in K4, the micro window): the box lies inside the window
//   and the image, and nothing outside it was staged for this item.
//   K5: one (P, band, width) slab per tile, loaded once, a 4-byte word
//       per cp.async; all P projections fold from it.  The slab may
//       exceed 48 KB: the launcher opts in up to the card's 227 KB and
//       refuses more.
//
// Bound: the same work as backproject.cu, so the same bound (the volume
// read and written once, each image read once, and the FP32 operations).
// The staged boxes and windows move more bytes through L2 and shared
// memory than the direct gather of row 1 reads.  With boxes in place of
// windows K3 and K4 no longer scale with the bytes staged: each item
// costs two block barriers, the corner box and its copies on top of the
// fold, so their time goes with the items (tiles x P), as PERF.md shows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "backproject_common.cuh"

namespace {

// Tap coordinates are clamped to +-2^20 before the int conversion: every
// comparison with a window or the image keeps its outcome.
constexpr float kTapClamp = 1048576.0f;

// Pixels added on each side of a tile's corner tap box against the
// float32 rounding of its voxels' own coordinates (the same margin as
// repro_torch/core/clipping.py::_BOX_MARGIN).
constexpr int kBoxMargin = 1;

// --------------------------------------------------------------------
// Wires: how a staged element becomes a float.
// --------------------------------------------------------------------
struct F32Wire {
  static constexpr int kBytes = 4;
  __device__ __forceinline__ float2 row_affine(int, int) const {
    return make_float2(0.0f, 0.0f);
  }
  __device__ __forceinline__ float decode(const unsigned char* at,
                                          float2) const {
    return *reinterpret_cast<const float*>(at);
  }
};

struct Bf16Wire {
  static constexpr int kBytes = 2;
  __device__ __forceinline__ float2 row_affine(int, int) const {
    return make_float2(0.0f, 0.0f);
  }
  __device__ __forceinline__ float decode(const unsigned char* at,
                                          float2) const {
    return __bfloat162float(
        __ushort_as_bfloat16(*reinterpret_cast<const unsigned short*>(at)));
  }
};

struct Int8Wire {
  static constexpr int kBytes = 1;
  const float* __restrict__ scales;   // (P, 2, rows): scale, offset
  int rows;
  __device__ __forceinline__ float2 row_affine(int p, int r) const {
    return make_float2(
        __ldg(scales + (static_cast<size_t>(p) * 2) * rows + r),
        __ldg(scales + (static_cast<size_t>(p) * 2 + 1) * rows + r));
  }
  __device__ __forceinline__ float decode(const unsigned char* at,
                                          float2 so) const {
    const float code = static_cast<float>(*reinterpret_cast<const int8_t*>(at));
    return __fadd_rn(__fmul_rn(code, so.x), so.y);
  }
};

// --------------------------------------------------------------------
// cp.async
// --------------------------------------------------------------------
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

// 16 bytes, L2 only; source and destination 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// wait_group takes an immediate: dispatch the ring's depth - 1.
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// --------------------------------------------------------------------
// Geometry of a launch
// --------------------------------------------------------------------
struct Geo {
  float O, MM;
  int L, z0, n_u, n_v;
  int rows, cols, pitch_words;   // the bordered image, its row in words
};

struct Tiling {
  int ty, chunk, band, width;
  int pad_rows, pad_cols;        // the reference's rounded-up image
  int sw;                        // K5: staged words per window row
  int group, gband, gwidth;      // K4 only
  int slot_rows, slot_units;     // K3, K4: a slot's rows, 16-byte units
};

// Corner k of a (ty, chunk) tile (bit 0: last column, bit 1: last row):
// its tap coordinates clipped into the bordered detector, and whether
// w <= eps there (then 1/w reads 0, as everywhere).
__device__ __forceinline__ void corner_tap(const float* A, float wz, int y0,
                                           int x0, int k, const Geo& g,
                                           const Tiling& t, float& ix,
                                           float& iy, bool& flat) {
  const float wy = bp::world(y0 + ((k & 2) ? t.ty - 1 : 0), g.O, g.MM);
  const float wx = bp::world(x0 + ((k & 1) ? t.chunk - 1 : 0), g.O, g.MM);
  const float w = bp::dot_row(A + 8, wx, wy, wz);
  const float r = bp::recip_w(w);
  flat = !(w > bp::kEpsW);
  ix = fminf(fmaxf(__fmul_rn(bp::dot_row(A, wx, wy, wz), r), -1.0f),
             static_cast<float>(g.n_u));
  iy = fminf(fmaxf(__fmul_rn(bp::dot_row(A + 4, wx, wy, wz), r), -1.0f),
             static_cast<float>(g.n_v));
}

// The window origin of a (ty, chunk) tile from its four corner voxels
// (the reference's _strip_origin): the floor of the least clipped tap
// coordinate, clamped so the window ends inside the padded image.
__device__ __forceinline__ int2 window_origin(float rlo, float clo,
                                              const Tiling& t) {
  return make_int2(
      min(max(static_cast<int>(floorf(rlo)), 0), t.pad_rows - t.band),
      min(max(static_cast<int>(floorf(clo)), 0), t.pad_cols - t.width));
}

__device__ __forceinline__ int2 corner_origin(const float* A, float wz,
                                              int y0, int x0,
                                              const Geo& g,
                                              const Tiling& t) {
  float rlo = 0.0f, clo = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float ix, iy;
    bool flat;
    corner_tap(A, wz, y0, x0, k, g, t, ix, iy, flat);
    clo = k ? fminf(clo, ix) : ix;
    rlo = k ? fminf(rlo, iy) : iy;
  }
  return window_origin(rlo, clo, t);
}

// The extent of the clipped tap coordinates over a tile's four corners.
struct CornerSpan {
  float rlo, rhi, clo, chi;
  bool flat;   // some corner at w <= eps
};

// Every thread of a warp gets its tile's span.  With `lanes4` (the warp's
// live lanes, `mask`, come in whole fours) each lane evaluates corner
// lane & 3 and each four lanes reduce by shuffles; else each thread
// evaluates all four.  min and max do not depend on the order.
__device__ __forceinline__ CornerSpan corner_span(const float* A, float wz,
                                                  int y0, int x0,
                                                  const Geo& g,
                                                  const Tiling& t,
                                                  unsigned mask,
                                                  bool lanes4) {
  CornerSpan sp;
  float ix, iy;
  bool flat;
  if (lanes4) {
    corner_tap(A, wz, y0, x0, threadIdx.x & 3, g, t, ix, iy, flat);
    sp = CornerSpan{iy, iy, ix, ix, flat};
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      sp.rlo = fminf(sp.rlo, __shfl_xor_sync(mask, sp.rlo, o));
      sp.rhi = fmaxf(sp.rhi, __shfl_xor_sync(mask, sp.rhi, o));
      sp.clo = fminf(sp.clo, __shfl_xor_sync(mask, sp.clo, o));
      sp.chi = fmaxf(sp.chi, __shfl_xor_sync(mask, sp.chi, o));
      sp.flat = __shfl_xor_sync(mask, static_cast<int>(sp.flat), o) ||
                sp.flat;
    }
    return sp;
  }
  for (int k = 0; k < 4; ++k) {
    corner_tap(A, wz, y0, x0, k, g, t, ix, iy, flat);
    sp.rlo = k ? fminf(sp.rlo, iy) : iy;
    sp.rhi = k ? fmaxf(sp.rhi, iy) : iy;
    sp.clo = k ? fminf(sp.clo, ix) : ix;
    sp.chi = k ? fmaxf(sp.chi, ix) : ix;
    sp.flat = k ? (sp.flat || flat) : flat;
  }
  return sp;
}

// One (tile, projection) item of K3/K4: its window origin (r0, c0) and
// the box it stages, rows [br0, br1) x columns [bc0, bc1) in padded
// coordinates; a box row is staged as `nu` 16-byte units from unit u0
// of its image row.  An empty box has br1 = br0, bc1 = bc0, nu = 0.
struct Item {
  int r0, c0, br0, br1, bc0, bc1, u0, nu;
};

// The item of a tile's corner span: its window, and the box of its taps
// (repro_torch/core/clipping.py::corner_boxes, the same integer rule)
// cut to the window, the image and the slot.  Returns whether the slot
// cut it.
template <int kBytes>
__device__ __forceinline__ bool make_item(const CornerSpan& sp,
                                          const Geo& g, const Tiling& t,
                                          Item& it) {
  const int2 o = window_origin(sp.rlo, sp.clo, t);
  it.r0 = o.x;
  it.c0 = o.y;
  int br0 = o.x, br1 = o.x + t.band, bc0 = o.y, bc1 = o.y + t.width;
  if (!sp.flat) {
    br0 = max(br0, static_cast<int>(floorf(sp.rlo)) + 1 - kBoxMargin);
    br1 = min(br1, static_cast<int>(floorf(sp.rhi)) + 3 + kBoxMargin);
    bc0 = max(bc0, static_cast<int>(floorf(sp.clo)) + 1 - kBoxMargin);
    bc1 = min(bc1, static_cast<int>(floorf(sp.chi)) + 3 + kBoxMargin);
  }
  br1 = min(br1, g.rows);
  bc1 = min(bc1, g.cols);
  it.u0 = (bc0 * kBytes) >> 4;
  it.nu = ((bc1 * kBytes + 15) >> 4) - it.u0;
  if (br1 <= br0 || bc1 <= bc0) {
    br1 = br0;
    bc1 = bc0;
    it.nu = 0;
  }
  bool cut = false;
  if (br1 - br0 > t.slot_rows) {
    br1 = br0 + t.slot_rows;
    cut = true;
  }
  if (it.nu > t.slot_units) {
    it.nu = t.slot_units;
    bc1 = min(bc1, ((it.u0 + it.nu) << 4) / kBytes);
    cut = true;
  }
  it.br0 = br0;
  it.br1 = br1;
  it.bc0 = bc0;
  it.bc1 = bc1;
  return cut;
}

// Copy an item's box of projection p into `dst` (rows of t.slot_units
// 16-byte units), cooperatively, without waiting.  The box lies in the
// image and its units in the 16-byte pitch, so every copy is whole.
__device__ __forceinline__ void stage_box(unsigned char* dst,
                                          const unsigned char* __restrict__ stack,
                                          int p, const Item& it,
                                          const Geo& g, const Tiling& t,
                                          int tid, int nthreads) {
  const int rows = it.br1 - it.br0;
  if (rows <= 0 || it.nu <= 0) return;
  const size_t pitch = static_cast<size_t>(g.pitch_words) * 4;
  const unsigned char* src =
      stack + (static_cast<size_t>(p) * g.rows + it.br0) * pitch +
      static_cast<size_t>(it.u0) * 16;
  const int row_bytes = t.slot_units * 16;
  if (it.nu <= nthreads) {
    // Each thread keeps one unit u and walks rows r, r + step, ...
    const int step = nthreads / it.nu;
    const int r0 = tid / it.nu;
    const int u = tid - r0 * it.nu;
    if (r0 >= step) return;
    for (int r = r0; r < rows; r += step)
      cp_async16(dst + r * row_bytes + u * 16, src + r * pitch + u * 16);
    return;
  }
  for (int r = 0; r < rows; ++r)
    for (int u = tid; u < it.nu; u += nthreads)
      cp_async16(dst + r * row_bytes + u * 16, src + r * pitch + u * 16);
}

// Copy the (band, width) window at (r0, c0) of projection p into `dst`
// (band rows of t.sw words), cooperatively, without waiting.
template <class Wire>
__device__ __forceinline__ void stage(uint32_t* dst,
                                      const uint32_t* __restrict__ stack,
                                      int p, int r0, int c0, const Geo& g,
                                      const Tiling& t, int tid,
                                      int nthreads) {
  const int wlo = (c0 * Wire::kBytes) >> 2;
  const int n = t.band * t.sw;
  for (int i = tid; i < n; i += nthreads) {
    const int br = i / t.sw;
    const int r = r0 + br;
    const int gw = wlo + (i - br * t.sw);
    const bool ok = r < g.rows && gw < g.pitch_words;
    const uint32_t* src =
        ok ? stack + (static_cast<size_t>(p) * g.rows + r) * g.pitch_words +
                 gw
           : stack;
    cp_async4(dst + i, src, ok ? 4 : 0);
  }
}

// K5's staged window: rows [r0, r0 + band) of projection p, each row
// starting at word (c0 * bytes) / 4 of the image row.
struct Staged {
  const uint32_t* base;
  int r0, wlo;
};

// Taps (rq, cq) and (rq, cq + 1) of projection p: 0 outside the image
// and outside [rlo, rhi) x [clo, chi).
template <class Wire>
__device__ __forceinline__ void tap_row(const Wire& wire, const Staged& s,
                                        const Geo& g, const Tiling& t,
                                        int p, int rq, int cq, int rlo,
                                        int rhi, int clo, int chi, float& a,
                                        float& b) {
  a = b = 0.0f;
  if (rq < rlo || rq >= rhi || !bp::inside(rq, g.rows)) return;
  const float2 so = wire.row_affine(p, rq);
  const unsigned char* row = reinterpret_cast<const unsigned char*>(
      s.base + (rq - s.r0) * t.sw);
  const int off = -4 * s.wlo;
  if (cq >= clo && cq < chi && bp::inside(cq, g.cols))
    a = wire.decode(row + cq * Wire::kBytes + off, so);
  if (cq + 1 >= clo && cq + 1 < chi && bp::inside(cq + 1, g.cols))
    b = wire.decode(row + (cq + 1) * Wire::kBytes + off, so);
}

struct VoxelTap {
  float sx, sy, r;
  int rr, c;   // padded coordinates of the lower-left tap
};

__device__ __forceinline__ VoxelTap voxel_tap(const float* A, float wx,
                                              float wy, float wz) {
  const float u = bp::dot_row(A, wx, wy, wz);
  const float v = bp::dot_row(A + 4, wx, wy, wz);
  const float r = bp::recip_w(bp::dot_row(A + 8, wx, wy, wz));
  const float ix = __fmul_rn(u, r);
  const float iy = __fmul_rn(v, r);
  const float fx = floorf(ix);
  const float fy = floorf(iy);
  VoxelTap vt;
  vt.sx = __fsub_rn(ix, fx);
  vt.sy = __fsub_rn(iy, fy);
  vt.r = r;
  vt.c = static_cast<int>(fminf(fmaxf(fx, -kTapClamp), kTapClamp)) + 1;
  vt.rr = static_cast<int>(fminf(fmaxf(fy, -kTapClamp), kTapClamp)) + 1;
  return vt;
}

template <class Wire>
__device__ __forceinline__ float fold(float acc, const Wire& wire,
                                      const Staged& s, const Geo& g,
                                      const Tiling& t, int p,
                                      const VoxelTap& vt, int rlo, int rhi,
                                      int clo, int chi) {
  float bl, br, tl, tr;
  tap_row(wire, s, g, t, p, vt.rr, vt.c, rlo, rhi, clo, chi, bl, br);
  tap_row(wire, s, g, t, p, vt.rr + 1, vt.c, rlo, rhi, clo, chi, tl, tr);
  return bp::fold_taps(acc, bl, br, tl, tr, vt.sx, vt.sy, vt.r);
}

// A staged box (K3, K4): row br0 at `base`, rows `row_bytes` apart, the
// row's first staged byte at byte `off` of its image row.
struct BoxView {
  const unsigned char* base;
  int br0, off, row_bytes;
};

// Taps (rq, cq) and (rq, cq + 1) of projection p from a staged box: 0
// outside [rlo, rhi) x [clo, chi), which lies inside the box.
template <class Wire>
__device__ __forceinline__ void tap_box(const Wire& wire, const BoxView& s,
                                        int p, int rq, int cq, int rlo,
                                        int rhi, int clo, int chi, float& a,
                                        float& b) {
  a = b = 0.0f;
  if (rq < rlo || rq >= rhi) return;
  const float2 so = wire.row_affine(p, rq);
  const unsigned char* row = s.base + (rq - s.br0) * s.row_bytes;
  const int at = cq * Wire::kBytes - s.off;
  if (cq >= clo && cq < chi) a = wire.decode(row + at, so);
  if (cq + 1 >= clo && cq + 1 < chi)
    b = wire.decode(row + at + Wire::kBytes, so);
}

template <class Wire>
__device__ __forceinline__ float fold_box(float acc, const Wire& wire,
                                          const BoxView& s, int p,
                                          const VoxelTap& vt, int rlo,
                                          int rhi, int clo, int chi) {
  float bl, br, tl, tr;
  tap_box(wire, s, p, vt.rr, vt.c, rlo, rhi, clo, chi, bl, br);
  tap_box(wire, s, p, vt.rr + 1, vt.c, rlo, rhi, clo, chi, tl, tr);
  return bp::fold_taps(acc, bl, br, tl, tr, vt.sx, vt.sy, vt.r);
}

__host__ __device__ __forceinline__ int mats_bytes(int P) {
  return (P * 12 * 4 + 15) / 16 * 16;
}

// --------------------------------------------------------------------
// K3 strip_db and K4 strip_micro: a ring of tap boxes per block.
// --------------------------------------------------------------------
template <class Wire, bool kMicro>
__global__ void __launch_bounds__(1024)
    strip_ring_kernel(float* __restrict__ vol,
                      const unsigned char* __restrict__ stack,
                      const float* __restrict__ mats, Wire wire, int P,
                      Geo g, Tiling t, int depth, int n_tiles,
                      int warp_groups, int* __restrict__ clamps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* smats = reinterpret_cast<float*>(smem);
  Item* items = reinterpret_cast<Item*>(smem + mats_bytes(P));
  unsigned char* ring = reinterpret_cast<unsigned char*>(items + depth);
  const int slot_bytes = t.slot_rows * t.slot_units * 16;
  int* red = reinterpret_cast<int*>(ring + depth * slot_bytes);

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int i = tid; i < P * 12; i += nthreads) smats[i] = mats[i];
  __syncthreads();

  const int live = min(32, nthreads - (tid & ~31));
  const unsigned live_mask = live == 32 ? 0xffffffffu : (1u << live) - 1u;
  const bool lanes4 = (live & 3) == 0;
  const int ly = tid / t.chunk;
  const int lx = tid - ly * t.chunk;
  const int tiles_y = g.L / t.ty;
  const int tiles_x = g.L / t.chunk;

  // A walk over this block's items: projection p of its tiles blockIdx.x,
  // blockIdx.x + gridDim.x, ... in turn, in ring slot `slot`.  Advanced
  // by counting, so an item costs no integer division.
  struct Cursor {
    int tile, p, slot, zi, y0, x0;
  };
  auto place = [&](Cursor& c) {
    const int rest = c.tile / tiles_x;
    c.x0 = (c.tile - rest * tiles_x) * t.chunk;
    c.zi = rest / tiles_y;
    c.y0 = (rest - c.zi * tiles_y) * t.ty;
  };
  auto advance = [&](Cursor& c) {
    c.slot = c.slot + 1 == depth ? 0 : c.slot + 1;
    if (++c.p == P) {
      c.p = 0;
      c.tile += gridDim.x;
      place(c);
    }
  };
  Cursor next{static_cast<int>(blockIdx.x), 0, 0, 0, 0, 0};
  place(next);
  Cursor cur = next;

  // Stage the item at `next` and step past it.  Every item commits one
  // cp.async group, an empty box too, and so does every fetch past the
  // last item, so that wait_group counts items.
  auto fetch = [&]() {
    if (next.tile < n_tiles) {
      const CornerSpan sp = corner_span(
          smats + next.p * 12, bp::world(g.z0 + next.zi, g.O, g.MM),
          next.y0, next.x0, g, t, live_mask, lanes4);
      Item it;
      const bool cut = make_item<Wire::kBytes>(sp, g, t, it);
      if (tid == 0) {
        items[next.slot] = it;
        if (cut) atomicAdd(clamps, 1);
      }
      stage_box(ring + next.slot * slot_bytes, stack, next.p, it, g, t, tid,
                nthreads);
      advance(next);
    }
    cp_async_commit();
  };

  for (int d = 0; d < depth - 1; ++d) fetch();
  float acc = 0.0f;
  size_t vidx = 0;
  for (; cur.tile < n_tiles; advance(cur)) {
    __syncthreads();                 // the previous item's slot is free
    fetch();                         // depth - 1 items ahead
    cp_async_wait_dyn(depth - 1);    // this item has landed (this thread's)
    __syncthreads();                 // ... and every thread's

    const int p = cur.p, slot = cur.slot, zi = cur.zi;
    const int y = cur.y0 + ly;
    const int x = cur.x0 + lx;
    if (p == 0) {
      vidx = (static_cast<size_t>(zi) * g.L + y) * g.L + x;
      acc = vol[vidx];
    }
    const float* A = smats + p * 12;
    const float wz = bp::world(g.z0 + zi, g.O, g.MM);
    const VoxelTap vt = voxel_tap(A, bp::world(x, g.O, g.MM),
                                  bp::world(y, g.O, g.MM), wz);
    const Item it = items[slot];
    int rlo = it.br0, rhi = it.br1, clo = it.bc0, chi = it.bc1;
    if (kMicro) {
      // The run's micro window: the least strip-relative tap row and
      // column, each clipped into the strip, the origin clipped so the
      // window stays in the strip; taps read inside it and the box.
      int rel_r = min(max(vt.rr - it.r0, 0), t.band - 1);
      int rel_c = min(max(vt.c - it.c0, 0), t.width - 1);
      if (warp_groups) {
        const int lane = tid & 31;
        const unsigned mask =
            t.group == 32 ? 0xffffffffu
                          : ((1u << t.group) - 1u) << (lane & ~(t.group - 1));
        rel_r = __reduce_min_sync(mask, rel_r);
        rel_c = __reduce_min_sync(mask, rel_c);
      } else {
        red[tid] = rel_r;
        red[nthreads + tid] = rel_c;
        __syncthreads();
        const int first = tid - lx % t.group;
        for (int j = 0; j < t.group; ++j) {
          rel_r = min(rel_r, red[first + j]);
          rel_c = min(rel_c, red[nthreads + first + j]);
        }
      }
      const int gr = it.r0 + min(max(rel_r, 0), t.band - t.gband);
      const int gc = it.c0 + min(max(rel_c, 0), t.width - t.gwidth);
      rlo = max(rlo, gr);
      rhi = min(rhi, gr + t.gband);
      clo = max(clo, gc);
      chi = min(chi, gc + t.gwidth);
    }
    const BoxView bv{ring + slot * slot_bytes, it.br0, it.u0 * 16,
                     t.slot_units * 16};
    acc = fold_box(acc, wire, bv, p, vt, rlo, rhi, clo, chi);
    if (p == P - 1) vol[vidx] = acc;
  }
}

// --------------------------------------------------------------------
// K5 strip_shared: one slab per tile for the launch's P projections.
// --------------------------------------------------------------------
template <class Wire>
__global__ void __launch_bounds__(1024)
    strip_shared_kernel(float* __restrict__ vol,
                        const uint32_t* __restrict__ stack,
                        const float* __restrict__ mats, Wire wire, int P,
                        Geo g, Tiling t) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* smats = reinterpret_cast<float*>(smem);
  uint32_t* slab = reinterpret_cast<uint32_t*>(smem + mats_bytes(P));
  const int slot_words = t.band * t.sw;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int i = tid; i < P * 12; i += nthreads) smats[i] = mats[i];
  __syncthreads();

  const int tiles_y = g.L / t.ty;
  const int tiles_x = g.L / t.chunk;
  const int tile = blockIdx.x;
  const int x0 = (tile % tiles_x) * t.chunk;
  const int y0 = ((tile / tiles_x) % tiles_y) * t.ty;
  const int zi = tile / tiles_x / tiles_y;
  const float wz = bp::world(g.z0 + zi, g.O, g.MM);

  int r0 = INT_MAX, c0 = INT_MAX;
  for (int p = 0; p < P; ++p) {
    const int2 o = corner_origin(smats + p * 12, wz, y0, x0, g, t);
    r0 = min(r0, o.x);
    c0 = min(c0, o.y);
  }
  for (int p = 0; p < P; ++p)
    stage<Wire>(slab + p * slot_words, stack, p, r0, c0, g, t, tid,
                nthreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int ly = tid / t.chunk;
  const int y = y0 + ly;
  const int x = x0 + tid - ly * t.chunk;
  const size_t vidx = (static_cast<size_t>(zi) * g.L + y) * g.L + x;
  const float wx = bp::world(x, g.O, g.MM);
  const float wy = bp::world(y, g.O, g.MM);
  float acc = vol[vidx];
  for (int p = 0; p < P; ++p) {
    const VoxelTap vt = voxel_tap(smats + p * 12, wx, wy, wz);
    const Staged st{slab + p * slot_words, r0, (c0 * Wire::kBytes) >> 2};
    acc = fold(acc, wire, st, g, t, p, vt, r0, r0 + t.band, c0,
               c0 + t.width);
  }
  vol[vidx] = acc;
}

// --------------------------------------------------------------------
// Launch
// --------------------------------------------------------------------
enum Kind { kDb = 0, kMicroKind = 1, kShared = 2 };

// Dynamic shared memory of one block: the P x 12 matrices, then K5's
// P-deep window slab, or K3/K4's `depth` items and slots (each slot
// slot_rows x slot_units 16-byte units) and K4's reduction scratch.
// Mirrors repro_torch/kernels/backproject.py::strip_smem_bytes.
size_t smem_bytes(int kind, int P, const Tiling& t, int depth,
                  int warp_groups) {
  if (kind == kShared)
    return mats_bytes(P) + static_cast<size_t>(P) * t.band * t.sw * 4;
  size_t n = mats_bytes(P) + depth * (sizeof(Item) +
                                      static_cast<size_t>(t.slot_rows) *
                                          t.slot_units * 16);
  if (kind == kMicroKind && !warp_groups)
    n += static_cast<size_t>(2) * t.ty * t.chunk * 4;
  return n;
}

template <class Wire>
int launch(int kind, float* vol, const void* stack, const float* mats,
           const Wire& wire, int P, int nz, const Geo& g, const Tiling& t,
           int depth, int* clamps, cudaStream_t stream) {
  const int threads = t.ty * t.chunk;
  const int n_tiles = nz * (g.L / t.ty) * (g.L / t.chunk);
  const int warp_groups = kind == kMicroKind && 32 % t.group == 0;
  const size_t smem = smem_bytes(kind, P, t, depth, warp_groups);
  void (*ring)(float*, const unsigned char*, const float*, Wire, int, Geo,
               Tiling, int, int, int, int*) =
      kind == kDb ? strip_ring_kernel<Wire, false>
                  : strip_ring_kernel<Wire, true>;
  const void* fn = kind == kShared
                       ? reinterpret_cast<const void*>(
                             strip_shared_kernel<Wire>)
                       : reinterpret_cast<const void*>(ring);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kind == kShared) {
    strip_shared_kernel<Wire><<<n_tiles, threads, smem, stream>>>(
        vol, static_cast<const uint32_t*>(stack), mats, wire, P, g, t);
    return static_cast<int>(cudaGetLastError());
  }
  int blocks = n_tiles;            // K4: one tile per block
  if (kind == kDb) {               // K3: persistent blocks
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, ring, threads, smem)) != cudaSuccess)
      return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    blocks = std::min(n_tiles, per_sm * sms);
  }
  ring<<<blocks, threads, smem, stream>>>(
      vol, static_cast<const unsigned char*>(stack), mats, wire, P, g, t,
      depth, n_tiles, warp_groups, clamps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes.
//   kind:  0 K3 strip_db, 1 K4 strip_micro, 2 K5 strip_shared;
//   wire:  4 float32, 2 bfloat16, 1 int8 (the element size in bytes);
//   vol:   (nz, L, L) f32, its first plane the global plane z0;
//   stack: (P, rows, pitch_words) 32-bit words: the bordered images in
//          the wire's type, each row zero-padded to whole 16-byte units
//          (K5 takes whole words), 16-byte aligned;
//   scales (int8 only): (P, 2, rows) f32, [p][0] scale, [p][1] offset;
//   mats:  (P, 3, 4) f32;
//   slot_rows, slot_units (K3, K4): a slot's rows and 16-byte units per
//          row, at most the window's (band rows, (width * wire + 15) / 16
//          + 1 units);
//   clamps (K3, K4): one int on the device, += 1 for every item whose
//          box its slot cut.
// Every pointer on the device of `stream`.  Launches on `stream`,
// neither synchronises nor allocates, and returns a cudaError_t value
// (cudaErrorInvalidValue for a shape the kernels do not take).
extern "C" int backproject_strip_launch(
    int kind, int wire, void* vol, const void* stack, const void* scales,
    const void* mats, int P, int L, int nz, int z0, int rows, int cols,
    int pitch_words, int n_u, int n_v, float O, float MM, int ty, int chunk,
    int band, int width, int pad_rows, int pad_cols, int depth, int group,
    int gband, int gwidth, int slot_rows, int slot_units, void* clamps,
    void* stream) {
  const bool ring = kind == kDb || kind == kMicroKind;
  if (P < 1 || ty < 1 || chunk < 1 || L % ty || L % chunk ||
      ty * chunk > 1024 || band < 1 || width < 1 || depth < 2 || depth > 8 ||
      pad_rows < band || pad_cols < width ||
      (kind == kMicroKind &&
       (group < 1 || chunk % group || gband > band || gwidth > width ||
        gband < 1 || gwidth < 1)) ||
      (ring && (pitch_words % 4 || reinterpret_cast<uintptr_t>(stack) % 16 ||
                slot_rows < 0 || slot_rows > band || slot_units < 0 ||
                slot_units > (width * wire + 15) / 16 + 1 ||
                clamps == nullptr)) ||
      kind < kDb || kind > kShared)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nz == 0) return 0;
  const int sw = (width * wire + 3) / 4 + 1;
  const Geo g{O, MM, L, z0, n_u, n_v, rows, cols, pitch_words};
  const Tiling t{ty, chunk, band, width, pad_rows, pad_cols, sw,
                 group, gband, gwidth, slot_rows, slot_units};
  auto* v = static_cast<float*>(vol);
  auto* m = static_cast<const float*>(mats);
  auto* c = static_cast<int*>(clamps);
  auto st = static_cast<cudaStream_t>(stream);
  switch (wire) {
    case 4:
      return launch(kind, v, stack, m, F32Wire{}, P, nz, g, t, depth, c, st);
    case 2:
      return launch(kind, v, stack, m, Bf16Wire{}, P, nz, g, t, depth, c,
                    st);
    case 1:
      return launch(kind, v, stack, m,
                    Int8Wire{static_cast<const float*>(scales), rows}, P,
                    nz, g, t, depth, c, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
