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
//   All three stage per (tile, projection) only the box of taps the
//   tile's voxels read, cut to the window and to the image, not the
//   whole window.  On a z-plane u/w and v/w are linear-fractional in
//   (x, y), so where w > 0 on the tile (w is affine: at its four
//   corners) their extremes lie at the four corner voxels: the box is
//   rows [floor(min iy) + 1, floor(max iy) + 3) and the same for the
//   columns, widened by kBoxMargin on each side against the float32
//   rounding of the voxels' own coordinates.  A tile with a corner at
//   w <= 1e-6 stages its whole window.  Rows arrive re-pitched to whole
//   16-byte units (pitch_stack), and a box row is staged from the
//   16-byte unit holding its first element, one cp.async.cg of 16 bytes
//   per unit, so every copy lies inside the stack.  A tap reads its
//   value only inside the box (and, in K4, the micro window): the box
//   lies inside the window and the image, and nothing outside it was
//   staged for this item.  A box larger than its slot is cut and counted
//   in `clamps`, which the caller requires to stay 0.
//   K3/K4: four lanes of each warp evaluate the four corners and reduce
//       by shuffles, once per item; thread 0 keeps the item (window
//       origin, box) in shared memory beside its slot.  A slot holds the
//       largest box of the launch's matrices
//       (repro_torch/core/clipping.py::strip_box_slots).
//   K5: persistent blocks walk their tiles through a 2-slot ring; a slot
//       holds the P boxes of one tile packed back to back (box p's rows
//       nu_p units apart), sized by the launch's largest per-tile total
//       (clipping.py::shared_box_slots).  Warp 0 plans a tile two ahead
//       into one of three record sets: lane 4q + k evaluates corner k of
//       projection q of a pass of 8, shuffles within each four lanes
//       give each projection's span, shuffles across the warp the group
//       origin (the least of the members' corner origins) and, by a scan
//       of the box sizes, each box's offset in the slot.  Each tile costs
//       one block barrier: behind it the tile's boxes have landed, the
//       previous tile's fold has left its slot, and the next tile's
//       records are written; then the block copies the next tile's boxes
//       (warp w rows w, w + warps, ... of each box) while it folds this
//       one, all P projections per barrier.  No integer division per
//       box or per copy, none of 64 bits per tile.
//
// Bound: the same work as backproject.cu, so the same bound (the volume
// read and written once, each image read once, and the FP32 operations).
// The staged boxes move more bytes through L2 and shared memory than the
// direct gather of row 1 reads.  With boxes in place of windows the
// kernels no longer scale with the bytes staged: K3 and K4 pay two block
// barriers, the corner box and its copies per (tile, projection) item on
// top of the fold, K5 one barrier per tile; PERF.md has the times.

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

// K5: record sets of box records (a tile is planned two ahead of its
// fold) and ring slots of boxes.
constexpr int kSharedSets = 3;
constexpr int kSharedSlots = 2;

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
  int group, gband, gwidth;      // K4 only
  int slot_rows, slot_units;     // a slot's rows, 16-byte units a row
                                 // (K5: 1 row of all its units)
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

// A staged box: rows [br0, br1) x columns [bc0, bc1) in padded
// coordinates; a box row is staged as `nu` 16-byte units from unit u0 of
// its image row.  An empty box has br1 = br0, bc1 = bc0, nu = 0.
struct Box {
  int br0, br1, bc0, bc1, u0, nu;
};

// The box of a tile's corner span inside the (band, width) window at
// `o` (repro_torch/core/clipping.py::corner_boxes, the same integer
// rule), cut to the image; a tile with a flat corner takes the window.
template <int kBytes>
__device__ __forceinline__ Box box_in_window(const CornerSpan& sp, int2 o,
                                             const Geo& g,
                                             const Tiling& t) {
  int br0 = o.x, br1 = o.x + t.band, bc0 = o.y, bc1 = o.y + t.width;
  if (!sp.flat) {
    br0 = max(br0, static_cast<int>(floorf(sp.rlo)) + 1 - kBoxMargin);
    br1 = min(br1, static_cast<int>(floorf(sp.rhi)) + 3 + kBoxMargin);
    bc0 = max(bc0, static_cast<int>(floorf(sp.clo)) + 1 - kBoxMargin);
    bc1 = min(bc1, static_cast<int>(floorf(sp.chi)) + 3 + kBoxMargin);
  }
  br1 = min(br1, g.rows);
  bc1 = min(bc1, g.cols);
  Box b;
  b.u0 = (bc0 * kBytes) >> 4;
  b.nu = ((bc1 * kBytes + 15) >> 4) - b.u0;
  if (br1 <= br0 || bc1 <= bc0) {
    br1 = br0;
    bc1 = bc0;
    b.nu = 0;
  }
  b.br0 = br0;
  b.br1 = br1;
  b.bc0 = bc0;
  b.bc1 = bc1;
  return b;
}

// One (tile, projection) item of K3/K4: its window origin (r0, c0) and
// the box it stages.
struct Item {
  int r0, c0;
  Box b;
};

// The item of a tile's corner span: its own window, and its box cut to
// the window, the image and the slot.  Returns whether the slot cut it.
template <int kBytes>
__device__ __forceinline__ bool make_item(const CornerSpan& sp,
                                          const Geo& g, const Tiling& t,
                                          Item& it) {
  const int2 o = window_origin(sp.rlo, sp.clo, t);
  it.r0 = o.x;
  it.c0 = o.y;
  it.b = box_in_window<kBytes>(sp, o, g, t);
  bool cut = false;
  if (it.b.br1 - it.b.br0 > t.slot_rows) {
    it.b.br1 = it.b.br0 + t.slot_rows;
    cut = true;
  }
  if (it.b.nu > t.slot_units) {
    it.b.nu = t.slot_units;
    it.b.bc1 = min(it.b.bc1, ((it.b.u0 + it.b.nu) << 4) / kBytes);
    cut = true;
  }
  return cut;
}

// Copy rows r_first, r_first + r_step, ... of a box of `rows` rows of
// `nu` 16-byte units (its image rows `pitch` bytes apart from `src`) to
// `dst` (rows `row_bytes` apart), units u_first, u_first + u_step, ... of
// each row, without waiting.  The box lies in the image and its units in
// the 16-byte pitch, so every copy is whole.
__device__ __forceinline__ void stage_rows(unsigned char* dst, int row_bytes,
                                           const unsigned char* src,
                                           size_t pitch, int rows, int nu,
                                           int r_first, int r_step,
                                           int u_first, int u_step) {
  for (int r = r_first; r < rows; r += r_step)
    for (int u = u_first; u < nu; u += u_step)
      cp_async16(dst + r * row_bytes + u * 16, src + r * pitch + u * 16);
}

// Where box b of projection p starts in the stack.
__device__ __forceinline__ const unsigned char* box_source(
    const unsigned char* __restrict__ stack, int p, const Box& b,
    const Geo& g) {
  return stack +
         (static_cast<size_t>(p) * g.rows + b.br0) * g.pitch_words * 4 +
         static_cast<size_t>(b.u0) * 16;
}

// K3/K4: copy an item's box of projection p into `dst` (rows of
// t.slot_units 16-byte units), cooperatively over the block.
__device__ __forceinline__ void stage_box(unsigned char* dst,
                                          const unsigned char* __restrict__ stack,
                                          int p, const Box& b,
                                          const Geo& g, const Tiling& t,
                                          int tid, int nthreads) {
  const int rows = b.br1 - b.br0;
  if (rows <= 0 || b.nu <= 0) return;
  const size_t pitch = static_cast<size_t>(g.pitch_words) * 4;
  const unsigned char* src = box_source(stack, p, b, g);
  const int row_bytes = t.slot_units * 16;
  if (b.nu <= nthreads) {
    // Each thread keeps one unit u and walks rows r, r + step, ...
    const int step = nthreads / b.nu;
    const int r0 = tid / b.nu;
    const int u = tid - r0 * b.nu;
    if (r0 >= step) return;
    for (int r = r0; r < rows; r += step)
      cp_async16(dst + r * row_bytes + u * 16, src + r * pitch + u * 16);
    return;
  }
  stage_rows(dst, row_bytes, src, pitch, rows, b.nu, 0, 1, tid, nthreads);
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

// A staged box: row br0 at `base`, rows `row_bytes` apart, the row's
// first staged byte at byte `off` of its image row.
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

// The (zi, y0, x0) of tile `tile` of a launch.
struct Place {
  int zi, y0, x0;
};

__device__ __forceinline__ Place place_tile(int tile, int tiles_y,
                                            int tiles_x, const Tiling& t) {
  const int rest = tile / tiles_x;
  Place pl;
  pl.x0 = (tile - rest * tiles_x) * t.chunk;
  pl.zi = rest / tiles_y;
  pl.y0 = (rest - pl.zi * tiles_y) * t.ty;
  return pl;
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
    int tile, p, slot;
    Place at;
  };
  auto advance = [&](Cursor& c) {
    c.slot = c.slot + 1 == depth ? 0 : c.slot + 1;
    if (++c.p == P) {
      c.p = 0;
      c.tile += gridDim.x;
      c.at = place_tile(c.tile, tiles_y, tiles_x, t);
    }
  };
  Cursor next{static_cast<int>(blockIdx.x), 0, 0,
              place_tile(blockIdx.x, tiles_y, tiles_x, t)};
  Cursor cur = next;

  // Stage the item at `next` and step past it.  Every item commits one
  // cp.async group, an empty box too, and so does every fetch past the
  // last item, so that wait_group counts items.
  auto fetch = [&]() {
    if (next.tile < n_tiles) {
      const CornerSpan sp = corner_span(
          smats + next.p * 12, bp::world(g.z0 + next.at.zi, g.O, g.MM),
          next.at.y0, next.at.x0, g, t, live_mask, lanes4);
      Item it;
      const bool cut = make_item<Wire::kBytes>(sp, g, t, it);
      if (tid == 0) {
        items[next.slot] = it;
        if (cut) atomicAdd(clamps, 1);
      }
      stage_box(ring + next.slot * slot_bytes, stack, next.p, it.b, g, t,
                tid, nthreads);
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

    const int p = cur.p, slot = cur.slot, zi = cur.at.zi;
    const int y = cur.at.y0 + ly;
    const int x = cur.at.x0 + lx;
    if (p == 0) {
      vidx = (static_cast<size_t>(zi) * g.L + y) * g.L + x;
      acc = vol[vidx];
    }
    const float* A = smats + p * 12;
    const float wz = bp::world(g.z0 + zi, g.O, g.MM);
    const VoxelTap vt = voxel_tap(A, bp::world(x, g.O, g.MM),
                                  bp::world(y, g.O, g.MM), wz);
    const Item it = items[slot];
    int rlo = it.b.br0, rhi = it.b.br1, clo = it.b.bc0, chi = it.b.bc1;
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
    const BoxView bv{ring + slot * slot_bytes, it.b.br0, it.b.u0 * 16,
                     t.slot_units * 16};
    acc = fold_box(acc, wire, bv, p, vt, rlo, rhi, clo, chi);
    if (p == P - 1) vol[vidx] = acc;
  }
}

// --------------------------------------------------------------------
// K5 strip_shared: a ring of tiles, each tile's P boxes in one slot.
// --------------------------------------------------------------------

// K5's record of projection p's box in its tile's slot: the box, and the
// 16-byte unit of the slot where its first row starts (its rows nu
// units apart).
struct PackedBox {
  Box b;
  int off, pad;
};

template <class Wire>
__global__ void __launch_bounds__(1024)
    strip_shared_kernel(float* __restrict__ vol,
                        const unsigned char* __restrict__ stack,
                        const float* __restrict__ mats, Wire wire, int P,
                        Geo g, Tiling t, int n_tiles,
                        int* __restrict__ clamps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* smats = reinterpret_cast<float*>(smem);
  PackedBox* recs = reinterpret_cast<PackedBox*>(smem + mats_bytes(P));
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(recs + kSharedSets * P);
  const int slot_bytes = t.slot_units * 16;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int i = tid; i < P * 12; i += nthreads) smats[i] = mats[i];
  __syncthreads();

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = (nthreads + 31) >> 5;
  const int live = min(32, nthreads - (tid & ~31));
  const int ly = tid / t.chunk;
  const int lx = tid - ly * t.chunk;
  const int tiles_y = g.L / t.ty;
  const int tiles_x = g.L / t.chunk;
  const size_t pitch = static_cast<size_t>(g.pitch_words) * 4;
  // Warp 0 is whole: it plans 8 projections a pass, lane 4q + k corner k
  // of projection q; a block of fewer threads plans on thread 0 alone.
  const bool lanes4 = nthreads >= 32;
  const int per = lanes4 ? 8 : 1;
  const int q = lanes4 ? lane >> 2 : 0;

  // Warp 0 writes record set `set` for `tile`: each projection's box in
  // the group window, at its offset in the slot.
  auto plan = [&](int tile, int set) {
    if (warp != 0 || tile >= n_tiles || (!lanes4 && lane != 0)) return;
    const Place at = place_tile(tile, tiles_y, tiles_x, t);
    const float wz = bp::world(g.z0 + at.zi, g.O, g.MM);
    auto span = [&](int p0) {
      return corner_span(smats + min(p0 + q, P - 1) * 12, wz, at.y0, at.x0,
                         g, t, 0xffffffffu, lanes4);
    };
    const CornerSpan first = span(0);
    int2 o = make_int2(INT_MAX, INT_MAX);
    for (int p0 = 0; p0 < P; p0 += per) {
      const CornerSpan sp = p0 ? span(p0) : first;
      if (p0 + q < P) {
        const int2 w = window_origin(sp.rlo, sp.clo, t);
        o = make_int2(min(o.x, w.x), min(o.y, w.y));
      }
    }
    if (lanes4) {
#pragma unroll
      for (int s = 4; s < 32; s <<= 1) {
        o.x = min(o.x, __shfl_xor_sync(0xffffffffu, o.x, s));
        o.y = min(o.y, __shfl_xor_sync(0xffffffffu, o.y, s));
      }
    }
    int base = 0;
    for (int p0 = 0; p0 < P; p0 += per) {
      const int p = p0 + q;
      const CornerSpan sp = p0 ? span(p0) : first;
      PackedBox pb{box_in_window<Wire::kBytes>(sp, o, g, t), 0, 0};
      const int size = p < P ? (pb.b.br1 - pb.b.br0) * pb.b.nu : 0;
      // Offsets: a scan of the sizes over the pass's projections (each
      // four lanes hold one), after the earlier passes' total.
      int incl = size;
      if (lanes4) {
#pragma unroll
        for (int s = 4; s < 32; s <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, s);
          if (lane >= s) incl += v;
        }
      }
      pb.off = base + incl - size;
      if (size > 0 && pb.off + size > t.slot_units) {
        // The slot holds only the box's first rows, if any: cut, counted.
        const int rows =
            pb.off < t.slot_units ? (t.slot_units - pb.off) / pb.b.nu : 0;
        pb.b.br1 = pb.b.br0 + rows;
        if ((lane & 3) == 0) atomicAdd(clamps, 1);
      }
      if (p < P && (lane & 3) == 0) recs[set * P + p] = pb;
      base += lanes4 ? __shfl_sync(0xffffffffu, incl, 31) : incl;
    }
  };

  // The block copies record set `set`'s boxes into ring slot `slot`:
  // warp w rows w, w + warps, ... of each box, a lane per unit.
  auto stage = [&](int set, int slot) {
    unsigned char* dst = ring + slot * slot_bytes;
    for (int p = 0; p < P; ++p) {
      const PackedBox pb = recs[set * P + p];
      const int rows = pb.b.br1 - pb.b.br0;
      if (rows <= 0 || pb.b.nu <= 0) continue;
      stage_rows(dst + pb.off * 16, pb.b.nu * 16,
                 box_source(stack, p, pb.b, g), pitch, rows, pb.b.nu, warp,
                 warps, lane, live);
    }
  };

  int tile = blockIdx.x;
  plan(tile, 0);
  __syncthreads();
  stage(0, 0);
  cp_async_commit();
  plan(tile + gridDim.x, 1);
  for (int set = 0, slot = 0; tile < n_tiles; tile += gridDim.x) {
    cp_async_wait<0>();
    // This tile's boxes have landed, the previous tile's fold has left
    // the other slot, and the next tile's records are written.
    __syncthreads();
    const int next = tile + gridDim.x;
    const int next_set = set + 1 == kSharedSets ? 0 : set + 1;
    if (next < n_tiles) stage(next_set, slot ^ 1);
    cp_async_commit();
    plan(next + gridDim.x, next_set + 1 == kSharedSets ? 0 : next_set + 1);

    const Place at = place_tile(tile, tiles_y, tiles_x, t);
    const int y = at.y0 + ly;
    const int x = at.x0 + lx;
    const size_t vidx = (static_cast<size_t>(at.zi) * g.L + y) * g.L + x;
    const float wx = bp::world(x, g.O, g.MM);
    const float wy = bp::world(y, g.O, g.MM);
    const float wz = bp::world(g.z0 + at.zi, g.O, g.MM);
    const unsigned char* boxes = ring + slot * slot_bytes;
    float acc = vol[vidx];
    for (int p = 0; p < P; ++p) {
      const PackedBox pb = recs[set * P + p];
      const VoxelTap vt = voxel_tap(smats + p * 12, wx, wy, wz);
      const BoxView bv{boxes + pb.off * 16, pb.b.br0, pb.b.u0 * 16,
                       pb.b.nu * 16};
      acc = fold_box(acc, wire, bv, p, vt, pb.b.br0, pb.b.br1, pb.b.bc0,
                     pb.b.bc1);
    }
    vol[vidx] = acc;
    set = next_set;
    slot ^= 1;
  }
}

// --------------------------------------------------------------------
// Launch
// --------------------------------------------------------------------
enum Kind { kDb = 0, kMicroKind = 1, kShared = 2 };

// Dynamic shared memory of one block: the P x 12 matrices, then K3/K4's
// `depth` items and slots (each slot slot_rows x slot_units 16-byte
// units) and K4's reduction scratch, or K5's three sets of P box records
// and two slots of slot_units units.  Mirrors
// repro_torch/kernels/backproject.py::strip_smem_bytes.
size_t smem_bytes(int kind, int P, const Tiling& t, int depth,
                  int warp_groups) {
  if (kind == kShared)
    return mats_bytes(P) + kSharedSets * sizeof(PackedBox) * P +
           kSharedSlots * static_cast<size_t>(t.slot_units) * 16;
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
  const auto* st = static_cast<const unsigned char*>(stack);
  void (*ring)(float*, const unsigned char*, const float*, Wire, int, Geo,
               Tiling, int, int, int, int*) =
      kind == kDb ? strip_ring_kernel<Wire, false>
                  : strip_ring_kernel<Wire, true>;
  void (*shared)(float*, const unsigned char*, const float*, Wire, int, Geo,
                 Tiling, int, int*) = strip_shared_kernel<Wire>;
  const void* fn = kind == kShared ? reinterpret_cast<const void*>(shared)
                                   : reinterpret_cast<const void*>(ring);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = n_tiles;            // K4: one tile per block
  if (kind != kMicroKind) {        // K3, K5: persistent blocks
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fn, threads, smem)) != cudaSuccess)
      return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    blocks = std::min(n_tiles, per_sm * sms);
  }
  if (kind == kShared)
    shared<<<blocks, threads, smem, stream>>>(vol, st, mats, wire, P, g, t,
                                              n_tiles, clamps);
  else
    ring<<<blocks, threads, smem, stream>>>(vol, st, mats, wire, P, g, t,
                                            depth, n_tiles, warp_groups,
                                            clamps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes.
//   kind:  0 K3 strip_db, 1 K4 strip_micro, 2 K5 strip_shared;
//   wire:  4 float32, 2 bfloat16, 1 int8 (the element size in bytes);
//   vol:   (nz, L, L) f32, its first plane the global plane z0;
//   stack: (P, rows, pitch_words) 32-bit words: the bordered images in
//          the wire's type, each row zero-padded to whole 16-byte units,
//          16-byte aligned;
//   scales (int8 only): (P, 2, rows) f32, [p][0] scale, [p][1] offset;
//   mats:  (P, 3, 4) f32;
//   slot_rows, slot_units: K3/K4 a slot's rows and 16-byte units per
//          row, at most the window's (band rows, (width * wire + 15) / 16
//          + 1 units); K5 slot_rows = 1 and slot_units the units of a
//          tile's P packed boxes, at most P such windows;
//   clamps: one int on the device, += 1 for every box its slot cut.
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
  const long long units = (width * wire + 15) / 16 + 1;
  const bool ring_slot =
      slot_rows >= 0 && slot_rows <= band && slot_units >= 0 &&
      slot_units <= units;
  const bool shared_slot =
      slot_rows == 1 && slot_units >= 0 &&
      slot_units <= static_cast<long long>(P) * band * units;
  if (P < 1 || ty < 1 || chunk < 1 || L % ty || L % chunk ||
      ty * chunk > 1024 || band < 1 || width < 1 || depth < 2 || depth > 8 ||
      pad_rows < band || pad_cols < width ||
      (kind == kMicroKind &&
       (group < 1 || chunk % group || gband > band || gwidth > width ||
        gband < 1 || gwidth < 1)) ||
      pitch_words % 4 || reinterpret_cast<uintptr_t>(stack) % 16 ||
      clamps == nullptr || !(kind == kShared ? shared_slot : ring_slot) ||
      kind < kDb || kind > kShared)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nz == 0) return 0;
  const Geo g{O, MM, L, z0, n_u, n_v, rows, cols, pitch_words};
  const Tiling t{ty,    chunk, band,  width,     pad_rows,  pad_cols,
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
