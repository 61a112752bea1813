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
// except that a tap reads its value from a window staged in shared
// memory, and reads 0 when it lies outside that window.  The windows are
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
// fold into it.  The stack arrives re-pitched (each row padded to whole
// 4-byte words, zero-filled), so a window row is a run of words that
// cp.async copies without crossing a row; words outside the stack are
// zero-filled.  The staged window keeps the wire's type (float32,
// bfloat16 or int8 codes); an int8 code decodes in registers with the
// scale and offset of its global padded row.  The arithmetic is
// backproject.cu's (backproject_common.cuh), so each kernel equals its
// plain version bitwise on every wire, and row 1 too where the windows
// cover every tap.
//   K3: persistent blocks walk the global (tile, projection) sequence
//       t = step * P + p of their tiles through a `depth`-slot ring,
//       `depth - 1` fetches ahead across tile boundaries (cp.async with
//       commit_group / wait_group).  At P = 1 the prefetch crosses
//       tiles, which is what gives it meaning there.
//   K4: one tile per block through a 2-slot ring; each run of `group`
//       lanes finds its micro window with __reduce_min_sync (a group
//       that does not divide the warp reduces through shared memory).
//   K5: one (P, band, width) slab per tile, loaded once; all P
//       projections fold from it.  The slab may exceed 48 KB: the
//       launcher opts in up to the card's 227 KB and refuses more.
//
// Bound: the same work as backproject.cu, so the same bound (the volume
// read and written once, each image read once, and the FP32 operations).
// The staged windows move far more bytes through L2 and shared memory
// than the direct gather of row 1 reads, so these kernels are expected to
// be slower than row 1 on this card; they are the ports of the TPU
// designs, measured beside it.

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
  int sw;                        // staged words per window row
  int group, gband, gwidth;      // K4 only
};

// The window origin of a (ty, chunk) tile from its four corner voxels
// (the reference's _strip_origin): the floor of the least clipped tap
// coordinate, clamped so the window ends inside the padded image.
__device__ __forceinline__ int2 corner_origin(const float* A, float wz,
                                              int y0, int x0,
                                              const Geo& g,
                                              const Tiling& t) {
  float rlo = 0.0f, clo = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float wy = bp::world(y0 + ((k & 2) ? t.ty - 1 : 0), g.O, g.MM);
    const float wx = bp::world(x0 + ((k & 1) ? t.chunk - 1 : 0), g.O, g.MM);
    const float r = bp::recip_w(bp::dot_row(A + 8, wx, wy, wz));
    const float ix = fminf(fmaxf(__fmul_rn(bp::dot_row(A, wx, wy, wz), r),
                                 -1.0f), static_cast<float>(g.n_u));
    const float iy = fminf(fmaxf(__fmul_rn(bp::dot_row(A + 4, wx, wy, wz),
                                           r), -1.0f),
                           static_cast<float>(g.n_v));
    clo = k ? fminf(clo, ix) : ix;
    rlo = k ? fminf(rlo, iy) : iy;
  }
  const int r0 = min(max(static_cast<int>(floorf(rlo)), 0),
                     t.pad_rows - t.band);
  const int c0 = min(max(static_cast<int>(floorf(clo)), 0),
                     t.pad_cols - t.width);
  return make_int2(r0, c0);
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

// A staged window: rows [r0, r0 + band) of projection p, each row
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

__host__ __device__ __forceinline__ int mats_bytes(int P) {
  return (P * 12 * 4 + 15) / 16 * 16;
}

// --------------------------------------------------------------------
// K3 strip_db and K4 strip_micro: a ring of strips per block.
// --------------------------------------------------------------------
template <class Wire, bool kMicro>
__global__ void __launch_bounds__(1024)
    strip_ring_kernel(float* __restrict__ vol,
                      const uint32_t* __restrict__ stack,
                      const float* __restrict__ mats, Wire wire, int P,
                      Geo g, Tiling t, int depth, int n_tiles,
                      int warp_groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* smats = reinterpret_cast<float*>(smem);
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem + mats_bytes(P));
  const int slot_words = t.band * t.sw;
  int* red = reinterpret_cast<int*>(ring + depth * slot_words);

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int i = tid; i < P * 12; i += nthreads) smats[i] = mats[i];
  __syncthreads();

  const int ly = tid / t.chunk;
  const int lx = tid - ly * t.chunk;
  const int tiles_y = g.L / t.ty;
  const int tiles_x = g.L / t.chunk;
  const int my_tiles = (n_tiles - 1 - static_cast<int>(blockIdx.x)) /
                           static_cast<int>(gridDim.x) + 1;
  const long long total = static_cast<long long>(my_tiles) * P;

  // Item s of this block: projection s % P of its (s / P)-th tile.
  auto tile_of = [&](long long s, int& zi, int& y0, int& x0) {
    const int tile = static_cast<int>(blockIdx.x) +
                     static_cast<int>(s / P) * static_cast<int>(gridDim.x);
    const int tx = tile % tiles_x;
    const int rest = tile / tiles_x;
    y0 = (rest % tiles_y) * t.ty;
    x0 = tx * t.chunk;
    zi = rest / tiles_y;
  };
  auto fetch = [&](long long s) {
    if (s < total) {
      int zi, y0, x0;
      tile_of(s, zi, y0, x0);
      const int p = static_cast<int>(s % P);
      const int2 o = corner_origin(smats + p * 12,
                                   bp::world(g.z0 + zi, g.O, g.MM), y0, x0,
                                   g, t);
      stage<Wire>(ring + (s % depth) * slot_words, stack, p, o.x, o.y, g,
                  t, tid, nthreads);
    }
    cp_async_commit();
  };

  for (int d = 0; d < depth - 1; ++d) fetch(d);
  float acc = 0.0f;
  size_t vidx = 0;
  for (long long s = 0; s < total; ++s) {
    __syncthreads();                 // slot (s - 1) % depth is free again
    fetch(s + depth - 1);
    cp_async_wait_dyn(depth - 1);    // item s has landed (this thread's)
    __syncthreads();                 // ... and every thread's

    int zi, y0, x0;
    tile_of(s, zi, y0, x0);
    const int p = static_cast<int>(s % P);
    const int y = y0 + ly;
    const int x = x0 + lx;
    if (p == 0) {
      vidx = (static_cast<size_t>(zi) * g.L + y) * g.L + x;
      acc = vol[vidx];
    }
    const float* A = smats + p * 12;
    const float wz = bp::world(g.z0 + zi, g.O, g.MM);
    const VoxelTap vt = voxel_tap(A, bp::world(x, g.O, g.MM),
                                  bp::world(y, g.O, g.MM), wz);
    const int2 o = corner_origin(A, wz, y0, x0, g, t);
    int rlo = o.x, rhi = o.x + t.band, clo = o.y, chi = o.y + t.width;
    if (kMicro) {
      // The run's micro window: the least strip-relative tap row and
      // column, each clipped into the strip, the origin clipped so the
      // window stays in the strip.
      int rel_r = min(max(vt.rr - o.x, 0), t.band - 1);
      int rel_c = min(max(vt.c - o.y, 0), t.width - 1);
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
      rlo = o.x + min(max(rel_r, 0), t.band - t.gband);
      clo = o.y + min(max(rel_c, 0), t.width - t.gwidth);
      rhi = rlo + t.gband;
      chi = clo + t.gwidth;
    }
    const Staged st{ring + (s % depth) * slot_words, o.x,
                    (o.y * Wire::kBytes) >> 2};
    acc = fold(acc, wire, st, g, t, p, vt, rlo, rhi, clo, chi);
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

// Dynamic shared memory of one block: the P x 12 matrices, the staged
// windows (depth slots, or the P-deep slab) and K4's reduction scratch.
// Mirrors repro_torch/kernels/backproject.py::strip_smem_bytes.
size_t smem_bytes(int kind, int P, const Tiling& t, int depth,
                  int warp_groups) {
  const size_t slots = kind == kShared ? P : depth;
  size_t n = mats_bytes(P) + slots * t.band * t.sw * 4;
  if (kind == kMicroKind && !warp_groups)
    n += static_cast<size_t>(2) * t.ty * t.chunk * 4;
  return n;
}

template <class Wire>
int launch(int kind, float* vol, const uint32_t* stack, const float* mats,
           const Wire& wire, int P, int nz, const Geo& g, const Tiling& t,
           int depth, cudaStream_t stream) {
  const int threads = t.ty * t.chunk;
  const int n_tiles = nz * (g.L / t.ty) * (g.L / t.chunk);
  const int warp_groups = kind == kMicroKind && 32 % t.group == 0;
  const size_t smem = smem_bytes(kind, P, t, depth, warp_groups);
  void (*ring)(float*, const uint32_t*, const float*, Wire, int, Geo,
               Tiling, int, int, int) =
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
        vol, stack, mats, wire, P, g, t);
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
  ring<<<blocks, threads, smem, stream>>>(vol, stack, mats, wire, P, g, t,
                                         depth, n_tiles, warp_groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, bound with ctypes.
//   kind:  0 K3 strip_db, 1 K4 strip_micro, 2 K5 strip_shared;
//   wire:  4 float32, 2 bfloat16, 1 int8 (the element size in bytes);
//   vol:   (nz, L, L) f32, its first plane the global plane z0;
//   stack: (P, rows, pitch_words) 32-bit words: the bordered images in
//          the wire's type, each row zero-padded to whole words;
//   scales (int8 only): (P, 2, rows) f32, [p][0] scale, [p][1] offset;
//   mats:  (P, 3, 4) f32.
// Every pointer on the device of `stream`.  Launches on `stream`,
// neither synchronises nor allocates, and returns a cudaError_t value
// (cudaErrorInvalidValue for a shape the kernels do not take).
extern "C" int backproject_strip_launch(
    int kind, int wire, void* vol, const void* stack, const void* scales,
    const void* mats, int P, int L, int nz, int z0, int rows, int cols,
    int pitch_words, int n_u, int n_v, float O, float MM, int ty, int chunk,
    int band, int width, int pad_rows, int pad_cols, int depth, int group,
    int gband, int gwidth, void* stream) {
  if (P < 1 || ty < 1 || chunk < 1 || L % ty || L % chunk ||
      ty * chunk > 1024 || band < 1 || width < 1 || depth < 2 || depth > 8 ||
      pad_rows < band || pad_cols < width ||
      (kind == kMicroKind &&
       (group < 1 || chunk % group || gband > band || gwidth > width ||
        gband < 1 || gwidth < 1)) ||
      kind < kDb || kind > kShared)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nz == 0) return 0;
  const int sw = (width * wire + 3) / 4 + 1;
  const Geo g{O, MM, L, z0, n_u, n_v, rows, cols, pitch_words};
  const Tiling t{ty, chunk, band, width, pad_rows, pad_cols, sw,
                 group, gband, gwidth};
  auto* v = static_cast<float*>(vol);
  auto* s = static_cast<const uint32_t*>(stack);
  auto* m = static_cast<const float*>(mats);
  auto st = static_cast<cudaStream_t>(stream);
  switch (wire) {
    case 4:
      return launch(kind, v, s, m, F32Wire{}, P, nz, g, t, depth, st);
    case 2:
      return launch(kind, v, s, m, Bf16Wire{}, P, nz, g, t, depth, st);
    case 1:
      return launch(kind, v, s, m,
                    Int8Wire{static_cast<const float*>(scales), rows}, P,
                    nz, g, t, depth, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
