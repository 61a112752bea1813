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
// Design.  A block owns kRows = 32 consecutive rows of the stack.
//   Pass 1: its kWarps warps each take a row at a time, the lanes along
//     the columns, so every load coalesces; min and max (or max |x|)
//     reduce by shuffles, exact in any order.  Lane 0 writes the row's
//     scale and offset.
//   Pass 2: warp 0 runs the 32 error-feedback chains, lane i along row
//     i.  The warp stages kTile-column tiles of its 32 rows in shared
//     memory with coalesced 4-byte cp.async copies (a row starts at any
//     4-byte offset, so 16-byte copies would not line up), two tiles in
//     flight; a pitch of kTile + 1 floats puts lane i's element j in
//     bank (i + j) % 32.  Each lane writes its codes to a shared tile
//     (pitch kTile + 4 bytes, conflict-free words) that the warp stores
//     coalesced, a row at a time.
// The chain's step keeps the plain version's values: every float
// operation an explicit round-to-nearest intrinsic in its order (no FMA
// contraction).  Only the code needs the quotient (xp - offset) / scale,
// and only through its rounding, so the step multiplies by the row's
// correctly rounded reciprocal and takes the IEEE division only where
// that product lies within kHalfMargin of a half-integer (a proven
// margin: see kHalfMargin), which takes the division's check and branch
// off the chain.  Rounding to the code clamps first and then adds and
// subtracts 1.5 * 2^23, which rounds half to even as rintf and
// torch.round do; clamp(rint(y)) = rint(clamp(y)) for the integer
// bounds +-127, and the sum's low byte is the code.  So codes, scales
// and offsets equal the plain version bitwise.
//
// Bound: the bytes, P rows cols (4 read + 1 written) + P rows 8, over
// 3.35 TB/s (about 7 us for a full-width P = 4 batch).  A row's chain
// is serial: cols dependent steps of add, subtract, multiply, clamp,
// round, multiply, add, subtract.  That latency, cols times the step's,
// is the floor a launch can approach when there are fewer rows than
// the card runs at once (3848 at P = 4); PERF.md gives it from the
// SASS and the card.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kEpsScale = 1e-30f;
constexpr float kRoundMagic = 12582912.0f;   // 1.5 * 2^23
// With a = xp - offset and b = scale, y = RN(a RN(1 / b)) differs from
// RN(a / b) by at most |a/b| (3 2^-24 + 2^-48): 2.29e-5 for |a/b| <=
// 128.01 (past that both clamp to +-127).  Where y lies further than
// this margin from every half-integer, both round to the same code.
constexpr float kHalfMargin = 3.0517578125e-5f;  // 2^-15
constexpr int kRows = 32;      // rows per block: one chain per lane
constexpr int kWarps = 8;      // warps of pass 1
constexpr int kTile = 64;      // columns per staged tile: two per lane
constexpr int kPitch = kTile + 1;
constexpr int kCodePitch = kTile + 4;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Pass 1 for one row, across the warp: its scale and offset.  Lane l
// folds columns l, l + 32, ... from 0 (a column past the row reads 0,
// which neither fold can move), kBatch loads in flight at a time; an
// xor butterfly then folds the lanes.
constexpr int kBatch = 8;

__device__ __forceinline__ void row_grid(const float* __restrict__ row,
                                         int cols, int lane, bool symmetric,
                                         float& scale, float& offset) {
  float lo = 0.0f, hi = 0.0f;
  for (int c0 = lane; c0 < cols; c0 += 32 * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = c0 + 32 * u;
      v[u] = c < cols ? __ldg(row + c) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (symmetric) {
        hi = fmaxf(hi, fabsf(v[u]));
      } else {
        lo = fminf(lo, v[u]);
        hi = fmaxf(hi, v[u]);
      }
    }
  }
  for (int o = 16; o; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (symmetric) {
    scale = __fdiv_rn(fmaxf(hi, kEpsScale), 127.0f);
    offset = 0.0f;
  } else {
    scale = __fdiv_rn(fmaxf(__fsub_rn(hi, lo), kEpsScale), 254.0f);
    offset = __fadd_rn(lo, __fmul_rn(127.0f, scale));
  }
}

// The code step's rounding from the IEEE quotient a / scale, for a
// product near a half-integer: 1.5 * 2^23 plus the clamped, rounded
// quotient.  A call of its own, out of the chain's loop.
__device__ __noinline__ float exact_round(float a, float scale) {
  return __fadd_rn(fminf(fmaxf(__fdiv_rn(a, scale), -127.0f), 127.0f),
                   kRoundMagic);
}

__global__ void __launch_bounds__(32 * kWarps)
quantize_rows_kernel(const float* __restrict__ x, int8_t* __restrict__ codes,
                     float* __restrict__ scales, int n_rows, int rows,
                     int cols, int symmetric) {
  __shared__ float sgrid[2][kRows];                 // scale, offset
  __shared__ float tile[2][kRows * kPitch];
  __shared__ int8_t out[kRows * kCodePitch];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;
  const int nr = min(kRows, n_rows - row0);
  const float* const base = x + static_cast<size_t>(row0) * cols;

  for (int i = warp; i < nr; i += kWarps) {
    float scale, offset;
    row_grid(base + static_cast<size_t>(i) * cols, cols, lane, symmetric,
             scale, offset);
    if (lane == 0) {
      sgrid[0][i] = scale;
      sgrid[1][i] = offset;
      const int g = row0 + i;
      const int p = g / rows;
      const int r = g - p * rows;
      scales[(static_cast<size_t>(p) * 2) * rows + r] = scale;
      scales[(static_cast<size_t>(p) * 2 + 1) * rows + r] = offset;
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // Pass 2: lane i runs row i's chain (lanes past the last row idle).
  const bool mine = lane < nr;
  const float scale = mine ? sgrid[0][lane] : 1.0f;
  const float offset = mine ? sgrid[1][lane] : 0.0f;
  const float rscale = __frcp_rn(scale);
  const int n_tiles = (cols + kTile - 1) / kTile;
  // Tile t of the block's rows into tile[t & 1]: lane l copies columns
  // l and l + 32 of each row, the warp a row's 64 columns at a time.
  auto stage = [&](int t) {
    const int c0 = t * kTile;
    const bool a0 = lane < cols - c0, a1 = lane + 32 < cols - c0;
    const float* src = base + c0 + lane;
    float* dst = tile[t & 1] + lane;
#pragma unroll 4
    for (int i = 0; i < nr; ++i) {
      if (a0) cp_async4(dst, src);
      if (a1) cp_async4(dst + 32, src + 32);
      src += cols;
      dst += kPitch;
    }
    cp_async_commit();
  };

  float err = 0.0f;
  stage(0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int c0 = t * kTile;
    const int nc = min(kTile, cols - c0);
    if (mine) {
      const float* in = tile[t & 1] + lane * kPitch;
      int8_t* code = out + lane * kCodePitch;
      for (int j = 0; j < nc; ++j) {
        const float xp = __fadd_rn(in[j], err);
        const float a = __fsub_rn(xp, offset);
        const float y = __fmul_rn(a, rscale);
        float m = __fadd_rn(fminf(fmaxf(y, -127.0f), 127.0f), kRoundMagic);
        float q = __fsub_rn(m, kRoundMagic);
        float e = __fsub_rn(xp, __fadd_rn(__fmul_rn(q, scale), offset));
        // The residual is formed before the check's branch, which then
        // runs beside the chain instead of in it.
        asm volatile("" : "+f"(e));
        if (fabsf(__fsub_rn(fabsf(__fsub_rn(y, q)), 0.5f)) < kHalfMargin) {
          m = exact_round(a, scale);
          q = __fsub_rn(m, kRoundMagic);
          e = __fsub_rn(xp, __fadd_rn(__fmul_rn(q, scale), offset));
        }
        code[j] = static_cast<int8_t>(__float_as_int(m));
        err = e;
      }
    }
    __syncwarp();
    // The tile's codes, a row's 64 columns per warp store.
    const bool a0 = lane < nc, a1 = lane + 32 < nc;
    int8_t* dst = codes + static_cast<size_t>(row0) * cols + c0 + lane;
    const int8_t* src = out + lane;
#pragma unroll 8
    for (int i = 0; i < nr; ++i) {
      const int8_t b0 = src[0], b1 = src[32];
      if (a0) dst[0] = b0;
      if (a1) dst[32] = b1;
      dst += cols;
      src += kCodePitch;
    }
    __syncwarp();
  }
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
  const int grid = (n_rows + kRows - 1) / kRows;
  quantize_rows_kernel<<<grid, 32 * kWarps, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(codes),
      static_cast<float*>(scales), n_rows, rows, cols, symmetric);
  return static_cast<int>(cudaGetLastError());
}
