// The sLSTM recurrence for Hopper (sm_90a).
//
// Replaces, on the card, the TPU kernel repro/kernels/slstm.py::slstm_kernel
// (via slstm_pallas and the wrapper slstm_ops.py::fused_slstm_forward):
// the exponential-gated, log-space-stabilised sLSTM cell of
// repro/models/ssm.py::_slstm_cell iterated over the sequence,
//
//   z = tanh(z_in + r0 h)          i = i_in + r1 h
//   f = f_in + r2 h                o = sigmoid(o_in + r3 h)
//   logf = -softplus(-f),  softplus(x) = max(x, 0) + log1p(exp(-|x|))
//   m' = max(logf + m, i)
//   c' = c exp(logf + m - m') + exp(i - m') z
//   n' = n exp(logf + m - m') + exp(i - m')
//   h' = o c' / max(n', 1e-6)
//
// with the gates' pre-activations zifo (B, S, 4, di) float32 and the
// diagonal recurrence weights r (4, di).  Beyond the TPU kernel it takes
// an initial state (4, B, di) = (c, n, h, m), m = -inf for a fresh
// sequence (the reference scan's start), and writes the final state, so
// that a prefill fills the decode cache and a decode step is a launch at
// S = 1 from the cached state.
//
// What bounds it.  The features are independent, but each (batch row,
// feature) is a chain of S dependent steps through its state; at the
// model's widths (B di = 1536 to 12288 chains) every chain has a warp
// scheduler nearly to itself, so a launch takes about S times the
// latency of one step's dependent path from h to the next h, not its
// bytes (zifo read once, h written once: 20 B a token and feature).
//
// Design: shorten that path.
// * One exponential for the two decays.  With d = (logf + m) - i, the
//   stabiliser m' is one of the two operands, so one of exp(logf + m -
//   m') and exp(i - m') is exp(0) = 1 and the other exp(-|d|): a select
//   gives the same values (the fresh state's m = -inf too: d = -inf,
//   dec = 0, inc = 1).
// * Every transcendental from the special-function unit, through
//   ex2/lg2/rcp.approx.ftz (PTX), each exponent -|x| <= 0 so nothing
//   overflows: logf = min(f, 0) - log1p(exp(-|f|)); tanh and sigmoid
//   from exp(-|x|) and one reciprocal, then the sign; h through one
//   reciprocal.  Not tanh.approx (relative error 2^-11, over the 2e-4
//   tolerance).  The build keeps IEEE arithmetic elsewhere (no
//   --use_fast_math): only this file asks for approximations.
// * log1p(e) as lg2(1 + e) only for e >= 2^-5; below (f > 3.4, a long
//   memory) from four terms of its series.  lg2's absolute error (2^-22)
//   is a relative error of the forget gate there, and it compounds along
//   the memory: over 2048 tokens at f = 12 it would move the final c and
//   n past the tolerance (h not, as c and n move alike).
// * The stabiliser in base-2 units.  The thread keeps m log2(e) and
//   scales r and the gates by log2(e) (the z gate by 2 log2(e)), so the
//   pre-activations go to ex2 with no multiply on the path; the final m
//   is scaled back.  The path from h to the next h: the f gate's FMA,
//   ex2, add, lg2, add (the series' FMAs beside them), select, the
//   difference d, ex2, select, n's FMA, max, rcp, the product: 13
//   operations, 4 of them in the SFU.  z, o, c and min(f, 0) + m run
//   beside it.  In the SASS (tools/kernel_census.py) the compiler turns
//   the first select into a compare that predicates the two log1p forms:
//   14 operations, ~112 cycles at the H100's measured latencies, 56 ns
//   at 1.98 GHz; a step takes 1.8-2.2 times that.
// The SFU's other errors (2 ulp for ex2 and rcp) stay far inside the
// tolerance (tests/test_torch_slstm_design.py emulates this order with
// the errors injected).
//
// Layout.  One thread owns one (batch row, feature) and keeps c, n, h, m
// in registers for the whole sequence; blocks of 128 threads (blocks of
// 32, which spread B = 1 over 48 SMs, timed no faster).  Each token reads
// four coalesced float32 gate values and writes one float32 h, both
// streaming (__ldcs, __stcs: evict first, as each is touched once).  The
// loads of the next kAhead = 8 tokens are issued before the math of the
// current 8 (two register buffers in turn: the GPU form of the Pallas
// kernel's chunked DMA into VMEM; 16 timed slower, as its larger body
// costs more than its depth saves).  Where zifo outgrows the L2
// (kPrefetchFromBytes), the launch takes the instance that also
// prefetches the gates kPrefetch tokens beyond into the L2.  The steady
// loop runs whole pairs of chunks with no bounds test; the last tokens,
// and the whole of a launch at S = 1 (a decode step), run through the
// tested loop.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kAhead = 8;
constexpr int kPrefetch = 16;   // tokens between an L2 prefetch and its load
// The launch prefetches into the L2 from this many bytes of zifo.  Below
// it the gates stay in the 50 MB L2 (the gate projection wrote them there
// just before), and prefetches only cost issue slots: (2, 512) x 1536
// (25 MB) ran faster without them, (4, 512) (50 MB) and (8, 2048) with.
constexpr long long kPrefetchFromBytes = 32LL << 20;
constexpr int kBlock = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// log2(1 + e) = e (kL1 + e (kL2 + e (kL3 + e kL4))) + O(e^5) for small e.
constexpr float kL1 = kLog2e;
constexpr float kL2 = -0.5f * kLog2e;
constexpr float kL3 = kLog2e / 3.0f;
constexpr float kL4 = -0.25f * kLog2e;
constexpr float kSeriesMax = 0.03125f;   // 2^-5: truncation < 2^-20 e

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void prefetch_l2(const float* p) {
  asm volatile("prefetch.global.L2 [%0];" : : "l"(p));
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The state in base-2 units: r0 carries 2 log2(e) (tanh's exponent),
// r1..r3 and m carry log2(e).
struct Cell {
  float r0, r1, r2, r3;
  float c, n, h, m;

  __device__ __forceinline__ void step(const float (&g)[4]) {
    const float zx = fmaf(r0, h, g[0] * (2.0f * kLog2e));
    const float ig = fmaf(r1, h, g[1] * kLog2e);
    const float fx = fmaf(r2, h, g[2] * kLog2e);
    const float ox = fmaf(r3, h, g[3] * kLog2e);
    // tanh(x) = sign(x) (1 - e) / (1 + e), e = exp(-2|x|).
    const float ez = ex2(-fabsf(zx));
    const float z = copysignf((1.0f - ez) * rcp(1.0f + ez), zx);
    // sigmoid(x) = 1 / (1 + e) for x >= 0, e / (1 + e) below, e = exp(-|x|).
    const float eo = ex2(-fabsf(ox));
    const float so = rcp(1.0f + eo);
    const float o = ox >= 0.0f ? so : eo * so;
    // log2(f) + m = (min(f, 0) + m) - log2(1 + e), e = 2^-|f|: below
    // kSeriesMax (a long memory) from four terms of the series, where
    // lg2's absolute error would compound along the sequence.
    const float ef = ex2(-fabsf(fx));
    const float q = fminf(fx, 0.0f) + m;
    const float t = fmaf(fmaf(fmaf(ef, kL4, kL3), ef, kL2), ef, kL1);
    const float lm = ef < kSeriesMax ? fmaf(-ef, t, q)
                                     : q - lg2(1.0f + ef);
    const float d = lm - ig;
    const float e = ex2(-fabsf(d));
    const bool keep = d >= 0.0f;     // m' = lm: dec = 1, inc = e
    const float dec = keep ? 1.0f : e;
    const float inc = keep ? e : 1.0f;
    m = keep ? lm : ig;
    c = fmaf(c, dec, inc * z);
    n = fmaf(n, dec, inc);
    h = (o * c) * rcp(fmaxf(n, 1e-6f));
  }
};

// Gate pre-activations of tokens [t0, t0 + kAhead) into registers; with
// kTested, only those below S.  With kPrefetchL2 (untested: the steady
// loop), it also prefetches the gates kPrefetch tokens further on into
// the L2 (the last token where that passes S).
template <bool kTested, bool kPrefetchL2>
__device__ __forceinline__ void load_gates(float (&g)[kAhead][4],
                                           const float* __restrict__ base,
                                           int t0, int S, int di) {
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int t = t0 + k;
    if (!kTested || t < S) {
      const float* p = base + static_cast<size_t>(t) * 4 * di;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        g[k][q] = __ldcs(p + static_cast<size_t>(q) * di);
      if (kPrefetchL2) {
        const float* f =
            base + static_cast<size_t>(min(t + kPrefetch, S - 1)) * 4 * di;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          prefetch_l2(f + static_cast<size_t>(q) * di);
      }
    }
  }
}

template <bool kTested>
__device__ __forceinline__ void run_gates(Cell& cell,
                                          const float (&g)[kAhead][4],
                                          float* __restrict__ hs, int t0,
                                          int S, int di) {
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int t = t0 + k;
    if (!kTested || t < S) {
      cell.step(g[k]);
      __stcs(hs + static_cast<size_t>(t) * di, cell.h);
    }
  }
}

template <bool kPrefetchL2>
__global__ void slstm_kernel(const float* __restrict__ zifo,
                             const float* __restrict__ r,
                             const float* __restrict__ state_in,
                             float* __restrict__ hs,
                             float* __restrict__ state_out, int B, int S,
                             int di) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(B) * di) return;
  const int b = static_cast<int>(i / di);
  const int j = static_cast<int>(i - static_cast<long long>(b) * di);
  const size_t bd = static_cast<size_t>(B) * di;

  Cell cell;
  cell.r0 = __ldg(r + j) * (2.0f * kLog2e);
  cell.r1 = __ldg(r + di + j) * kLog2e;
  cell.r2 = __ldg(r + 2 * di + j) * kLog2e;
  cell.r3 = __ldg(r + 3 * di + j) * kLog2e;
  cell.c = __ldg(state_in + i);
  cell.n = __ldg(state_in + bd + i);
  cell.h = __ldg(state_in + 2 * bd + i);
  cell.m = __ldg(state_in + 3 * bd + i) * kLog2e;

  const float* base = zifo + static_cast<size_t>(b) * S * 4 * di + j;
  float* out = hs + static_cast<size_t>(b) * S * di + j;
  float g0[kAhead][4], g1[kAhead][4];
  load_gates<true, false>(g0, base, 0, S, di);
  int t0 = 0;
  // Steady state: every token of this pair of chunks and of the next
  // chunk lies below S.
  for (; t0 + 3 * kAhead <= S; t0 += 2 * kAhead) {
    load_gates<false, kPrefetchL2>(g1, base, t0 + kAhead, S, di);
    run_gates<false>(cell, g0, out, t0, S, di);
    load_gates<false, kPrefetchL2>(g0, base, t0 + 2 * kAhead, S, di);
    run_gates<false>(cell, g1, out, t0 + kAhead, S, di);
  }
  for (; t0 < S; t0 += 2 * kAhead) {
    load_gates<true, false>(g1, base, t0 + kAhead, S, di);
    run_gates<true>(cell, g0, out, t0, S, di);
    load_gates<true, false>(g0, base, t0 + 2 * kAhead, S, di);
    run_gates<true>(cell, g1, out, t0 + kAhead, S, di);
  }

  state_out[i] = cell.c;
  state_out[bd + i] = cell.n;
  state_out[2 * bd + i] = cell.h;
  state_out[3 * bd + i] = cell.m * kLn2;
}

}  // namespace

// Plain C entry point, bound with ctypes.  zifo: (B, S, 4, di) f32;
// r: (4, di) f32; state_in, state_out: (4, B, di) f32 (c, n, h, m);
// hs: (B, S, di) f32; all contiguous on the device of `stream`, state_out
// apart from state_in.  Launches on `stream`, neither synchronises nor
// allocates, and returns cudaGetLastError().
extern "C" int slstm_launch(const void* zifo, const void* r,
                            const void* state_in, void* hs, void* state_out,
                            int B, int S, int di, void* stream) {
  const long long threads = static_cast<long long>(B) * di;
  const long long blocks = (threads + kBlock - 1) / kBlock;
  const bool prefetch =
      threads * S * 4 * static_cast<long long>(sizeof(float)) >=
      kPrefetchFromBytes;
  decltype(&slstm_kernel<false>) kernel =
      prefetch ? &slstm_kernel<true> : &slstm_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(zifo), static_cast<const float*>(r),
      static_cast<const float*>(state_in), static_cast<float*>(hs),
      static_cast<float*>(state_out), B, S, di);
  return static_cast<int>(cudaGetLastError());
}
