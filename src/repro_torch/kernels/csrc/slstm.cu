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
// S = 1 from the cached state.  For training, slstm_train_kernel runs
// the same recurrence and also keeps each step's state, and
// slstm_backward_kernel (row 10b, below) takes the gradient back.
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
constexpr int kBack = 8;       // backward steps whose loads go out together
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

// With kSave (the training forward) each step also writes the state it
// reached, (c, n, m) with m in natural units, to states (B, S, 3, di):
// what the backward kernel reads to take each step's derivative.
template <bool kTested, bool kSave>
__device__ __forceinline__ void run_gates(Cell& cell,
                                          const float (&g)[kAhead][4],
                                          float* __restrict__ hs,
                                          float* __restrict__ st, int t0,
                                          int S, int di) {
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int t = t0 + k;
    if (!kTested || t < S) {
      cell.step(g[k]);
      __stcs(hs + static_cast<size_t>(t) * di, cell.h);
      if (kSave) {
        float* p = st + static_cast<size_t>(t) * 3 * di;
        p[0] = cell.c;
        p[di] = cell.n;
        p[2 * di] = cell.m * kLn2;
      }
    }
  }
}

template <bool kPrefetchL2, bool kSave>
__device__ __forceinline__ void recurrence(const float* __restrict__ zifo,
                                           const float* __restrict__ r,
                                           const float* __restrict__ state_in,
                                           float* __restrict__ hs,
                                           float* __restrict__ state_out,
                                           float* __restrict__ states,
                                           int B, int S, int di) {
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
  float* st = kSave ? states + static_cast<size_t>(b) * S * 3 * di + j
                    : nullptr;
  float g0[kAhead][4], g1[kAhead][4];
  load_gates<true, false>(g0, base, 0, S, di);
  int t0 = 0;
  // Steady state: every token of this pair of chunks and of the next
  // chunk lies below S.
  for (; t0 + 3 * kAhead <= S; t0 += 2 * kAhead) {
    load_gates<false, kPrefetchL2>(g1, base, t0 + kAhead, S, di);
    run_gates<false, kSave>(cell, g0, out, st, t0, S, di);
    load_gates<false, kPrefetchL2>(g0, base, t0 + 2 * kAhead, S, di);
    run_gates<false, kSave>(cell, g1, out, st, t0 + kAhead, S, di);
  }
  for (; t0 < S; t0 += 2 * kAhead) {
    load_gates<true, false>(g1, base, t0 + kAhead, S, di);
    run_gates<true, kSave>(cell, g0, out, st, t0, S, di);
    load_gates<true, false>(g0, base, t0 + 2 * kAhead, S, di);
    run_gates<true, kSave>(cell, g1, out, st, t0 + kAhead, S, di);
  }

  state_out[i] = cell.c;
  state_out[bd + i] = cell.n;
  state_out[2 * bd + i] = cell.h;
  state_out[3 * bd + i] = cell.m * kLn2;
}

// The served recurrence (tools/kernel_census.py reads its chain floor
// from the instances of this name).
template <bool kPrefetchL2>
__global__ void slstm_kernel(const float* __restrict__ zifo,
                             const float* __restrict__ r,
                             const float* __restrict__ state_in,
                             float* __restrict__ hs,
                             float* __restrict__ state_out, int B, int S,
                             int di) {
  recurrence<kPrefetchL2, false>(zifo, r, state_in, hs, state_out, nullptr,
                                 B, S, di);
}

// The training forward: the same recurrence, writing each step's state.
template <bool kPrefetchL2>
__global__ void slstm_train_kernel(const float* __restrict__ zifo,
                                   const float* __restrict__ r,
                                   const float* __restrict__ state_in,
                                   float* __restrict__ hs,
                                   float* __restrict__ state_out,
                                   float* __restrict__ states, int B, int S,
                                   int di) {
  recurrence<kPrefetchL2, true>(zifo, r, state_in, hs, state_out, states,
                                B, S, di);
}

// ---------------------------------------------------------------------
// The backward (kernel row 10b): the gradient of the recurrence with
// respect to the gates and r, given the gradient of the hidden states.
//
// It is the literal derivative of repro/models/ssm.py::_slstm_cell (the
// function jax.grad differentiates in the reference, which has no
// backward kernel), not of the forward kernel's base-2 arithmetic.  A
// thread owns one (batch row, feature), as in the forward, and walks
// the sequence in reverse.  At step t it recomputes the step's
// intermediates in IEEE float32 (tanhf, expf, log1pf) from the state
// the training forward saved at t - 1 (the initial state at t = 0) and
// the gates, then carries dc, dn, dh and dm back through
//
//   h' = o c' / max(n', 1e-6)      (a tie of max gives half, as JAX)
//   c' = c ea + eb z,  n' = n ea + eb,  ea = exp(a - m'), eb = exp(i - m')
//   m' = max(a, i),  a = logf + m  (a tie gives each side half)
//   logf = -softplus(-f):  d logf / d f = sigmoid(-f)
//
// From a fresh state (m = -inf) the first step has ea = 0 and c = n =
// 0, so d ea = 0, the stabiliser picks i, and every term that carries
// the -inf is multiplied by an exact 0 of a finite value: no 0 * inf.
// The final state carries no gradient (the autograd Function marks it
// so), and none is taken into the initial state (the wrapper refuses a
// state that wants one).
//
// d r sums d(pre-activation) h over the batch and the sequence.  Each
// thread sums its chain's terms in reverse token order into a partial
// per (batch row, gate, feature); a second kernel adds the B partials
// of each (gate, feature) in batch order.  No atomics: the result is
// the same bits from run to run.
//
// Its bound is the bytes of the function: per token and feature the
// gates (16 B) and dh (4 B) read and d zifo (16 B) written.  This design
// also reads the previous h (4 B) and the saved state (12 B), which the
// training forward wrote (12 B).  What holds it back is latency, as in
// the forward: B di chains, a few warps an SM, and each step's
// recomputation (IEEE tanhf, expf, log1pf, two divisions) is a path the
// warp waits through.  The loads of kBack steps go out before their
// math, and the recomputation does not depend on the carried
// gradients (only dc, dn, dh, dm cross steps), so the compiler may
// overlap it with the previous step's chain.
struct Step {
  float z, o, ig, fg, a, mn, ea, eb, cn, nn;
};

__device__ __forceinline__ Step recompute(float zi, float ii, float fi,
                                          float oi, float r0, float r1,
                                          float r2, float r3, float c,
                                          float n, float h, float m) {
  Step s;
  s.z = tanhf(zi + r0 * h);
  s.ig = ii + r1 * h;
  s.fg = fi + r2 * h;
  s.o = 1.0f / (1.0f + expf(-(oi + r3 * h)));
  // softplus(-f) = max(-f, 0) + log1p(exp(-|f|))
  const float logf = -(fmaxf(-s.fg, 0.0f) + log1pf(expf(-fabsf(s.fg))));
  s.a = logf + m;
  s.mn = fmaxf(s.a, s.ig);
  s.ea = expf(s.a - s.mn);
  s.eb = expf(s.ig - s.mn);
  s.cn = c * s.ea + s.eb * s.z;
  s.nn = n * s.ea + s.eb;
  return s;
}

// Half the gradient at a tie of max(x, y), to each side, as JAX and
// PyTorch split it.
__device__ __forceinline__ float share(float x, float y) {
  return x > y ? 1.0f : (x == y ? 0.5f : 0.0f);
}

__global__ void slstm_backward_kernel(
    const float* __restrict__ zifo, const float* __restrict__ r,
    const float* __restrict__ state_in, const float* __restrict__ hs,
    const float* __restrict__ states, const float* __restrict__ dhs,
    float* __restrict__ dzifo, float* __restrict__ dr_part, int B, int S,
    int di) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(B) * di) return;
  const int b = static_cast<int>(i / di);
  const int j = static_cast<int>(i - static_cast<long long>(b) * di);
  const size_t bd = static_cast<size_t>(B) * di;
  const float r0 = __ldg(r + j), r1 = __ldg(r + di + j),
              r2 = __ldg(r + 2 * di + j), r3 = __ldg(r + 3 * di + j);
  const float c0 = __ldg(state_in + i), n0 = __ldg(state_in + bd + i),
              h0 = __ldg(state_in + 2 * bd + i),
              m0 = __ldg(state_in + 3 * bd + i);
  const size_t row = static_cast<size_t>(b) * S;
  const float* zb = zifo + row * 4 * di + j;
  const float* hb = hs + row * di + j;
  const float* sb = states + row * 3 * di + j;
  const float* db = dhs + row * di + j;
  float* gb = dzifo + row * 4 * di + j;

  float dc = 0.0f, dn = 0.0f, dh = 0.0f, dm = 0.0f;
  float dr0 = 0.0f, dr1 = 0.0f, dr2 = 0.0f, dr3 = 0.0f;
  // kBack steps at a time, latest first: every load of the chunk (the
  // gates, the previous state and h, dh) is issued before its math.
  for (int t1 = S; t1 > 0; t1 -= kBack) {
    float in[kBack][9];
#pragma unroll
    for (int k = 0; k < kBack; ++k) {
      const int t = t1 - 1 - k;
      if (t < 0) continue;
      const float* g = zb + static_cast<size_t>(t) * 4 * di;
#pragma unroll
      for (int q = 0; q < 4; ++q) in[k][q] = __ldcs(g + q * di);
      in[k][8] = __ldcs(db + static_cast<size_t>(t) * di);
      if (t > 0) {
        const float* p = sb + static_cast<size_t>(t - 1) * 3 * di;
        in[k][4] = __ldcs(p);
        in[k][5] = __ldcs(p + di);
        in[k][6] = __ldcs(p + 2 * di);
        in[k][7] = __ldcs(hb + static_cast<size_t>(t - 1) * di);
      } else {
        in[k][4] = c0;
        in[k][5] = n0;
        in[k][6] = m0;
        in[k][7] = h0;
      }
    }
#pragma unroll
    for (int k = 0; k < kBack; ++k) {
      const int t = t1 - 1 - k;
      if (t < 0) continue;
      const float c = in[k][4], n = in[k][5], m = in[k][6], h = in[k][7];
      const Step s = recompute(in[k][0], in[k][1], in[k][2], in[k][3], r0,
                               r1, r2, r3, c, n, h, m);
      const float dH = in[k][8] + dh;
      // h' = (o c') / max(n', 1e-6)
      const float nc = fmaxf(s.nn, 1e-6f);
      const float d_o = dH * s.cn / nc;
      const float dcn = dc + dH * s.o / nc;
      const float dnc = -dH * (s.o * s.cn) / (nc * nc);
      const float dnn = dn + dnc * share(s.nn, 1e-6f);
      // c' = c ea + eb z, n' = n ea + eb
      const float dea = dcn * c + dnn * n;
      const float deb = dcn * s.z + dnn;
      const float dz = dcn * s.eb;
      dc = dcn * s.ea;
      dn = dnn * s.ea;
      // ea = exp(a - m'), eb = exp(i - m'), m' = max(a, i)
      const float dA = dea * s.ea;
      const float dB = deb * s.eb;
      const float dmn = dm - dA - dB;
      const float da = dA + dmn * share(s.a, s.ig);
      const float dig = dB + dmn * share(s.ig, s.a);
      dm = da;
      // a = logf + m, logf = -softplus(-f): d logf / d f = sigmoid(-f)
      const float dfg = da / (1.0f + expf(s.fg));
      const float dzp = dz * (1.0f - s.z * s.z);
      const float dop = d_o * s.o * (1.0f - s.o);
      float* q = gb + static_cast<size_t>(t) * 4 * di;
      __stcs(q, dzp);
      __stcs(q + di, dig);
      __stcs(q + 2 * di, dfg);
      __stcs(q + 3 * di, dop);
      dr0 += dzp * h;
      dr1 += dig * h;
      dr2 += dfg * h;
      dr3 += dop * h;
      dh = dzp * r0 + dig * r1 + dfg * r2 + dop * r3;
    }
  }
  float* part = dr_part + static_cast<size_t>(b) * 4 * di + j;
  part[0] = dr0;
  part[di] = dr1;
  part[2 * di] = dr2;
  part[3 * di] = dr3;
}

// d r[k] = the B partials of (gate, feature) k, added in batch order.
__global__ void slstm_dr_kernel(const float* __restrict__ dr_part,
                                float* __restrict__ dr, int B, int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  float acc = 0.0f;
  for (int b = 0; b < B; ++b) acc += dr_part[static_cast<size_t>(b) * n + k];
  dr[k] = acc;
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

// The training forward: as slstm_launch, and also writes each step's
// state (c, n, m) to states (B, S, 3, di) f32.
extern "C" int slstm_train_launch(const void* zifo, const void* r,
                                  const void* state_in, void* hs,
                                  void* state_out, void* states, int B,
                                  int S, int di, void* stream) {
  const long long threads = static_cast<long long>(B) * di;
  const long long blocks = (threads + kBlock - 1) / kBlock;
  const bool prefetch =
      threads * S * 4 * static_cast<long long>(sizeof(float)) >=
      kPrefetchFromBytes;
  decltype(&slstm_train_kernel<false>) kernel =
      prefetch ? &slstm_train_kernel<true> : &slstm_train_kernel<false>;
  kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(zifo), static_cast<const float*>(r),
      static_cast<const float*>(state_in), static_cast<float*>(hs),
      static_cast<float*>(state_out), static_cast<float*>(states), B, S, di);
  return static_cast<int>(cudaGetLastError());
}

// The backward.  zifo, r, state_in as the forward took them; hs and
// states as slstm_train_launch wrote them; dhs (B, S, di) the gradient
// of the hidden states.  Writes dzifo (B, S, 4, di) and dr (4, di),
// through the scratch dr_part (B, 4, di); all f32, contiguous, on the
// device of `stream`.  Two launches in order on `stream`; returns
// cudaGetLastError() after each.
extern "C" int slstm_backward_launch(const void* zifo, const void* r,
                                     const void* state_in, const void* hs,
                                     const void* states, const void* dhs,
                                     void* dzifo, void* dr_part, void* dr,
                                     int B, int S, int di, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  const long long threads = static_cast<long long>(B) * di;
  slstm_backward_kernel<<<static_cast<unsigned>((threads + kBlock - 1) /
                                                kBlock),
                          kBlock, 0, st>>>(
      static_cast<const float*>(zifo), static_cast<const float*>(r),
      static_cast<const float*>(state_in), static_cast<const float*>(hs),
      static_cast<const float*>(states), static_cast<const float*>(dhs),
      static_cast<float*>(dzifo), static_cast<float*>(dr_part), B, S, di);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = 4 * di;
  slstm_dr_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, st>>>(
      static_cast<const float*>(dr_part), static_cast<float*>(dr), B, n);
  return static_cast<int>(cudaGetLastError());
}
