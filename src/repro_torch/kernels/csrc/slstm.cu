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
// backward kernel), not of the forward kernel's base-2 arithmetic.  Each
// step is recomputed in float32 (tanh, the exponentials and log1p from
// the SFU, see tanh_sfu) from the state the training forward saved at
// t - 1 (the initial state at t = 0) and the gates, and the gradients
// dc, dn, dm, dh are carried back through
//
//   h' = o c' / max(n', 1e-6)      (a tie of max gives half, as JAX)
//   c' = c ea + eb z,  n' = n ea + eb,  ea = exp(a - m'), eb = exp(i - m')
//   m' = max(a, i),  a = logf + m  (a tie gives each side half)
//   logf = -softplus(-f):  d logf / d f = sigmoid(-f)
//
// One of ea, eb is exp(0) = 1 and the other exp(-|a - i|): one
// exponential.  sigmoid(-f) comes from the e^-|f| that log1p takes, and
// the three reciprocals (the two sigmoids, 1 / max(n', 1e-6)) take the
// SFU's approximation and one Newton step, their arguments being in [1,
// 2] or at least 1e-6.  From a fresh state (m = -inf)
// the first step has ea = 0 and c = n = 0, so every term that carries
// the -inf is multiplied by an exact 0 of a finite value: no 0 * inf.
// The final state carries no gradient (the autograd Function marks it
// so), and none is taken into the initial state (the wrapper refuses a
// state that wants one).
//
// What the design uses: a step is affine in its carry.  With dH = dh +
// dhs_t, the carry (dc, dn, dm, dh) that leaves a step is a linear map
// of the one that enters it plus dhs_t times that map's dh column, with
// coefficients from the gates and the saved state alone (back_step
// below).  So T steps compose into one 4 x 4 map and a vector, and no
// chunk's map depends on another chunk.
//
// Design: a block-local chunked scan.  A block owns 32 chains (one
// warp's width: each lane one (batch row, feature), so every load and
// store of a warp is 128 contiguous bytes where di % 32 == 0) and kBwdW
// warps, and walks its chains' sequence in pieces of kBwdW kBwdT tokens,
// the latest piece first.  In a piece, warp w owns chunk w (kBwdT
// tokens):
// 1. Stage.  The warp copies its chunk's inputs into shared memory once
//    (cp.async): the four gates, the saved (c, n, m) and h of the step
//    before, and dhs, kBwdIn = 9 floats a token and chain.  It copies
//    the next piece's token k into slot k as soon as phase 3 has read
//    the slot, so the next piece's loads fly during this piece's replay
//    (a second buffer would cost the SM its third block).
// 2. Phase 1, in parallel.  The warp composes its chunk's map from
//    shared memory, latest token first: it recomputes the step (every
//    transcendental and reciprocal of the backward) and applies it to
//    the map's four columns (unit carries, no dhs) and to its vector
//    (from zero, with dhs).  It writes the step's five expensive values
//    (tanh, the two sigmoids, the stabiliser's branch and exponential,
//    1 / max(n', 1e-6)) over the gates and m it no longer needs.  No
//    warp waits on another.
// 3. Phase 2, short and serial.  Warp 0 walks the kBwdW maps, latest
//    chunk first, from the carry the later piece left in its registers,
//    and writes the carry that enters each chunk: kBwdW mat-vecs of 16
//    FMAs.  The carry it reaches is the next piece's.
// 4. Phase 3, in parallel.  Each warp replays its chunk from its carry,
//    step by step with the literal derivative, from shared memory and
//    phase 1's values (a few multiplies a step, no transcendental); it
//    writes d zifo (streaming stores) and adds d(pre-activation) h to
//    its d r partial.  The carried chain is FMAs only.
// The serial path of a piece is about 2 kBwdT steps and kBwdW hops, not
// kBwdW kBwdT steps.  Rounding differs from a step-by-step walk only at
// the chunk borders, whose carries come from composed maps.
//
// W and T.  A block's shared memory is its staging (kBwdW kBwdT tokens x
// 9 floats x 32 chains) and its maps (kBwdW x 20 floats x 32 chains; the
// carries written in phase 2 reuse them).  kBwdW = 8, kBwdT = 6 needs
// 75,776 bytes, so three blocks fit an SM's 228 KB: 24 warps an SM,
// and at the training path's B di = 8 x 1536 chains the 384 blocks run
// in one wave on 132 SMs (kBwdT = 8 fits two: 1.45 waves; on the H100
// it takes ~5 % longer at (8, 2048) and ~11 % at (8, 64), ~6 % less at
// B = 1, S = 512).  The path's S = 64 is a piece of 16 tokens, then one
// of 48.
//
// d r sums d(pre-activation) h over the batch and the sequence.  Each
// warp adds its chunks' terms, in reverse token order, piece after
// piece; at the end warp 0 adds the kBwdW warps' sums in warp order
// into a partial per (batch row, gate, feature); a second kernel adds
// the B partials of each (gate, feature) in batch order.  No atomics:
// the result is the same bits from run to run.
//
// Its bound is the bytes of the function: per token and feature the
// gates (16 B) and dh (4 B) read and d zifo (16 B) written.  This design
// also reads the previous h (4 B) and the saved state (12 B), which the
// training forward wrote (12 B), and does phase 1's composition beside
// the function's operations.
#ifndef SLSTM_BWD_W
#define SLSTM_BWD_W 8
#endif
#ifndef SLSTM_BWD_T
#define SLSTM_BWD_T 6
#endif
constexpr int kBwdW = SLSTM_BWD_W;   // warps a block: the chunks of a piece
constexpr int kBwdT = SLSTM_BWD_T;   // tokens a chunk
constexpr int kBwdIn = 9;            // staged floats a token and chain
constexpr int kBwdMap = 20;          // a map's floats: 4 columns and a vector
constexpr int kBwdPiece = kBwdW * kBwdT;
constexpr int kBwdStage = kBwdPiece * kBwdIn * 32;   // floats
constexpr int kBwdSmem = (kBwdStage + kBwdW * kBwdMap * 32) *
                         static_cast<int>(sizeof(float));

// Half the gradient at a tie of max(x, y), to each side, as JAX and
// PyTorch split it.
__device__ __forceinline__ float share(float x, float y) {
  return x > y ? 1.0f : (x == y ? 0.5f : 0.0f);
}

// One step's coefficients: with dH = dh + dhs, dcn = dc + al dH and dnn
// = dn + ga dH (the gradients of c' and n'),
//   dA = P dcn + Q dnn,  dB = R dcn + eb dnn   (P = c ea, Q = n ea,
//                                                 R = z eb)
//   dmn = dm - dA - dB,  da = dA + sa dmn,  d i = dB + si dmn
//   d z = ka dcn (ka = eb (1 - z^2)),  d f = sg da,  d o = la dH
// and the carry before the step is (ea dcn, ea dnn, da, r . d).  K0, K2,
// K3 fold r0, r2, r3 into ka, sg, la for the map's columns.
struct Back {
  float al, ga, P, Q, R, ea, eb, sa, si, ka, sg, la, K0, K2, K3;
};

// 1 / x for x in [1e-6, 2^126): the SFU's reciprocal (rcp.approx.ftz,
// within 1 ulp) and one Newton step, without the IEEE division's test
// and slow path.  Every argument here is 1 + e (e in [0, 1]) or max(n',
// 1e-6).
__device__ __forceinline__ float recip(float x) {
  const float y = rcp(x);
  return y * (2.0f - x * y);
}

// The step's exponentials (of x <= 0) and log(1 + x) (x in [0, 1]) come
// from the SFU (__expf, __logf: ex2.approx, lg2.approx, within 2 ulp,
// and 2^-22 absolute for the logarithm), and tanh(x) = sign(x) (1 - e) /
// (1 + e), e = exp(-2|x|), as the forward takes it (within ~2e-7
// absolute).  A step's a = log f + m then differs by under an ulp of m,
// and ea, eb, the gates by a few ulps: far inside the 2e-4 the backward
// is held to, and m itself is read from the forward's states, so nothing
// compounds along the sequence (IEEE expf, log1pf and tanhf take 4 %
// longer at (8, 2048) on the H100).
__device__ __forceinline__ float tanh_sfu(float x) {
  const float e = __expf(-2.0f * fabsf(x));
  return copysignf((1.0f - e) * recip(1.0f + e), x);
}

// The stabiliser's branch in one float: q = -e where a > i, e where a <
// i, -2 at a tie, e = exp(-|a - i|) in [0, 1].  ea = exp(a - m') and eb =
// exp(i - m') are 1 and e in some order, and the shares of the tie
// follow from the sign.
__device__ __forceinline__ float branch(float a, float ig) {
  const float e = __expf(-fabsf(a - ig));
  return a > ig ? -e : (a == ig ? -2.0f : e);
}

// The cheap part of a step's coefficients, from its expensive values
// (z = tanh, o = sigmoid, sg = sigmoid(-f), q = branch, rn = 1 /
// max(n', 1e-6)) and the state before it.
__device__ __forceinline__ Back coefs(float z, float o, float sg, float q,
                                      float rn, float c, float n, float r0,
                                      float r2, float r3) {
  Back s;
  const bool tie = q == -2.0f;
  const bool gt = signbit(q) && !tie;
  s.ea = gt || tie ? 1.0f : q;
  s.eb = gt ? -q : 1.0f;
  s.sa = tie ? 0.5f : (gt ? 1.0f : 0.0f);
  s.si = 1.0f - s.sa;
  const float cn = c * s.ea + s.eb * z;
  const float nn = n * s.ea + s.eb;
  s.al = o * rn;                                // d h' / d c'
  const float be = cn * rn;                     // d h' / d o
  s.ga = -(s.al * be) * share(nn, 1e-6f);       // d h' / d n'
  s.la = be * (o * (1.0f - o));                 // d h' / d o's input
  s.P = c * s.ea;
  s.Q = n * s.ea;
  s.R = z * s.eb;
  s.ka = s.eb * (1.0f - z * z);
  s.sg = sg;
  s.K0 = r0 * s.ka;
  s.K2 = r2 * sg;
  s.K3 = r3 * s.la;
  return s;
}

// Phase 1's recomputation of the step whose inputs lie at p[q * 32], q =
// zi, ii, fi, oi, c, n, m, h (dhs at q = 8): the step's coefficients, and
// its expensive values written over the gates and m (z, o, sg, q, rn at
// q = 0, 1, 2, 3, 6) for phase 3.
__device__ __forceinline__ Back recompute(float* p, float r0, float r1,
                                          float r2, float r3) {
  const float c = p[4 * 32], n = p[5 * 32], m = p[6 * 32], h = p[7 * 32];
  const float z = tanh_sfu(p[0] + r0 * h);
  const float ig = p[32] + r1 * h;
  const float fg = p[2 * 32] + r2 * h;
  // sigmoid(x) = 1 / (1 + e) for x >= 0, e / (1 + e) below, e = exp(-|x|).
  const float ox = p[3 * 32] + r3 * h;
  const float eo = __expf(-fabsf(ox));
  const float ro = recip(1.0f + eo);
  const float o = ox >= 0.0f ? ro : eo * ro;
  // logf = -softplus(-f) = -(max(-f, 0) + log1p(e)), e = exp(-|f|);
  // d logf / d f = sigmoid(-f), from the same e.
  const float ef = __expf(-fabsf(fg));
  const float logf = -(fmaxf(-fg, 0.0f) + __logf(1.0f + ef));
  const float rf = recip(1.0f + ef);
  const float sg = fg >= 0.0f ? ef * rf : rf;
  const float q = branch(logf + m, ig);
  const bool gt = signbit(q) && q != -2.0f;
  const float ea = gt || q == -2.0f ? 1.0f : q;
  const float eb = gt ? -q : 1.0f;
  const float rn = recip(fmaxf(n * ea + eb, 1e-6f));
  p[0] = z;
  p[32] = o;
  p[2 * 32] = sg;
  p[3 * 32] = q;
  p[6 * 32] = rn;
  return coefs(z, o, sg, q, rn, c, n, r0, r2, r3);
}

// Phase 3's coefficients from what phase 1 left at p.
__device__ __forceinline__ Back replayed(const float* p, float r0, float r2,
                                         float r3) {
  return coefs(p[0], p[32], p[2 * 32], p[3 * 32], p[6 * 32], p[4 * 32],
               p[5 * 32], r0, r2, r3);
}

// The carry (dc, dn, dm, dh): the gradient of the state after a step.
struct Carry {
  float c, n, m, h;
};

// Phase 3: the carry into the step before, from the carry after it and
// dhs; the step's d(pre-activations) (z, i, f, o) in d.
__device__ __forceinline__ Carry back_step(const Back& s, const Carry& v,
                                           float dhs, float r0, float r1,
                                           float r2, float r3,
                                           float (&d)[4]) {
  const float dH = v.h + dhs;
  const float dcn = v.c + s.al * dH;
  const float dnn = v.n + s.ga * dH;
  const float dA = s.P * dcn + s.Q * dnn;
  const float dB = s.R * dcn + s.eb * dnn;
  const float dmn = v.m - dA - dB;
  const float da = dA + s.sa * dmn;
  d[0] = s.ka * dcn;
  d[1] = dB + s.si * dmn;
  d[2] = s.sg * da;
  d[3] = s.la * dH;
  return {s.ea * dcn, s.ea * dnn, da,
          r0 * d[0] + r1 * d[1] + r2 * d[2] + r3 * d[3]};
}

// Phase 1: the same map on a column of the chunk's map (dH = dh, no
// dhs) or on its vector (dH = dh + dhs), with r folded into K0, K2, K3.
__device__ __forceinline__ Carry map_step(const Back& s, const Carry& v,
                                          float dH, float r1) {
  const float dcn = v.c + s.al * dH;
  const float dnn = v.n + s.ga * dH;
  const float dA = s.P * dcn + s.Q * dnn;
  const float dB = s.R * dcn + s.eb * dnn;
  const float dmn = v.m - dA - dB;
  const float da = dA + s.sa * dmn;
  return {s.ea * dcn, s.ea * dnn, da,
          s.K0 * dcn + r1 * (dB + s.si * dmn) + s.K2 * da + s.K3 * dH};
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :
               : "r"(s), "l"(src)
               : "memory");
}

// Copy token t's inputs for chain i = (b, j) into the slot at dst: the
// gates and dhs, and the saved state and h of token t - 1 (the initial
// state for t = 0).
__device__ __forceinline__ void stage_step(
    float* dst, int t, const float* __restrict__ zifo,
    const float* __restrict__ states, const float* __restrict__ hs,
    const float* __restrict__ state_in, const float* __restrict__ dhs,
    size_t row, long long i, size_t bd, int di, int j) {
  const float* g = zifo + (row + t) * 4 * di + j;
#pragma unroll
  for (int q = 0; q < 4; ++q) cp_async4(dst + q * 32, g + q * di);
  if (t > 0) {
    const float* st = states + (row + t - 1) * 3 * di + j;
    cp_async4(dst + 4 * 32, st);
    cp_async4(dst + 5 * 32, st + di);
    cp_async4(dst + 6 * 32, st + 2 * di);
    cp_async4(dst + 7 * 32, hs + (row + t - 1) * di + j);
  } else {
    cp_async4(dst + 4 * 32, state_in + i);
    cp_async4(dst + 5 * 32, state_in + bd + i);
    cp_async4(dst + 6 * 32, state_in + 3 * bd + i);
    cp_async4(dst + 7 * 32, state_in + 2 * bd + i);
  }
  cp_async4(dst + 8 * 32, dhs + (row + t) * di + j);
}

__global__ void __launch_bounds__(32 * kBwdW, 3) slstm_backward_kernel(
    const float* __restrict__ zifo, const float* __restrict__ r,
    const float* __restrict__ state_in, const float* __restrict__ hs,
    const float* __restrict__ states, const float* __restrict__ dhs,
    float* __restrict__ dzifo, float* __restrict__ dr_part, int B, int S,
    int di) {
  extern __shared__ float smem[];
  float* stage = smem;                      // [token][9][lane]
  float* maps = smem + kBwdStage;           // [warp][20][lane]
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long i = static_cast<long long>(blockIdx.x) * 32 + lane;
  const bool live = i < static_cast<long long>(B) * di;
  const int b = live ? static_cast<int>(i / di) : 0;
  const int j = live ? static_cast<int>(i - static_cast<long long>(b) * di)
                     : 0;
  const size_t bd = static_cast<size_t>(B) * di;
  const float r0 = live ? __ldg(r + j) : 0.0f;
  const float r1 = live ? __ldg(r + di + j) : 0.0f;
  const float r2 = live ? __ldg(r + 2 * di + j) : 0.0f;
  const float r3 = live ? __ldg(r + 3 * di + j) : 0.0f;
  const size_t row = static_cast<size_t>(b) * S;
  float* mine = stage + w * kBwdT * kBwdIn * 32 + lane;   // my chunk's
  float* map = maps + w * kBwdMap * 32 + lane;

  Carry v = {0.0f, 0.0f, 0.0f, 0.0f};      // warp 0: the piece's carry
  float dr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int pieces = (S + kBwdPiece - 1) / kBwdPiece;
  for (int p = pieces - 1; p >= 0; --p) {
    const int t0 = p * kBwdPiece + w * kBwdT;    // my chunk's first token
    const int n = max(0, min(kBwdT, S - t0));    // its tokens below S
    // 1. Stage my chunk (the latest piece; the others were staged during
    // the piece before, in phase 3).
    if (live && p == pieces - 1)
      for (int k = 0; k < n; ++k)
        stage_step(mine + k * kBwdIn * 32, t0 + k, zifo, states, hs,
                   state_in, dhs, row, i, bd, di, j);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
    // 2. Phase 1: my chunk's map, latest token first.
    {
      Carry col[4] = {{1.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f, 0.0f},
                      {0.0f, 0.0f, 1.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 1.0f}};
      Carry vec = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = kBwdT - 1; k >= 0; --k) {
        if (k < n) {
          float* in = mine + k * kBwdIn * 32;
          const Back s = recompute(in, r0, r1, r2, r3);
#pragma unroll
          for (int c = 0; c < 4; ++c) col[c] = map_step(s, col[c], col[c].h, r1);
          vec = map_step(s, vec, vec.h + in[8 * 32], r1);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        map[(4 * c) * 32] = col[c].c;
        map[(4 * c + 1) * 32] = col[c].n;
        map[(4 * c + 2) * 32] = col[c].m;
        map[(4 * c + 3) * 32] = col[c].h;
      }
      map[16 * 32] = vec.c;
      map[17 * 32] = vec.n;
      map[18 * 32] = vec.m;
      map[19 * 32] = vec.h;
    }
    __syncthreads();
    // 3. Phase 2: the carry into each chunk, latest chunk first.
    if (w == 0) {
      for (int c = kBwdW - 1; c >= 0; --c) {
        float* m = maps + c * kBwdMap * 32 + lane;
        float a[kBwdMap];
#pragma unroll
        for (int e = 0; e < kBwdMap; ++e) a[e] = m[e * 32];
        m[0] = v.c;
        m[32] = v.n;
        m[2 * 32] = v.m;
        m[3 * 32] = v.h;
        Carry u;
        u.c = a[16] + v.c * a[0] + v.n * a[4] + v.m * a[8] + v.h * a[12];
        u.n = a[17] + v.c * a[1] + v.n * a[5] + v.m * a[9] + v.h * a[13];
        u.m = a[18] + v.c * a[2] + v.n * a[6] + v.m * a[10] + v.h * a[14];
        u.h = a[19] + v.c * a[3] + v.n * a[7] + v.m * a[11] + v.h * a[15];
        v = u;
      }
    }
    __syncthreads();
    // 4. Phase 3: replay my chunk from its carry.
    Carry u = {map[0], map[32], map[2 * 32], map[3 * 32]};
#pragma unroll
    for (int k = kBwdT - 1; k >= 0; --k) {
      if (k < n) {
        const float* in = mine + k * kBwdIn * 32;
        const Back s = replayed(in, r0, r2, r3);
        float d[4];
        u = back_step(s, u, in[8 * 32], r0, r1, r2, r3, d);
        if (live) {
          const float h = in[7 * 32];
          float* q = dzifo + (row + t0 + k) * 4 * di + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            __stcs(q + g * di, d[g]);
            dr[g] += d[g] * h;
          }
        }
      }
      // The slot is read (the stores above wait on its values): stage
      // the next piece's token k into it while the replay goes on.
      if (live && p > 0)
        stage_step(mine + k * kBwdIn * 32, t0 - kBwdPiece + k, zifo,
                   states, hs, state_in, dhs, row, i, bd, di, j);
    }
  }
  // d r: each warp's sum, then the warps' in order.
  __syncthreads();
#pragma unroll
  for (int g = 0; g < 4; ++g) map[g * 32] = dr[g];
  __syncthreads();
  if (w == 0 && live) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int c = 0; c < kBwdW; ++c)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[g] += maps[(c * kBwdMap + g) * 32 + lane];
    float* part = dr_part + static_cast<size_t>(b) * 4 * di + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) part[static_cast<size_t>(g) * di] = acc[g];
  }
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
  cudaError_t err = cudaFuncSetAttribute(
      slstm_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long chains = static_cast<long long>(B) * di;
  slstm_backward_kernel<<<static_cast<unsigned>((chains + 31) / 32),
                          32 * kBwdW, kBwdSmem, st>>>(
      static_cast<const float*>(zifo), static_cast<const float*>(r),
      static_cast<const float*>(state_in), static_cast<const float*>(hs),
      static_cast<const float*>(states), static_cast<const float*>(dhs),
      static_cast<float*>(dzifo), static_cast<float*>(dr_part), B, S, di);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = 4 * di;
  slstm_dr_kernel<<<(n + kBlock - 1) / kBlock, kBlock, 0, st>>>(
      static_cast<const float*>(dr_part), static_cast<float*>(dr), B, n);
  return static_cast<int>(cudaGetLastError());
}

// The backward's layout on the current device: out[0] = kBwdW warps a
// block, out[1] = kBwdT tokens a chunk, out[2] = shared bytes a block,
// out[3] = blocks an SM can hold.  Returns a cudaError_t value.
extern "C" int slstm_backward_config(int* out) {
  out[0] = kBwdW;
  out[1] = kBwdT;
  out[2] = kBwdSmem;
  cudaError_t err = cudaFuncSetAttribute(
      slstm_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBwdSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[3], slstm_backward_kernel, 32 * kBwdW, kBwdSmem);
  return static_cast<int>(err);
}
