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
// Design.  The features are independent: one thread owns one (batch row,
// feature) and keeps c, n, h, m in registers for the whole sequence.
// Each token reads four coalesced float32 gate values and writes one
// float32 h.  The dependency chain runs through the state only, so the
// gate loads of the next kAhead tokens are issued before the math of the
// current kAhead (two register buffers in turn): the GPU form of the
// Pallas kernel's chunked DMA into VMEM.  Every add, multiply and the
// divisions are round-to-nearest intrinsics in the plain version's order
// (no FMA contraction); expf, log1pf and tanhf are CUDA's accurate ones
// (no --use_fast_math), so the kernel agrees with its plain version to a
// few ulps a step.
//
// Bound: the bytes, zifo read (16 B) and h written (4 B) per token and
// feature, plus the states, over 3.35 TB/s -- but the S-long dependency
// chain of about 20 dependent operations a token (three exponentials, a
// log1p, a tanh, two divisions) bounds a short batch first: B di threads
// fill 12 of 132 SMs at B = 1, di = 1536.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kAhead = 8;
constexpr int kBlock = 128;

__device__ __forceinline__ float softplus_(float x) {
  // jax.nn.softplus is logaddexp(x, 0); torch.logaddexp's form.
  return __fadd_rn(fmaxf(x, 0.0f), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float sigmoid_(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

struct Cell {
  float r0, r1, r2, r3;
  float c, n, h, m;

  __device__ __forceinline__ void step(const float (&g)[4]) {
    const float z = tanhf(__fadd_rn(g[0], __fmul_rn(r0, h)));
    const float ig = __fadd_rn(g[1], __fmul_rn(r1, h));
    const float fg = __fadd_rn(g[2], __fmul_rn(r2, h));
    const float o = sigmoid_(__fadd_rn(g[3], __fmul_rn(r3, h)));
    const float logf_ = -softplus_(-fg);
    const float lm = __fadd_rn(logf_, m);
    const float m_new = fmaxf(lm, ig);
    const float dec = expf(__fsub_rn(lm, m_new));
    const float inc = expf(__fsub_rn(ig, m_new));
    c = __fadd_rn(__fmul_rn(c, dec), __fmul_rn(inc, z));
    n = __fadd_rn(__fmul_rn(n, dec), inc);
    h = __fdiv_rn(__fmul_rn(o, c), fmaxf(n, 1e-6f));
    m = m_new;
  }
};

// Gate pre-activations of tokens [t0, t0 + kAhead) into registers.
__device__ __forceinline__ void load_gates(float (&g)[kAhead][4],
                                           const float* __restrict__ base,
                                           int t0, int S, int di) {
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int t = t0 + k;
    if (t < S) {
      const float* p = base + static_cast<size_t>(t) * 4 * di;
#pragma unroll
      for (int q = 0; q < 4; ++q) g[k][q] = __ldg(p + static_cast<size_t>(q) * di);
    }
  }
}

__device__ __forceinline__ void run_gates(Cell& cell,
                                          const float (&g)[kAhead][4],
                                          float* __restrict__ hs, int t0,
                                          int S, int di) {
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int t = t0 + k;
    if (t < S) {
      cell.step(g[k]);
      hs[static_cast<size_t>(t) * di] = cell.h;
    }
  }
}

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
  cell.r0 = __ldg(r + j);
  cell.r1 = __ldg(r + di + j);
  cell.r2 = __ldg(r + 2 * di + j);
  cell.r3 = __ldg(r + 3 * di + j);
  cell.c = __ldg(state_in + i);
  cell.n = __ldg(state_in + bd + i);
  cell.h = __ldg(state_in + 2 * bd + i);
  cell.m = __ldg(state_in + 3 * bd + i);

  const float* base = zifo + static_cast<size_t>(b) * S * 4 * di + j;
  float* out = hs + static_cast<size_t>(b) * S * di + j;
  float g0[kAhead][4], g1[kAhead][4];
  load_gates(g0, base, 0, S, di);
  for (int t0 = 0; t0 < S; t0 += 2 * kAhead) {
    load_gates(g1, base, t0 + kAhead, S, di);
    run_gates(cell, g0, out, t0, S, di);
    load_gates(g0, base, t0 + 2 * kAhead, S, di);
    run_gates(cell, g1, out, t0 + kAhead, S, di);
  }

  state_out[i] = cell.c;
  state_out[bd + i] = cell.n;
  state_out[2 * bd + i] = cell.h;
  state_out[3 * bd + i] = cell.m;
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
  slstm_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(zifo), static_cast<const float*>(r),
      static_cast<const float*>(state_in), static_cast<float*>(hs),
      static_cast<float*>(state_out), B, S, di);
  return static_cast<int>(cudaGetLastError());
}
