// Dependent-operation latencies and the SM clock of one CUDA card, for
// tools/kernel_census.py's chain floors.
//
// One warp (all 32 lanes, as a kernel's warps run) runs chains of kN
// dependent operations between two clock64 reads: an FFMA, an FADD, MUFU.EX2 (ex2.approx.ftz of -x), 1 + rcp(x)
// (MUFU.RCP then an FADD: the compiler folds rcp(rcp(x)) to x) and
// ex2(-lg2(x)) (MUFU.LG2 then MUFU.EX2), and then spins for kSpin cycles
// between two reads of both clock64 and the global nanosecond timer,
// which gives the SM clock.  Each chain keeps its value in range
// (x -> x/2 + 1/4, x + 1, 2^-x, 1 + 1/x, 1/x).

#include <cuda_runtime.h>

namespace {

constexpr int kN = 512;
constexpr long long kSpin = 1LL << 22;

__device__ __forceinline__ long long ns_now() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void probe(long long* out, float seed) {
  long long v[9];
  float x = seed;
  long long t0 = clock64();
#pragma unroll
  for (int i = 0; i < kN; ++i)
    asm volatile("fma.rn.f32 %0, %0, 0f3F000000, 0f3E800000;" : "+f"(x));
  long long t1 = clock64();
  v[0] = t1 - t0;
  float a = x;
  t0 = clock64();
#pragma unroll
  for (int i = 0; i < kN; ++i)
    asm volatile("add.rn.f32 %0, %0, 0f3F800000;" : "+f"(a));
  t1 = clock64();
  v[1] = t1 - t0;
  float e = x;
  t0 = clock64();
#pragma unroll
  for (int i = 0; i < kN; ++i)
    asm volatile("{ .reg .f32 t; neg.f32 t, %0; ex2.approx.ftz.f32 %0, t; }"
                 : "+f"(e));
  t1 = clock64();
  v[2] = t1 - t0;
  float r = x + 1.0f;
  t0 = clock64();
#pragma unroll
  for (int i = 0; i < kN; ++i)
    asm volatile("{ .reg .f32 t; rcp.approx.ftz.f32 t, %0; "
                 "add.rn.f32 %0, t, 0f3F800000; }" : "+f"(r));
  t1 = clock64();
  v[3] = t1 - t0;
  float l = x + 1.0f;
  t0 = clock64();
#pragma unroll
  for (int i = 0; i < kN; ++i)
    asm volatile("{ .reg .f32 t; lg2.approx.ftz.f32 t, %0; neg.f32 t, t; "
                 "ex2.approx.ftz.f32 %0, t; }" : "+f"(l));
  t1 = clock64();
  v[4] = t1 - t0;
  const long long n0 = ns_now();
  t0 = clock64();
  while (clock64() - t0 < kSpin) {
  }
  t1 = clock64();
  const long long n1 = ns_now();
  v[5] = t1 - t0;
  v[6] = n1 - n0;
  v[7] = kN;
  // Keep every chain's value live.
  v[8] = static_cast<long long>(x + a + e + r + l);
  if (threadIdx.x == 0)
    for (int i = 0; i < 9; ++i) out[i] = v[i];
}

}  // namespace

// out: 9 int64 on the device of `stream`: cycles of the FFMA, FADD, EX2,
// RCP+FADD and LG2+EX2 chains, the spin's cycles and nanoseconds, kN, and a
// sink.  Returns cudaGetLastError().
extern "C" int latency_probe(void* out, void* stream) {
  probe<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out), 0.5f);
  return static_cast<int>(cudaGetLastError());
}
