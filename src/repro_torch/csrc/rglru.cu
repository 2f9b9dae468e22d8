// RG-LRU linear-recurrence scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `rglru_scan_kernel` (body `_rglru_kernel`)
// in src/repro/kernels/rglru/kernel.py, with the b = sqrt(1 - a^2) x of its
// wrapper (src/repro/kernels/rglru/ops.py).  Per batch row b and feature
// lane d:
//   h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) x_t,   h_{-1} = init or 0.
//
// The TPU kernel solves each 16-step time block as an (L x L) log-space
// decay-weighted sum per lane, because the TPU has no cheap per-lane
// sequential loop.  A CUDA thread has one, so here each thread owns one
// (row, lane), keeps the state in a register and walks t in order: the same
// recurrence, with no log/exp and no L^2 work.
//
// Beyond the TPU kernel it does what the model path needs:
//   * b is formed in registers from a and x (the TPU wrapper does that in
//     XLA before the kernel).  1 - a*a is rounded as the plain version
//     rounds it (__fmul_rn: no fused multiply-add), since near a = 1 the
//     difference is a large share of 1 - a^2;
//   * an optional fp32 initial state (B, D) (null means zeros), which
//     serving needs to continue from a cache;
//   * any S and D: lanes past D idle, no padding;
//   * x and a read through row strides (B, S, D) with unit stride over D.
// The final state is h[:, S-1]; steps past a row's valid length arrive as
// identity steps (a = 1, x = 0), so the kernel needs no lengths.
//
// Layout: a block of THREADS consecutive lanes of one row; lanes are
// contiguous over D, so one step's loads of a and x and its store of h are
// coalesced across a warp.  h (B, S, D) fp32 contiguous.
//
// What bounds it on an H100.  The bytes: a and x read and h written once in
// fp32, 100.7 MB at recurrentgemma-9b prefill (B=1, S=2048, D=4096),
// 0.030 ms at 3.35 TB/s.  This first design is simple and right, not fast:
// it is latency-bound.  At B=1, D=4096 there are 4,096 lanes (32 blocks on
// 132 SMs) and 2,048 dependent steps; the loads of U steps are issued
// before their updates (they do not depend on h), so U loads per thread are
// in flight at a time.  The later speed work is a split over time:
// chunk-local scans in parallel plus a pass that carries the state across
// chunks.
//
// The launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;   // lanes per block
constexpr int U = 8;           // steps whose loads are issued together

__device__ __forceinline__ float step(float state, float at, float xt) {
  const float bt = __fmul_rn(sqrtf(fmaxf(1.0f - __fmul_rn(at, at), 1e-12f)), xt);
  return fmaf(at, state, bt);
}

__global__ void __launch_bounds__(THREADS)
rglru_kernel(const float* __restrict__ x, const float* __restrict__ a,
             const float* __restrict__ init, float* __restrict__ h, int S, int D,
             long long sxb, long long sxs, long long sab, long long sas) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const float* xp = x + b * sxb + d;
  const float* ap = a + b * sab + d;
  float* hp = h + (size_t)b * S * D + d;
  float state = init ? init[(size_t)b * D + d] : 0.0f;
  int t = 0;
  for (; t + U <= S; t += U) {
    float av[U], xv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      av[u] = __ldg(ap + (t + u) * sas);
      xv[u] = __ldg(xp + (t + u) * sxs);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      state = step(state, av[u], xv[u]);
      hp[(size_t)(t + u) * D] = state;
    }
  }
  for (; t < S; ++t) {
    state = step(state, __ldg(ap + t * sas), __ldg(xp + t * sxs));
    hp[(size_t)t * D] = state;
  }
}

}  // namespace

extern "C" int rglru_forward(const float* x, const float* a, const float* init, float* h, int B,
                             int S, int D, long long sxb, long long sxs, long long sab,
                             long long sas, void* stream) {
  if (B < 0 || S < 1 || D < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  rglru_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, a, init, h, S, D, sxb, sxs, sab, sas);
  return (int)cudaGetLastError();
}
