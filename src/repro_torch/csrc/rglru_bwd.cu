// RG-LRU linear-recurrence scan, backward, for Hopper (sm_90a), plain C
// interface.
//
// Replaces no TPU kernel: the reference trains recurrentgemma through XLA's
// autodiff of its plain scan (src/repro/models/rglru.py, `rglru_scan`).  It
// is the gradient of the forward kernel in csrc/rglru.cu (which replaces
// `rglru_scan_kernel` in src/repro/kernels/rglru/kernel.py) behind the
// custom op `repro_torch::rglru_bwd` (kernels/library.py).
//
// The forward, per batch row b and feature lane d:
//   h_t = a_t h_{t-1} + s(a_t) x_t,  s(a) = sqrt(max(1 - a^2, 1e-12)),
// h_{-1} = init or 0; its outputs are h and a copy of h's last step.  The
// backward is the reverse recurrence
//   g_t = dh_t + a_{t+1} g_{t+1}   (plus dh_last at the last step),
//   dx_t = g_t s(a_t),  da_t = g_t h_{t-1} + g_t x_t s'(a_t),  dinit = a_0 g_0,
// with s'(a) = -a / s(a) where 1 - a^2 > 1e-12 and 0 elsewhere (the
// reference's maximum: src/repro/models/rglru.py).  h_{t-1} is read from the
// forward's output h (and init at t = 0), so nothing is recomputed.
// 1 - a^2 is rounded as the forward rounds it (__fmul_rn, no fused
// multiply-add).
//
// Variant `seq` (rglru_bwd_seq_kernel, the only one): one thread owns one
// (row, lane) and walks the S steps backward, the loads of U steps issued
// ahead of their updates; neighbouring threads take neighbouring lanes, so
// every load and store is coalesced across a warp.
//
// What bounds it on an H100: the bytes.  x, a, h and dh read and dx, da
// written once in fp32, 24 bytes an element: 201 MB at recurrentgemma-9b's
// train shape (B=1, S=2048, D=4096), 0.060 ms at 3.35 TB/s; its ~12
// operations an element take a fifth of that at the fp32 peak.  As the
// forward's `seq` variant, 4,096 threads each walk 2,048 dependent steps
// there, so it is latency-bound; the forward's `chunked` look-back, run in
// reverse, is the later option.
//
// Layout: x, a (B, S, D) with row strides (sxb, sxs), (sab, sas) and unit
// stride over D; h, dh (B, S, D) fp32 contiguous; init, dh_last (B, D) fp32
// contiguous or null (zeros).  Outputs dx, da (B, S, D) and dinit (B, D)
// fp32 contiguous.  B up to 65535.  The launch uses the caller's stream,
// allocates nothing, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;   // lanes per block
constexpr int U = 8;           // steps whose loads are issued together

struct Step {
  float a, x, dh, hp;
};

__device__ __forceinline__ void update(float& g, const Step& s, float* dx, float* da) {
  g += s.dh;
  const float one = 1.0f - __fmul_rn(s.a, s.a);
  const float sa = sqrtf(fmaxf(one, 1e-12f));
  const float ds = one > 1e-12f ? -s.a / sa : 0.0f;
  *dx = g * sa;
  *da = fmaf(g, s.hp, g * s.x * ds);
  g *= s.a;
}

__global__ void __launch_bounds__(THREADS)
rglru_bwd_seq_kernel(const float* __restrict__ x, const float* __restrict__ a,
                     const float* __restrict__ h, const float* __restrict__ init,
                     const float* __restrict__ dh, const float* __restrict__ dh_last,
                     float* __restrict__ dx, float* __restrict__ da, float* __restrict__ dinit,
                     int S, int D, long long sxb, long long sxs, long long sab, long long sas) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= D) return;
  const float* xp = x + b * sxb + d;
  const float* ap = a + b * sab + d;
  const size_t row = (size_t)b * S * D + d;   // (b, 0, d) of the contiguous tensors
  const float h0 = init ? init[(size_t)b * D + d] : 0.0f;
  auto load = [&](int t) {
    Step s;
    s.a = __ldg(ap + t * sas);
    s.x = __ldg(xp + t * sxs);
    s.dh = __ldg(dh + row + (size_t)t * D);
    s.hp = t > 0 ? __ldg(h + row + (size_t)(t - 1) * D) : h0;
    return s;
  };
  float g = dh_last ? dh_last[(size_t)b * D + d] : 0.0f;
  int t = S - 1;
  for (; t + 1 >= U; t -= U) {   // steps t, t-1, ..., t-U+1
    Step st[U];
#pragma unroll
    for (int u = 0; u < U; ++u) st[u] = load(t - u);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t o = row + (size_t)(t - u) * D;
      update(g, st[u], dx + o, da + o);
    }
  }
  for (; t >= 0; --t) {
    const size_t o = row + (size_t)t * D;
    update(g, load(t), dx + o, da + o);
  }
  dinit[(size_t)b * D + d] = g;
}

}  // namespace

// variant 0: `seq` (the only one).
extern "C" int rglru_backward(const float* x, const float* a, const float* h, const float* init,
                              const float* dh, const float* dh_last, float* dx, float* da,
                              float* dinit, int B, int S, int D, long long sxb, long long sxs,
                              long long sab, long long sas, int variant, void* stream) {
  if (B < 0 || S < 1 || D < 1 || B > 65535 || variant != 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  rglru_bwd_seq_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, a, h, init, dh, dh_last, dx, da, dinit, S, D, sxb, sxs, sab, sas);
  return (int)cudaGetLastError();
}
