// Mamba-2 SSD chunked scan, backward, for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the reference trains mamba2 through XLA's autodiff
// of its plain chunked scan (src/repro/models/ssm.py, `ssd_chunked`).  It is
// the gradient of the forward kernel in csrc/ssd.cu (which replaces `ssd_bh`
// in src/repro/kernels/ssd/kernel.py) behind the custom op
// `repro_torch::ssd_bwd` (kernels/library.py).
//
// Per (batch row b, head h), with a_t = exp(dt_t A), the forward is
//   h_t = a_t h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t,   h_{-1} = init or 0,
// a (P, N) state; B and C (N,) are shared by the heads.  Its gradient runs
// backward: g_t = dL/dh_t = dy_t C_t^T + a_{t+1} g_{t+1}, from dstate.
// Over chunks of L = 64 steps, cum the inclusive prefix sum of dt A in the
// chunk and last its end, the backward is the forward's three passes
// reversed (kernels/ssd/ref.py:ssd_bwd_ref is this algorithm in torch):
//
//   1. ssd_bwd_chunk_state_kernel, grid (chunk, head, row): the chunk
//      state S_c = sum_j e^(last - cum_j) dt_j x_j B_j^T and the gradient
//      state D_c = sum_s e^(cum_s) dy_s C_s^T, both (P, N) fp32, and
//      cum_last.
//   2. ssd_bwd_state_pass_kernel, one thread per (row, head, p, n),
//      sequential over chunks only: forward, h_in[c] = h, h = e^(last_c) h
//      + S_c from init (in place of S_c); backward, R_c = r, r = e^(last_c)
//      r + D_c from dstate (in place of D_c); dinit = r at the end.  R_c is
//      the gradient reaching chunk c's last step from later steps.
//   3. ssd_bwd_chunk_kernel, grid (chunk, head, row): everything inside a
//      chunk from h_in[c] and R_c.  With E_ij = e^(cum_i - cum_j) (j <= i,
//      masked before the exp), W = C B^T o E, M = dy x^T o E:
//        u_t  = sum_{s>=t} W_st dy_s + e^(last - cum_t) R B_t;  dx_t = dt_t u_t
//        dC_t = e^(cum_t) h_in^T dy_t + sum_{j<=t} M_tj dt_j B_j       (per head)
//        dB_t = dt_t (sum_{s>=t} M_st C_s + e^(last - cum_t) R^T x_t)  (per head)
//      and the decays' gradient dda_t = a_t <g_t, h_{t-1}> as four sums,
//      none of which cancels (rowsum minus colsum of T would, by e^35 at A
//      = -50, where the diagonal dominates and drops out exactly):
//        z_t  = sum_{i>=t} sum_{j<t} T_ij, T = W o dy x^T o dt_j (a prefix
//               along each row, then a suffix down each column);
//        + sum_{k>=t} e_k, e_k = dC_inter_k . C_k (the inter-chunk term);
//        + sum_{j<t} v_j,  v_j = dB_R_j . B_j (the chunk-end term);
//        + e^(last) <R, h_in>;
//      ddt_t = x_t . u_t + A dda_t, and the chunk's share of dA,
//      sum_t dt_t dda_t.
//   4. ssd_bwd_reduce_kernel: dB and dC summed over the heads in a fixed
//      order from per-head fp32 partials (no float atomics: two runs agree
//      bitwise), written in the inputs' dtype; ssd_bwd_da_kernel sums dA's
//      per-(row, chunk) partials.
//
// What bounds it on an H100: at mamba2-2.7b's train shape (B=1, S=2048,
// H=80, P=64, N=128, bf16) the bytes it must move are x, dy, dx (21 MB
// each), B, C, dB, dC and dt, ddt (~6 MB): ~0.02 ms at 3.35 TB/s, and
// ~21.5 GFLOP of products at the chunk (the count kernel.cost_bwd
// reports), ~0.02-0.05 ms on the tensor cores.  This
// first design runs every product on the CUDA cores in fp32 (register
// tiles of 4 x 4 or 4 x 8 out of shared memory), so the products bound it
// at ~0.3 ms and more; tensor cores are later work.  Its scratch (the
// wrapper allocates it per call): the chunk states and the gradient states,
// (B, n_chunks, H, P, N) fp32 each (84 MB each there), cum_last and dA's
// partials (B, n_chunks, H), and dB's and dC's per-head partials (B, S, H,
// N) fp32 (84 MB each there).
//
// Layout: x (B, S, H, P) with strides (sxb, sxs, P, 1); dt (B, S, H), dy
// (B, S, H, P) contiguous; A (H,); B/C (B, S, N) with strides (s?b, s?s, 1);
// init, dstate (B, H, P, N) fp32 contiguous or null (zeros).  Outputs dx
// (B, S, H, P) in x's dtype, ddt (B, S, H) fp32, dA (H,) fp32, dB, dC
// (B, S, N) in x's dtype, dinit (B, H, P, N) fp32, all contiguous.  P and N
// multiples of 8 up to 128; a ragged last chunk's missing steps are
// identity steps (dt, x, dy, B and C read as 0).  Every launch uses the
// caller's stream and allocates nothing; ssd_backward returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 64;          // steps per chunk, as the forward
constexpr int THREADS = 256;   // = (L / 4)^2: one 4x4 (i, j) tile per thread
constexpr int MAX_PN = 128;
constexpr int KMAX = MAX_PN / 16;   // columns a thread owns in a 16-lane row
constexpr int LDL = L + 1;          // (L, L) tiles: odd row strides, so a walk
                                    // down a column by 32 threads hits 32 banks
constexpr int PASS_THREADS = 256;
constexpr int REDUCE_THREADS = 256;
static_assert(THREADS == (L / 4) * (L / 4), "tiling assumes L = 64");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__host__ __device__ __forceinline__ int ld_odd(int n) { return n + 1; }

// Sum over the 16 lanes of a half-warp that share one row (lanes 0-15 or
// 16-31), in a fixed order: every lane gets the sum.
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// dt of the chunk (0 past Lc) and cum, its inclusive prefix sum times A, as
// the forward computes it (warp 0, two steps a lane).
__device__ void load_cum(const float* __restrict__ dt, float a, size_t row0, int h, int H,
                         int Lc, float* dts, float* cum) {
  const int tid = threadIdx.x;
  for (int j = tid; j < L; j += THREADS) dts[j] = j < Lc ? dt[(row0 + j) * H + h] : 0.f;
  __syncthreads();
  if (tid < 32) {
    const float v0 = dts[2 * tid] * a, v1 = dts[2 * tid + 1] * a;
    float incl = v0 + v1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += t;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid == 0) excl = 0.f;
    cum[2 * tid] = excl + v0;
    cum[2 * tid + 1] = incl;
  }
  __syncthreads();
}

// dst[j][k] = src row j (K values, unit stride, rows `stride` apart) as fp32,
// times scale[j] when given; rows j >= Lc are zeros.
template <typename T>
__device__ void stage(float* dst, int ld, const T* __restrict__ src, long long stride, int K,
                      int Lc, const float* scale) {
  for (int i = threadIdx.x; i < L * K; i += THREADS) {
    const int j = i / K, k = i - j * K;
    float v = 0.f;
    if (j < Lc) {
      v = to_f(src[j * stride + k]);
      if (scale) v *= scale[j];
    }
    dst[j * ld + k] = v;
  }
}

// out[p][n] = sum_j U[j][p] V[j][n] over the chunk's Lc steps, P x N, written
// to out (row stride N).  Thread (pr, nl) = (tid / 16, tid % 16) owns rows
// pr + 16 i and columns nl + 16 k.
__device__ void outer_sum(const float* U, int ldu, const float* V, int ldv, int P, int N, int Lc,
                          float* __restrict__ out) {
  const int pr = threadIdx.x >> 4, nl = threadIdx.x & 15;
  float acc[KMAX][KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i)
#pragma unroll
    for (int k = 0; k < KMAX; ++k) acc[i][k] = 0.f;
  for (int j = 0; j < Lc; ++j) {
    float u[KMAX], v[KMAX];
#pragma unroll
    for (int i = 0; i < KMAX; ++i) u[i] = pr + 16 * i < P ? U[j * ldu + pr + 16 * i] : 0.f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) v[k] = nl + 16 * k < N ? V[j * ldv + nl + 16 * k] : 0.f;
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
#pragma unroll
      for (int k = 0; k < KMAX; ++k) acc[i][k] = fmaf(u[i], v[k], acc[i][k]);
  }
#pragma unroll
  for (int i = 0; i < KMAX; ++i)
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int p = pr + 16 * i, n = nl + 16 * k;
      if (p < P && n < N) out[(size_t)p * N + n] = acc[i][k];
    }
}

size_t state_smem_floats(int P, int N) {
  return 2 * (size_t)L + (size_t)L * ld_odd(P) + (size_t)L * ld_odd(N);
}

// Pass 1.  states, gstates: (B, nc, H, P, N) fp32; last: (B, nc, H).
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ A, const T* __restrict__ Bm,
                           const T* __restrict__ Cm, const T* __restrict__ dy,
                           float* __restrict__ states, float* __restrict__ gstates,
                           float* __restrict__ last, int S, int H, int P, int N, int nc,
                           long long sxb, long long sxs, long long sbb, long long sbs,
                           long long scb, long long scs) {
  extern __shared__ float smem[];
  const int ldp = ld_odd(P), ldn = ld_odd(N);
  float* dts = smem;              // L
  float* cum = dts + L;           // L
  float* Us = cum + L;            // L x ldp: x dt e^(last - cum), then dy e^cum
  float* Vs = Us + L * ldp;       // L x ldn: B, then C
  __shared__ float scale[L];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int s0 = c * L, Lc = min(L, S - s0);
  load_cum(dt, A[h], (size_t)b * S + s0, h, H, Lc, dts, cum);
  const float cl = cum[L - 1];
  const size_t blk = ((size_t)b * nc + c) * H + h;
  if (tid == 0) last[blk] = cl;

  for (int j = tid; j < L; j += THREADS) scale[j] = dts[j] * expf(cl - cum[j]);
  __syncthreads();
  stage(Us, ldp, x + b * sxb + s0 * sxs + (size_t)h * P, sxs, P, Lc, scale);
  stage(Vs, ldn, Bm + b * sbb + s0 * sbs, sbs, N, Lc, (const float*)nullptr);
  __syncthreads();
  outer_sum(Us, ldp, Vs, ldn, P, N, Lc, states + blk * P * N);
  __syncthreads();

  for (int j = tid; j < L; j += THREADS) scale[j] = expf(cum[j]);
  __syncthreads();
  stage(Us, ldp, dy + (((size_t)b * S + s0) * H + h) * P, (long long)H * P, P, Lc, scale);
  stage(Vs, ldn, Cm + b * scb + s0 * scs, scs, N, Lc, (const float*)nullptr);
  __syncthreads();
  outer_sum(Us, ldp, Vs, ldn, P, N, Lc, gstates + blk * P * N);
}

// Pass 2.  One thread per (row, head, p, n): h_in over states, R over
// gstates, in place; dinit (B, H, P, N).  The next chunk's values are
// loaded before this one's update, so loads overlap the recurrence.
__global__ void __launch_bounds__(PASS_THREADS)
ssd_bwd_state_pass_kernel(float* __restrict__ states, float* __restrict__ gstates,
                          const float* __restrict__ last, const float* __restrict__ init,
                          const float* __restrict__ dstate, float* __restrict__ dinit, int B,
                          int H, int nc, int PN) {
  const size_t idx = (size_t)blockIdx.x * PASS_THREADS + threadIdx.x;
  if (idx >= (size_t)B * H * PN) return;
  const size_t bh = idx / PN;   // b * H + h
  const int e = (int)(idx - bh * PN);
  const size_t b = bh / H, h = bh - b * H;
  auto at = [&](int c) { return ((b * nc + c) * H + h) * PN + e; };
  auto decay = [&](int c) { return expf(last[(b * nc + c) * H + h]); };

  float hv = init ? init[idx] : 0.f;
  float nxt = nc > 0 ? states[at(0)] : 0.f;
  for (int c = 0; c < nc; ++c) {
    const float s = nxt;
    if (c + 1 < nc) nxt = states[at(c + 1)];
    states[at(c)] = hv;
    hv = fmaf(decay(c), hv, s);
  }
  float r = dstate ? dstate[idx] : 0.f;
  nxt = nc > 0 ? gstates[at(nc - 1)] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const float d = nxt;
    if (c > 0) nxt = gstates[at(c - 1)];
    gstates[at(c)] = r;
    r = fmaf(decay(c), r, d);
  }
  dinit[idx] = r;
}

size_t chunk_smem_floats(int P, int N) {
  return 8 * (size_t)L + 2 * (size_t)L * ld_odd(P) + 2 * (size_t)L * ld_odd(N) +
         (size_t)P * ld_odd(N) + 3 * (size_t)L * LDL + THREADS / 32;
}

// Pass 3.  h_in (= states after pass 2) and R (= gstates) (B, nc, H, P, N);
// dBp, dCp (B, S, H, N) fp32 partials; dAp (B, nc, H).
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const T* __restrict__ dy,
                     const float* __restrict__ h_in, const float* __restrict__ R,
                     T* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dBp,
                     float* __restrict__ dCp, float* __restrict__ dAp, int S, int H, int P, int N,
                     int nc, long long sxb, long long sxs, long long sbb, long long sbs,
                     long long scb, long long scs) {
  extern __shared__ float smem[];
  const int ldp = ld_odd(P), ldn = ld_odd(N);
  float* dts = smem;              // L: dt (0 past Lc)
  float* cum = dts + L;           // L
  float* zs = cum + L;            // L: z_t
  float* es = zs + L;             // L: e_t
  float* vs = es + L;             // L: v_t
  float* xus = vs + L;            // L: x_t . u_t
  float* dda = xus + L;           // L
  float* spare = dda + L;         // L (keeps the tiles' offsets even)
  float* Xs = spare + L;          // L x ldp: x
  float* Ys = Xs + L * ldp;       // L x ldp: dy
  float* Bs = Ys + L * ldp;       // L x ldn
  float* Cs = Bs + L * ldn;       // L x ldn
  float* St = Cs + L * ldn;       // P x ldn: h_in, then R
  float* Wm = St + P * ldn;       // L x LDL: W
  float* Mm = Wm + L * LDL;       // L x LDL: M
  float* Tm = Mm + L * LDL;       // L x LDL: T, then its row-exclusive prefix sums
  float* red = Tm + L * LDL;      // THREADS / 32
  (void)spare;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int s0 = c * L, Lc = min(L, S - s0);
  const float a = A[h];
  const size_t row0 = (size_t)b * S + s0;
  const size_t blk = ((size_t)b * nc + c) * H + h;
  load_cum(dt, a, row0, h, H, Lc, dts, cum);
  const float cl = cum[L - 1];

  stage(Xs, ldp, x + b * sxb + s0 * sxs + (size_t)h * P, sxs, P, Lc, (const float*)nullptr);
  stage(Ys, ldp, dy + (row0 * H + h) * P, (long long)H * P, P, Lc, (const float*)nullptr);
  stage(Bs, ldn, Bm + b * sbb + s0 * sbs, sbs, N, Lc, (const float*)nullptr);
  stage(Cs, ldn, Cm + b * scb + s0 * scs, scs, N, Lc, (const float*)nullptr);
  const float* hin = h_in + blk * P * N;
  for (int i = tid; i < P * N; i += THREADS) {
    const int p = i / N, n = i - p * N;
    St[p * ldn + n] = hin[i];
  }
  __syncthreads();

  // W, M and T on (i, j): rows ti + 16 r, columns tj + 16 q
  {
    const int ti = tid >> 4, tj = tid & 15;
    float q[4][4] = {}, cb[4][4] = {};
    for (int p = 0; p < P; ++p) {
      float yv[4], xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) yv[r] = Ys[(ti + 16 * r) * ldp + p];
#pragma unroll
      for (int k = 0; k < 4; ++k) xv[k] = Xs[(tj + 16 * k) * ldp + p];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) q[r][k] = fmaf(yv[r], xv[k], q[r][k]);
    }
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = Cs[(ti + 16 * r) * ldn + n];
#pragma unroll
      for (int k = 0; k < 4; ++k) bv[k] = Bs[(tj + 16 * k) * ldn + n];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) cb[r][k] = fmaf(cv[r], bv[k], cb[r][k]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = ti + 16 * r, j = tj + 16 * k;
        // mask before the exp: cum_i - cum_j > 0 above the diagonal
        const float E = j <= i ? expf(cum[i] - cum[j]) : 0.f;
        const float w = cb[r][k] * E;
        Wm[i * LDL + j] = w;
        Mm[i * LDL + j] = q[r][k] * E;
        Tm[i * LDL + j] = w * q[r][k] * dts[j];
      }
  }
  __syncthreads();
  if (tid < L) {   // row-exclusive prefix sums of T, in place
    float run = 0.f;
    for (int u = 0; u < L; ++u) {
      const float t = Tm[tid * LDL + u];
      Tm[tid * LDL + u] = run;
      run += t;
    }
  }
  __syncthreads();

  const int tt = tid >> 4, nl = tid & 15;   // (t, n) and (t, p) tiles: rows 4 tt + r
  const int KN = (N + 15) / 16, KP = (P + 15) / 16;
  if (tid < L) {   // z_u = sum_{i >= u} prefix_i(u)
    float z = 0.f;
    for (int i = tid; i < L; ++i) z += Tm[i * LDL + tid];
    zs[tid] = z;
  }
  // dC_t = e^(cum_t) h_in^T dy_t + sum_{j<=t} M_tj dt_j B_j; e_t = dC_inter_t . C_t
  {
    float inter[4][KMAX], intra[4][KMAX];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < KMAX; ++k) inter[r][k] = intra[r][k] = 0.f;
    for (int p = 0; p < P; ++p) {
      float yv[4], sv[KMAX];
#pragma unroll
      for (int r = 0; r < 4; ++r) yv[r] = Ys[(4 * tt + r) * ldp + p];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) sv[k] = k < KN && nl + 16 * k < N ? St[p * ldn + nl + 16 * k] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < KMAX; ++k) inter[r][k] = fmaf(yv[r], sv[k], inter[r][k]);
    }
    for (int j = 0; j < 4 * tt + 4; ++j) {   // M is 0 above the diagonal
      const float d = dts[j];
      float mv[4], bv[KMAX];
#pragma unroll
      for (int r = 0; r < 4; ++r) mv[r] = Mm[(4 * tt + r) * LDL + j] * d;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) bv[k] = k < KN && nl + 16 * k < N ? Bs[j * ldn + nl + 16 * k] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < KMAX; ++k) intra[r][k] = fmaf(mv[r], bv[k], intra[r][k]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = 4 * tt + r;
      const float ec = expf(cum[t]);
      float ep = 0.f;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        const int n = nl + 16 * k;
        if (k < KN && n < N) {
          const float ci = inter[r][k] * ec;
          ep = fmaf(ci, Cs[t * ldn + n], ep);
          if (t < Lc) dCp[((row0 + t) * H + h) * N + n] = ci + intra[r][k];
        }
      }
      ep = half_warp_sum(ep);
      if (nl == 0) es[t] = ep;
    }
  }
  __syncthreads();   // every read of St as h_in is done

  // R in place of h_in, and e^(last) <R, h_in>
  float hr = 0.f;
  {
    const float* Rp = R + blk * P * N;
    for (int i = tid; i < P * N; i += THREADS) {
      const int p = i / N, n = i - p * N;
      const float rv = Rp[i];
      hr = fmaf(rv, St[p * ldn + n], hr);
      St[p * ldn + n] = rv;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) hr += __shfl_xor_sync(0xffffffffu, hr, off);
    if ((tid & 31) == 0) red[tid >> 5] = hr;
  }
  __syncthreads();

  // dB_t = dt_t (sum_{s>=t} M_st C_s + e^(last - cum_t) R^T x_t); v_t = dB_R_t . B_t
  {
    float rx[4][KMAX], intra[4][KMAX];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < KMAX; ++k) rx[r][k] = intra[r][k] = 0.f;
    for (int p = 0; p < P; ++p) {
      float xv[4], sv[KMAX];
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = Xs[(4 * tt + r) * ldp + p];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) sv[k] = k < KN && nl + 16 * k < N ? St[p * ldn + nl + 16 * k] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < KMAX; ++k) rx[r][k] = fmaf(xv[r], sv[k], rx[r][k]);
    }
    for (int s = 4 * tt; s < L; ++s) {   // M_st = 0 for s < t
      float mv[4], cv[KMAX];
#pragma unroll
      for (int r = 0; r < 4; ++r) mv[r] = Mm[s * LDL + 4 * tt + r];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) cv[k] = k < KN && nl + 16 * k < N ? Cs[s * ldn + nl + 16 * k] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < KMAX; ++k) intra[r][k] = fmaf(mv[r], cv[k], intra[r][k]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = 4 * tt + r;
      const float d = dts[t], dr = d * expf(cl - cum[t]);
      float vp = 0.f;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        const int n = nl + 16 * k;
        if (k < KN && n < N) {
          const float br = rx[r][k] * dr;
          vp = fmaf(br, Bs[t * ldn + n], vp);
          if (t < Lc) dBp[((row0 + t) * H + h) * N + n] = fmaf(d, intra[r][k], br);
        }
      }
      vp = half_warp_sum(vp);
      if (nl == 0) vs[t] = vp;
    }
  }

  // u_t = sum_{s>=t} W_st dy_s + e^(last - cum_t) R B_t; dx_t = dt_t u_t;
  // x_t . u_t.  Columns p = nl + 16 k.
  {
    float u[4][KMAX], rb[4][KMAX];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < KMAX; ++k) u[r][k] = rb[r][k] = 0.f;
    for (int s = 4 * tt; s < L; ++s) {
      float wv[4], yv[KMAX];
#pragma unroll
      for (int r = 0; r < 4; ++r) wv[r] = Wm[s * LDL + 4 * tt + r];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) yv[k] = k < KP && nl + 16 * k < P ? Ys[s * ldp + nl + 16 * k] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < KMAX; ++k) u[r][k] = fmaf(wv[r], yv[k], u[r][k]);
    }
    for (int n = 0; n < N; ++n) {
      float bv[4], sv[KMAX];
#pragma unroll
      for (int r = 0; r < 4; ++r) bv[r] = Bs[(4 * tt + r) * ldn + n];
#pragma unroll
      for (int k = 0; k < KMAX; ++k) sv[k] = k < KP && nl + 16 * k < P ? St[(nl + 16 * k) * ldn + n] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < KMAX; ++k) rb[r][k] = fmaf(bv[r], sv[k], rb[r][k]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = 4 * tt + r;
      const float d = dts[t], de = expf(cl - cum[t]);
      float xu = 0.f;
#pragma unroll
      for (int k = 0; k < KMAX; ++k) {
        const int p = nl + 16 * k;
        if (k < KP && p < P) {
          const float uv = fmaf(de, rb[r][k], u[r][k]);
          xu = fmaf(Xs[t * ldp + p], uv, xu);
          if (t < Lc) store(dx + ((row0 + t) * H + h) * P + p, d * uv);
        }
      }
      xu = half_warp_sum(xu);
      if (nl == 0) xus[t] = xu;
    }
  }
  __syncthreads();

  // dda_t = z_t + sum_{k>=t} e_k + sum_{j<t} v_j + e^(last) <R, h_in>
  if (tid == 0) {
    float ends = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) ends += red[w];
    ends *= expf(cl);
    float acc = 0.f;
    for (int k = L - 1; k >= 0; --k) {
      acc += es[k];
      dda[k] = zs[k] + acc;
    }
    float vp = 0.f, da = 0.f;
    for (int k = 0; k < L; ++k) {
      dda[k] += vp + ends;
      vp += vs[k];
      da = fmaf(dts[k], dda[k], da);
    }
    dAp[blk] = da;
  }
  __syncthreads();
  if (tid < Lc) ddt[(row0 + tid) * H + h] = fmaf(a, dda[tid], xus[tid]);
}

// Pass 4: dB, dC (B, S, N) = sum over heads of the partials, in head order.
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
ssd_bwd_reduce_kernel(const float* __restrict__ dBp, const float* __restrict__ dCp,
                      T* __restrict__ dB, T* __restrict__ dC, size_t rows, int H, int N) {
  const size_t idx = (size_t)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (idx >= rows * N) return;
  const size_t row = idx / N;
  const int n = (int)(idx - row * N);
  const float* pb = dBp + row * H * N + n;
  const float* pc = dCp + row * H * N + n;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    sb += pb[(size_t)h * N];
    sc += pc[(size_t)h * N];
  }
  store(dB + idx, sb);
  store(dC + idx, sc);
}

__global__ void ssd_bwd_da_kernel(const float* __restrict__ dAp, float* __restrict__ dA,
                                  int BC, int H) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int i = 0; i < BC; ++i) s += dAp[(size_t)i * H + h];
  dA[h] = s;
}

// Scratch layout (floats): states, gstates (B, nc, H, P, N); last, dAp
// (B, nc, H); dBp, dCp (B, S, H, N).
size_t scratch_floats(int B, int S, int H, int P, int N) {
  const size_t nc = (S + L - 1) / L;
  return 2 * (size_t)B * nc * H * P * N + 2 * (size_t)B * nc * H + 2 * (size_t)B * S * H * N;
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           const float* init, const void* dy, const float* dstate, void* dx, float* ddt,
           float* dA, void* dB, void* dC, float* dinit, float* scratch, int B, int S, int H,
           int P, int N, long long sxb, long long sxs, long long sbb, long long sbs,
           long long scb, long long scs, cudaStream_t stream) {
  // the largest block this shape needs, set once per size (pass 3 at
  // P = N = 128 would need more than a block may have: the call fails)
  static size_t state_set = 0, chunk_set = 0;
  const size_t state_bytes = sizeof(float) * state_smem_floats(P, N);
  const size_t chunk_bytes = sizeof(float) * chunk_smem_floats(P, N);
  if (state_bytes > state_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_chunk_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)state_bytes);
    if (err != cudaSuccess) return (int)err;
    state_set = state_bytes;
  }
  if (chunk_bytes > chunk_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)chunk_bytes);
    if (err != cudaSuccess) return (int)err;
    chunk_set = chunk_bytes;
  }
  const int nc = (S + L - 1) / L;
  const size_t big = (size_t)B * nc * H * P * N;
  float* states = scratch;
  float* gstates = states + big;
  float* last = gstates + big;
  float* dAp = last + (size_t)B * nc * H;
  float* dBp = dAp + (size_t)B * nc * H;
  float* dCp = dBp + (size_t)B * S * H * N;
  const T* xp = static_cast<const T*>(x);
  const T* bp = static_cast<const T*>(Bm);
  const T* cp = static_cast<const T*>(Cm);
  const T* yp = static_cast<const T*>(dy);
  const dim3 grid(nc, H, B);
  if (nc > 0) {
    ssd_bwd_chunk_state_kernel<T><<<grid, THREADS, state_bytes, stream>>>(
        xp, dt, A, bp, cp, yp, states, gstates, last, S,
                                              H, P, N, nc, sxb, sxs, sbb, sbs, scb, scs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t lanes = (size_t)B * H * P * N;
  ssd_bwd_state_pass_kernel<<<(unsigned)((lanes + PASS_THREADS - 1) / PASS_THREADS),
                              PASS_THREADS, 0, stream>>>(states, gstates, last, init, dstate,
                                                         dinit, B, H, nc, P * N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (nc > 0) {
    ssd_bwd_chunk_kernel<T><<<grid, THREADS, chunk_bytes, stream>>>(
        xp, dt, A, bp, cp, yp, states, gstates, static_cast<T*>(dx), ddt, dBp, dCp, dAp, S, H, P,
        N, nc, sxb, sxs, sbb, sbs, scb, scs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t outs = (size_t)B * S * N;
    ssd_bwd_reduce_kernel<T><<<(unsigned)((outs + REDUCE_THREADS - 1) / REDUCE_THREADS),
                               REDUCE_THREADS, 0, stream>>>(dBp, dCp, static_cast<T*>(dB),
                                                            static_cast<T*>(dC), (size_t)B * S, H,
                                                            N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  ssd_bwd_da_kernel<<<(H + 127) / 128, 128, 0, stream>>>(dAp, dA, B * nc, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_bwd_chunk() { return L; }

// Floats of scratch one call needs (the wrapper allocates it).
extern "C" size_t ssd_bwd_scratch_floats(int B, int S, int H, int P, int N) {
  return scratch_floats(B, S, H, P, N);
}

// Dynamic shared memory of one block of pass 1 (kernel 1) or pass 3 (2).
extern "C" size_t ssd_bwd_smem_bytes(int kernel, int P, int N) {
  return sizeof(float) * (kernel == 1 ? state_smem_floats(P, N) : chunk_smem_floats(P, N));
}

// variant 0: `simt` (the only one).  init and dstate may be null (zeros).
// S >= 1; with S = 0 the wrapper returns zeros without a call.
extern "C" int ssd_backward(const void* x, const float* dt, const float* A, const void* Bm,
                            const void* Cm, const float* init, const void* dy,
                            const float* dstate, void* dx, float* ddt, float* dA, void* dB,
                            void* dC, float* dinit, float* scratch, int B, int S, int H, int P,
                            int N, long long sxb, long long sxs, long long sbb, long long sbs,
                            long long scb, long long scs, int is_bf16, int variant,
                            void* stream) {
  if (P < 8 || P > MAX_PN || P % 8 != 0 || N < 8 || N > MAX_PN || N % 8 != 0 || H < 1 ||
      S < 1 || B < 1 || B > 65535 || H > 65535 || variant != 0 || !scratch)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, init, dy, dstate, dx, ddt, dA, dB, dC, dinit,
                                 scratch, B, S, H, P, N, sxb, sxs, sbb, sbs, scb, scs, st);
  return launch<float>(x, dt, A, Bm, Cm, init, dy, dstate, dx, ddt, dA, dB, dC, dinit, scratch,
                       B, S, H, P, N, sxb, sxs, sbb, sbs, scb, scs, st);
}
