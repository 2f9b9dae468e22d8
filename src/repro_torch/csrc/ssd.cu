// Mamba-2 SSD chunked scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `ssd_bh` (body `_ssd_kernel`) in
// src/repro/kernels/ssd/kernel.py.  Per (batch row b, head h) and per chunk
// of L steps, with da = dt * A and cum its inclusive prefix sum in the chunk:
//   y_i    = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) (x_j dt_j)
//          + exp(cum_i) C_i . state
//   state' = exp(cum_{L-1}) state + sum_j exp(cum_{L-1} - cum_j) B_j (x_j dt_j)
// with a (P, N) fp32 state carried from chunk to chunk.
//
// Beyond the TPU kernel it does what the model path needs:
//   * B and C of the single group are read by row (B, S, N); the H-fold
//     repeat of the reference's ops.py is never materialised;
//   * x, B and C are read through row strides, so the kernel takes the
//     conv output's slices without a copy;
//   * an optional fp32 initial state (null means zeros), and the final
//     state written in the cache layout (B, H, P, N) (it may alias the
//     initial state: each block reads its slice before it writes it);
//   * a ragged last chunk is masked as identity steps in the kernel (dt, x,
//     B and C read as 0), never padded by copies;
//   * x/B/C in bf16 or fp32, dt, A and the state in fp32; y in x's dtype.
//
// The TPU kernel masks the upper triangle after the exp (kernel.py:51).
// Here the mask comes first: exp(cum_i - cum_j) for j > i can overflow to
// inf, and inf * 0 is NaN.
//
// Layout: x (B, S, H, P) with strides (sxb, sxs, P, 1); dt (B, S, H) and
// y (B, S, H, P) contiguous; A (H,); B/C (B, S, N) with strides (s?b, s?s, 1).
//
// What bounds it on an H100.  The work is a few GFLOP per layer at prefill
// widths against tens of MB of x and y, so the bound is the bytes of x and
// y at the memory rate (tens of microseconds at mamba2-2.7b, S=2048).  This
// first design is simple and right, not fast:
//   * one block per (b, h), a loop over chunks inside the block in place of
//     the TPU's sequential chunk grid; the state lives in shared memory;
//   * per chunk, x*dt, B and C are staged as fp32 in shared memory (about
//     134 KB at L=64, P=64, N=128, opted in with cudaFuncSetAttribute) and
//     every product runs on the CUDA cores from 4x4 or 4x8 register tiles.
// Known limits, later work: at infer_prefill B=1 there are only 80 blocks
// on 132 SMs; C.B^T is recomputed for each of the 80 heads although all
// heads share it; the products do not use the tensor cores (wgmma), and the
// loads are not overlapped with compute (TMA, cp.async).
//
// The launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int L = 64;          // steps per chunk (the kernel's own tiling)
constexpr int THREADS = 256;   // = (L / 4)^2: one 4x4 score tile per thread
constexpr int MAX_PN = 128;
static_assert(L == 64 && THREADS == (L / 4) * (L / 4), "tiling assumes L = 64");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

// Padded row strides (floats): multiples of 4 for float4 access, and rows
// land 4 banks apart so neighbouring threads' float4 reads do not collide.
__host__ __device__ __forceinline__ int ld_state(int N) { return N + 4; }
__host__ __device__ __forceinline__ int ld_x(int P) { return P + 4; }
constexpr int LDW = L + 4;

size_t smem_bytes(int P, int N) {
  return sizeof(float) * ((size_t)P * ld_state(N) + (size_t)L * ld_x(P) +
                          2 * (size_t)L * ld_state(N) + (size_t)L * LDW + 2 * L);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
           const T* __restrict__ Bm, const T* __restrict__ Cm, const float* init,
           T* __restrict__ y, float* out_state, int S, int H, int P, int N,
           long long sxb, long long sxs, long long sbb, long long sbs, long long scb,
           long long scs) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldS = ld_state(N), ldX = ld_x(P);
  float* St = smem;                  // P x ldS: the carried state, [p][n]
  float* Xs = St + P * ldS;          // L x ldX: x_j * dt_j
  float* Bs = Xs + L * ldX;          // L x ldS
  float* Cs = Bs + L * ldS;          // L x ldS
  float* Ws = Cs + L * ldS;          // L x LDW: masked, decayed scores
  float* cum = Ws + L * LDW;         // L: inclusive prefix sum of dt * A
  float* dts = cum + L;              // L: dt of the chunk

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float a = A[h];
  const size_t state_off = ((size_t)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += THREADS) {
    const int p = i / N, n = i - p * N;
    St[p * ldS + n] = init ? init[state_off + i] : 0.f;
  }

  const T* xb = x + b * sxb + (size_t)h * P;
  const T* Bb = Bm + b * sbb;
  const T* Cb = Cm + b * scb;
  const float* dtb = dt + (size_t)b * S * H + h;
  T* yb = y + ((size_t)b * S * H + h) * P;
  const int PT = P / 4;   // y tiles: 4 rows i (contiguous) x 4 columns p (PT apart)
  const int NT = N / 8;   // state tiles: 4 rows p x 8 columns n (two runs of 4, N/2 apart)

  for (int s0 = 0; s0 < S; s0 += L) {
    const int Lc = min(L, S - s0);   // steps j >= Lc are identity steps
    __syncthreads();                 // the previous chunk is done with Xs/Bs/Cs/Ws
    for (int j = tid; j < L; j += THREADS) dts[j] = j < Lc ? dtb[(size_t)(s0 + j) * H] : 0.f;
    __syncthreads();
    for (int i = tid; i < L * P; i += THREADS) {
      const int j = i / P, p = i - j * P;
      Xs[j * ldX + p] = j < Lc ? to_f(xb[(s0 + j) * sxs + p]) * dts[j] : 0.f;
    }
    for (int i = tid; i < L * N; i += THREADS) {
      const int j = i / N, n = i - j * N;
      const bool ok = j < Lc;
      Bs[j * ldS + n] = ok ? to_f(Bb[(s0 + j) * sbs + n]) : 0.f;
      Cs[j * ldS + n] = ok ? to_f(Cb[(s0 + j) * scs + n]) : 0.f;
    }
    if (tid < 32) {  // cum: warp 0, two consecutive steps per lane
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

    // Ws[i][j] = (C_i . B_j) exp(cum_i - cum_j) for j <= i, else 0.  Rows
    // i = ti + 16 r and columns j = tj + 16 c, so the 16 threads of a
    // half-warp read 16 different B rows 4 banks apart.
    {
      const int ti = tid / (L / 4), tj = tid % (L / 4);
      float acc[4][4] = {};
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = ld4(Cs + (ti + 16 * r) * ldS + n);
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = ld4(Bs + (tj + 16 * c) * ldS + n);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += dot4(cv[r], bv[c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ti + 16 * r, j = tj + 16 * c;
          // mask before the exp: cum_i - cum_j > 0 above the diagonal
          Ws[i * LDW + j] = j <= i ? acc[r][c] * expf(cum[i] - cum[j]) : 0.f;
        }
    }
    __syncthreads();

    // y_i = exp(cum_i) C_i . state + sum_{j<=i} Ws[i][j] Xs[j]
    for (int t = tid; t < (L / 4) * PT; t += THREADS) {
      const int i0 = (t / PT) * 4, pt = t % PT;
      float acc[4][4] = {};
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = ld4(Cs + (i0 + r) * ldS + n);
#pragma unroll
        for (int q = 0; q < 4; ++q) sv[q] = ld4(St + (pt + PT * q) * ldS + n);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] += dot4(cv[r], sv[q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = expf(cum[i0 + r]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] *= e;
      }
      for (int j = 0; j < i0 + 4; ++j) {   // Ws is 0 above the diagonal
        float xv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = Xs[j * ldX + pt + PT * q];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float w = Ws[(i0 + r) * LDW + j];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(w, xv[q], acc[r][q]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
        if (i < Lc) {
          T* out = yb + (size_t)(s0 + i) * H * P;
#pragma unroll
          for (int q = 0; q < 4; ++q) store(out + pt + PT * q, acc[r][q]);
        }
      }
    }
    __syncthreads();   // every read of the old state is done

    // state = exp(cum_{L-1}) state + sum_j exp(cum_{L-1} - cum_j) B_j (x_j dt_j);
    // each thread updates only its own entries
    const float cl = cum[L - 1];
    const float dl = expf(cl);
    for (int t = tid; t < PT * NT; t += THREADS) {
      const int p0 = (t / NT) * 4, na = (t % NT) * 4, nb = na + N / 2;
      float acc[4][8] = {};
      for (int j = 0; j < Lc; ++j) {   // identity steps add nothing
        const float e = expf(cl - cum[j]);
        const float4 xv = ld4(Xs + j * ldX + p0);
        float4 ba = ld4(Bs + j * ldS + na), bb = ld4(Bs + j * ldS + nb);
        const float bv[8] = {ba.x * e, ba.y * e, ba.z * e, ba.w * e,
                             bb.x * e, bb.y * e, bb.z * e, bb.w * e};
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[q][k] = fmaf(xs[q], bv[k], acc[q][k]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          float* s = St + (p0 + q) * ldS + (k < 4 ? na + k : nb + k - 4);
          *s = fmaf(dl, *s, acc[q][k]);
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += THREADS) {
    const int p = i / N, n = i - p * N;
    out_state[state_off + i] = St[p * ldS + n];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           const float* init, void* y, float* out_state, int B, int S, int H, int P, int N,
           long long sxb, long long sxs, long long sbb, long long sbs, long long scb,
           long long scs, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_bytes(MAX_PN, MAX_PN));
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid(H, B);
  ssd_kernel<T><<<grid, THREADS, smem_bytes(P, N), stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm), init,
      static_cast<T*>(y), out_state, S, H, P, N, sxb, sxs, sbb, sbs, scb, scs);
  return (int)cudaGetLastError();
}

}  // namespace

// Steps per chunk of the kernel.
extern "C" int ssd_chunk() { return L; }

// Dynamic shared memory one block of the kernel takes at head_dim P, d_state N.
extern "C" size_t ssd_smem_bytes(int P, int N) { return smem_bytes(P, N); }

extern "C" int ssd_forward(const void* x, const float* dt, const float* A, const void* Bm,
                           const void* Cm, const float* init, void* y, float* out_state, int B,
                           int S, int H, int P, int N, long long sxb, long long sxs,
                           long long sbb, long long sbs, long long scb, long long scs,
                           int is_bf16, void* stream) {
  if (P < 8 || P > MAX_PN || P % 8 != 0 || N < 8 || N > MAX_PN || N % 8 != 0 || H < 1 || S < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, init, y, out_state, B, S, H, P, N, sxb, sxs,
                                 sbb, sbs, scb, scs, st);
  return launch<float>(x, dt, A, Bm, Cm, init, y, out_state, B, S, H, P, N, sxb, sxs, sbb, sbs,
                       scb, scs, st);
}
