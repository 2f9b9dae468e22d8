// Mamba-2 SSD chunked scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `ssd_bh` (body `_ssd_kernel`) in
// src/repro/kernels/ssd/kernel.py.  Per (batch row b, head h) and per chunk
// of L = 64 steps, with da = dt * A and cum its inclusive prefix sum in the
// chunk:
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
//     state written fp32 in the cache layout (B, H, P, N);
//   * a ragged last chunk is masked as identity steps in the kernel (dt, x,
//     B and C read as 0), never padded by copies;
//   * y in x's dtype.
//
// The TPU kernel masks the upper triangle after the exp (kernel.py:51).
// Here the mask comes first: exp(cum_i - cum_j) for j > i can overflow to
// inf, and inf * 0 is NaN.
//
// Layout: x (B, S, H, P) with strides (sxb, sxs, P, 1); dt (B, S, H) and
// y (B, S, H, P) contiguous; A (H,); B/C (B, S, N) with strides (s?b, s?s, 1).
//
// Two variants behind one entry point, `ssd_forward`; the caller (the
// Python wrapper's `plan()`) names the variant and the heads per block.
//
//   tc    bf16 with P = 64 and N = 128 (every Mamba-2 model: the main
//         path).  What bounds it on an H100 is bytes.  At mamba2-2.7b
//         (H = 80, P = 64, N = 128), B = 1, S = 2048: x and y are 21 MB
//         each, B and C 1 MB each, against ~10 GFLOP of products, so the
//         inputs and outputs alone take ~0.013 ms at 3.35 TB/s.  The
//         chunked SSD of the Mamba-2 paper (arXiv:2405.21060, sec. 6-7)
//         splits into work parallel over chunks plus one cheap sequential
//         pass, at the price of a chunk-state scratch the wrapper allocates:
//         (B, n_chunks, H, P, N) fp32 S_c (84 MB there) written by pass 1
//         and read by pass 2, and the bf16 incoming states h_in (42 MB)
//         written by pass 2 and read by pass 3.  With x, y, B and C the
//         three passes move ~317 MB, ~0.095 ms at the memory rate: this
//         design's floor (chip_smoke.py's mamba2_prefill case reports the
//         time of the three passes and of each).
//         The chunk stays at L = 64, as in the plain version and the simt
//         variant: L = 128 would halve the scratch but needs 8 warps of
//         16 rows, twice the score registers and ~150 KB of shared memory
//         in pass 3 (one block an SM), and a new chunking of the plain
//         version and of the fp32 kernel.  h_in goes to its own bf16
//         buffer rather than over S_c: pass 3 rounds it to bf16 anyway,
//         and half the bytes are written and read again.
//     1. ssd_chunk_state_kernel, grid (chunk, head group, row), 4 warps:
//        S_c = (x dt e^(cum_last - cum))^T B_c, a (P x L)(L x N) product
//        on the tensor cores (mma.sync m16n8k16, bf16 in, fp32 out).  B_c
//        is loaded once per block and serves its group of heads; x of the
//        next head streams in by cp.async while the current one computes.
//        The decay scale is applied to x's A fragments in registers (one
//        bf16 rounding) right after ldmatrix.  S_c goes out through a
//        per-warp shared-memory tile as whole 512-byte rows (see LDF), and
//        cum_last beside it.
//     2. ssd_state_pass_kernel, one thread per 4 lanes of the (B, H, P, N)
//        state, sequential over chunks only: h_in[c] = h (stored bf16, the
//        operand pass 3 hands the tensor cores), h = e^(cum_last[c]) h +
//        S_c in fp32, from the initial state or zeros; the last h is the
//        final state.  The next chunk's S_c is loaded before this one's
//        update, so the loads overlap the recurrence.
//     3. ssd_chunk_scan_kernel, grid (chunk, head group, row), 4 warps of
//        16 rows: flash attention's shape with a decay mask in place of
//        the softmax.  C_c B_c^T is computed once per block into registers
//        and shared by the group's heads; per head, y = e^(cum_i) C_c
//        h_in^T + W x with W = C_c B_c^T o e^(cum_i - cum_j) dt_j (j <= i,
//        masked before the exp), built from the score accumulators in
//        registers as the bf16 A operand of the next mma, and x read by
//        ldmatrix.trans the way V is.  x and h_in of the next head stream
//        in by cp.async while the current one computes.
//     bf16 roundings (the tensor cores' operands): the decayed x dt of pass
//     1, h_in, and W; sums are fp32.  Held to the 5e-2 bf16 check against
//     the plain version (ref.ssd_passes_ref emulates these roundings).
//
//   simt  the first design, fp32 (held to 5e-5, which TF32 would miss) and
//         other head sizes: one block per (b, h), a loop over chunks inside
//         the block, the state in shared memory, every product on the CUDA
//         cores from 4x4 or 4x8 register tiles (x*dt, B, C staged as fp32,
//         about 134 KB of shared memory at P = 64, N = 128).
//
// Every launch uses the caller's stream and allocates nothing (the tc
// scratch comes from the wrapper); ssd_forward returns cudaGetLastError()
// (0 on success).  The variants share this one file, so the build's source
// hash covers both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 64;  // steps per chunk, both variants

// ===========================================================================
// simt: the first design, unchanged
// ===========================================================================

namespace simt {

constexpr int THREADS = 256;   // = (L / 4)^2: one 4x4 score tile per thread
constexpr int MAX_PN = 128;
static_assert(THREADS == (L / 4) * (L / 4), "tiling assumes L = 64");

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
int launch_simt(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
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

}  // namespace simt

// ===========================================================================
// tc: three passes, products on the tensor cores
// ===========================================================================

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int P = 64;             // head dim
constexpr int N = 128;            // d_state
constexpr int STATE_THREADS = 128;  // pass 1: 4 warps, 16 rows of S_c each
constexpr int SCAN_THREADS = 128;   // pass 3: 4 warps, warp w owns chunk rows 16w .. 16w + 15
constexpr int PASS_THREADS = 256;
constexpr int MAX_HPB = 4;        // heads per block
static_assert(P == L, "pass 3 keeps h_in's second stage in B's buffer (P x LDN = L x LDN)");

// bf16 rows in shared memory padded by 16 bytes: 16-byte aligned for
// cp.async, and an odd count of 16-byte units, so the 8 rows one ldmatrix
// reads land in 8 different bank groups.
constexpr int LDN = N + 8;  // rows of B, C, h_in
constexpr int LDP = P + 8;  // rows of x
// Pass 1's chunk states go out through a per-warp staging tile, whole
// rows at a time by 16-byte stores: the accumulators' own 8-byte stores
// scatter over 8 rows an instruction, and were most of pass 1's time.
// Rows of the tile are padded by 8 words, so the float2 writes of a
// half-warp (4 rows x 4 lanes) hit 16 different bank pairs.  (Staging
// pass 3's bf16 y the same way raised its registers from 164 to 205, one
// block an SM less, and made it slower.)
constexpr int LDF = N + 8;  // fp32 rows of a warp's 8 x N half state tile
// B, two x stages, cum and dt of each head, four half state tiles: 55,296
// bytes, room for four blocks an SM (the registers allow three)
constexpr size_t STATE_SMEM = (size_t)L * LDN * 2 + (size_t)2 * L * LDP * 2 +
                              (size_t)2 * MAX_HPB * L * 4 + (size_t)4 * 8 * LDF * 4;
// C, B (h_in's second stage once C B^T is formed), two x stages, h_in's
// first stage, cum and dt: 72,704 bytes, three blocks an SM
constexpr size_t SCAN_SMEM = (size_t)2 * L * LDN * 2 + (size_t)2 * L * LDP * 2 +
                             (size_t)P * LDN * 2 + (size_t)2 * MAX_HPB * L * 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; 0 source bytes when !valid (the hardware
// writes zeros), with src then any mapped address
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int K>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K));
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// c += a b: m16n8k16, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// two bf16 (lo, hi) scaled by (s0, s1), rounded back to bf16
__device__ __forceinline__ uint32_t scale2(uint32_t v, float s0, float s1) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack_bf16(f.x * s0, f.y * s1);
}

// One warp: dts[j] = dt of step j of the chunk (0 for the identity steps
// j >= Lc), cum[j] = inclusive prefix sum of dts * a; two steps a lane.
__device__ __forceinline__ void chunk_cum(const float* __restrict__ dtp, int H, int Lc, float a,
                                          float* dts, float* cum, int lane) {
  const float d0 = 2 * lane < Lc ? dtp[(size_t)(2 * lane) * H] : 0.f;
  const float d1 = 2 * lane + 1 < Lc ? dtp[(size_t)(2 * lane + 1) * H] : 0.f;
  const float v0 = d0 * a, v1 = d1 * a;
  float incl = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  cum[2 * lane] = excl + v0;
  cum[2 * lane + 1] = incl;
  dts[2 * lane] = d0;
  dts[2 * lane + 1] = d1;
}

// ldmatrix row addresses of this lane (see the users):
//   A, non-trans, from [m][k] rows:     row lane % 16, column (lane / 16) * 8
//   B, non-trans, from [n][k] rows:     row (lane % 8) + (lane / 16) * 8, column ((lane / 8) % 2) * 8
//   A^T / B, trans, from [k][m|n] rows: row (lane % 8) + ((lane / 8) % 2) * 8 for B (two n tiles),
//                                       row (lane % 8) + (lane / 16) * 8 for A (two k halves)

// Pass 1.  Grid (n_chunks, head groups, B).  states[b, c, h] (P, N) fp32 =
// sum_j (x_j dt_j e^(cum_last - cum_j)) (x) B_j; last[b, c, h] = cum_last.
// Warp w computes rows p = 16 w .. 16 w + 15.
__global__ void __launch_bounds__(STATE_THREADS)
ssd_chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ A, const bf16* __restrict__ Bm,
                       float* __restrict__ states, float* __restrict__ last, int S, int H, int nc,
                       int hpb, long long sxb, long long sxs, long long sbb, long long sbs) {
  extern __shared__ float4 smem4[];
  bf16* Bs = reinterpret_cast<bf16*>(smem4);             // L x LDN
  bf16* Xs = Bs + L * LDN;                                // 2 x L x LDP
  float* cum = reinterpret_cast<float*>(Xs + 2 * L * LDP);  // MAX_HPB x L
  float* dts = cum + MAX_HPB * L;                         // MAX_HPB x L
  float* tile = dts + MAX_HPB * L + (threadIdx.x / 32) * 8 * LDF;  // this warp's 8 x LDF

  const int c = blockIdx.x, h0 = blockIdx.y * hpb, b = blockIdx.z;
  const int nh = min(hpb, H - h0);
  const int s0 = c * L, Lc = min(L, S - s0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;

  const bf16* Bb = Bm + b * sbb + (long long)s0 * sbs;
  const bf16* xb = x + b * sxb + (long long)s0 * sxs;
  for (int i = tid; i < L * (N / 8); i += STATE_THREADS) {
    const int j = i / (N / 8), e = (i % (N / 8)) * 8;
    const bool ok = j < Lc;
    cp16(Bs + j * LDN + e, Bb + (ok ? j * sbs + e : 0), ok);
  }
  auto load_x = [&](int k) {
    bf16* dst = Xs + (k & 1) * L * LDP;
    const bf16* src = xb + (size_t)(h0 + k) * P;
    for (int i = tid; i < L * (P / 8); i += STATE_THREADS) {
      const int j = i / (P / 8), e = (i % (P / 8)) * 8;
      const bool ok = j < Lc;
      cp16(dst + j * LDP + e, src + (ok ? j * sxs + e : 0), ok);
    }
  };
  load_x(0);
  cp_commit();
  for (int k = warp; k < nh; k += STATE_THREADS / 32)
    chunk_cum(dt + ((size_t)b * S + s0) * H + h0 + k, H, Lc, A[h0 + k], dts + k * L, cum + k * L,
              lane);

  const uint32_t b_base = smem_u32(Bs);
  const int xa_row = (lane % 8) + (lane / 16) * 8, xa_col = warp * 16 + ((lane / 8) % 2) * 8;
  const int bv_row = (lane % 8) + ((lane / 8) % 2) * 8, bv_col = (lane / 16) * 8;
  for (int k = 0; k < nh; ++k) {
    if (k + 1 < nh) load_x(k + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // x of head k (and B, cum) visible to every warp
    const float* cm = cum + k * L;
    const float* dd = dts + k * L;
    const float cl = cm[L - 1];
    const uint32_t x_base = smem_u32(Xs + (k & 1) * L * LDP);
    float acc[N / 8][4];
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      // A = (x dt e^(cl - cum))^T, rows p = 16 warp .., k = steps: ldmatrix.trans
      // of x [j][p]; a[0], a[1] hold steps 2 t4, 2 t4 + 1, a[2], a[3] those + 8
      uint32_t a[4];
      ldsm_x4_t(x_base + ((kk * 16 + xa_row) * LDP + xa_col) * 2, a);
      const int j0 = kk * 16 + 2 * t4;
      const float f0 = dd[j0] * expf(cl - cm[j0]), f1 = dd[j0 + 1] * expf(cl - cm[j0 + 1]);
      const float f8 = dd[j0 + 8] * expf(cl - cm[j0 + 8]);
      const float f9 = dd[j0 + 9] * expf(cl - cm[j0 + 9]);
      a[0] = scale2(a[0], f0, f1);
      a[1] = scale2(a[1], f0, f1);
      a[2] = scale2(a[2], f8, f9);
      a[3] = scale2(a[3], f8, f9);
#pragma unroll
      for (int nt = 0; nt < N / 8; nt += 2) {
        uint32_t bb[4];  // B [j][n] read k-major: ldmatrix.trans
        ldsm_x4_t(b_base + ((kk * 16 + bv_row) * LDN + nt * 8 + bv_col) * 2, bb);
        mma(acc[nt], a, bb[0], bb[1]);
        mma(acc[nt + 1], a, bb[2], bb[3]);
      }
    }
    // rows 16 warp .. + 15 of S_c are 16 N contiguous floats of the
    // scratch; they go out in two halves of 8 rows (g, then g + 8)
    float* out = states + (((size_t)b * nc + c) * H + h0 + k) * (P * N) + warp * 16 * N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt)
        *reinterpret_cast<float2*>(tile + g * LDF + nt * 8 + 2 * t4) =
            make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
      __syncwarp();
#pragma unroll
      for (int i = lane; i < 8 * N / 4; i += 32) {
        const int r = i / (N / 4), c4 = (i % (N / 4)) * 4;
        *reinterpret_cast<float4*>(out + (8 * half + r) * N + c4) =
            *reinterpret_cast<const float4*>(tile + r * LDF + c4);
      }
      __syncwarp();  // the tile is read before it is written again
    }
    if (tid == 0) last[((size_t)b * nc + c) * H + h0 + k] = cl;
    __syncthreads();  // every warp is done with x buffer k & 1 before load k + 2
  }
}

__device__ __forceinline__ float4 fma4(float d, float4 h, float4 s) {
  return make_float4(fmaf(d, h.x, s.x), fmaf(d, h.y, s.y), fmaf(d, h.z, s.z), fmaf(d, h.w, s.w));
}

// Pass 2.  One thread per 4 consecutive lanes of the (B, H, P, N) state:
// h_in[b, c, h] = h (bf16), h = e^(last[b, c, h]) h + states[b, c, h], over
// the chunks in order; out_state = the last h.
__global__ void __launch_bounds__(PASS_THREADS)
ssd_state_pass_kernel(const float* __restrict__ states, const float* __restrict__ last,
                      const float* __restrict__ init, bf16* __restrict__ h_in,
                      float* __restrict__ out_state, int B, int H, int nc, int PN) {
  const size_t q = (size_t)blockIdx.x * PASS_THREADS + threadIdx.x;
  if (q >= (size_t)B * H * PN / 4) return;
  const size_t e = q * 4;
  const size_t bh = e / PN;
  const int off = (int)(e - bh * PN);
  const int b = (int)(bh / H), h = (int)(bh % H);
  float4 hv = init ? *reinterpret_cast<const float4*>(init + e) : make_float4(0.f, 0.f, 0.f, 0.f);
  const size_t step = (size_t)H * PN;  // chunk c -> c + 1
  size_t so = ((size_t)b * nc * H + h) * PN + off;
  const float* lp = last + (size_t)b * nc * H + h;
  float4 nxt = nc > 0 ? __ldcs(reinterpret_cast<const float4*>(states + so))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc; ++c) {
    const float4 cur = nxt;
    if (c + 1 < nc) nxt = __ldcs(reinterpret_cast<const float4*>(states + so + step));
    const float d = expf(lp[(size_t)c * H]);
    uint2 hb;
    hb.x = pack_bf16(hv.x, hv.y);
    hb.y = pack_bf16(hv.z, hv.w);
    *reinterpret_cast<uint2*>(h_in + so) = hb;
    hv = fma4(d, hv, cur);
    so += step;
  }
  *reinterpret_cast<float4*>(out_state + e) = hv;
}

// Pass 3.  Grid (n_chunks, head groups, B).  y of the chunk's steps for the
// group's heads.  Warp w computes rows i = 16 w .. 16 w + 15: the rows of
// C B^T it needs (columns j <= i: n tiles < 2 (w + 1)) once, then per head
// y = e^(cum_i) C h_in^T + W x.
__global__ void __launch_bounds__(SCAN_THREADS)
ssd_chunk_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const bf16* __restrict__ Bm,
                      const bf16* __restrict__ Cm, const bf16* __restrict__ h_in,
                      bf16* __restrict__ y, int S, int H, int nc, int hpb, long long sxb,
                      long long sxs, long long sbb, long long sbs, long long scb, long long scs) {
  extern __shared__ float4 smem4[];
  bf16* Cs = reinterpret_cast<bf16*>(smem4);             // L x LDN
  bf16* Bs = Cs + L * LDN;                                // L x LDN, then h_in stage 1
  bf16* Xs = Bs + L * LDN;                                // 2 x L x LDP
  bf16* Hs = Xs + 2 * L * LDP;                            // P x LDN: h_in stage 0
  float* cum = reinterpret_cast<float*>(Hs + P * LDN);   // MAX_HPB x L
  float* dts = cum + MAX_HPB * L;
  auto h_stage = [&](int k) { return (k & 1) ? Bs : Hs; };

  const int c = blockIdx.x, h0 = blockIdx.y * hpb, b = blockIdx.z;
  const int nh = min(hpb, H - h0);
  const int s0 = c * L, Lc = min(L, S - s0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;

  const bf16* Bb = Bm + b * sbb + (long long)s0 * sbs;
  const bf16* Cb = Cm + b * scb + (long long)s0 * scs;
  for (int i = tid; i < L * (N / 8); i += SCAN_THREADS) {
    const int j = i / (N / 8), e = (i % (N / 8)) * 8;
    const bool ok = j < Lc;
    cp16(Bs + j * LDN + e, Bb + (ok ? j * sbs + e : 0), ok);
    cp16(Cs + j * LDN + e, Cb + (ok ? j * scs + e : 0), ok);
  }
  const bf16* xb = x + b * sxb + (long long)s0 * sxs;
  const bf16* hb = h_in + (((size_t)b * nc + c) * H + h0) * (P * N);
  auto load_head = [&](int k) {
    bf16* xd = Xs + (k & 1) * L * LDP;
    const bf16* xsrc = xb + (size_t)(h0 + k) * P;
    for (int i = tid; i < L * (P / 8); i += SCAN_THREADS) {
      const int j = i / (P / 8), e = (i % (P / 8)) * 8;
      const bool ok = j < Lc;
      cp16(xd + j * LDP + e, xsrc + (ok ? j * sxs + e : 0), ok);
    }
    bf16* hd = h_stage(k);
    const bf16* hsrc = hb + (size_t)k * (P * N);
    for (int i = tid; i < P * (N / 8); i += SCAN_THREADS) {
      const int p = i / (N / 8), e = (i % (N / 8)) * 8;
      cp16(hd + p * LDN + e, hsrc + p * N + e, true);
    }
  };
  load_head(0);
  cp_commit();
  for (int k = warp; k < nh; k += SCAN_THREADS / 32)
    chunk_cum(dt + ((size_t)b * S + s0) * H + h0 + k, H, Lc, A[h0 + k], dts + k * L, cum + k * L,
              lane);
  cp_wait<0>();
  __syncthreads();

  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  const int bq_row = (lane % 8) + (lane / 16) * 8, bq_col = ((lane / 8) % 2) * 8;
  const int bv_row = (lane % 8) + ((lane / 8) % 2) * 8, bv_col = (lane / 16) * 8;
  // C rows 16 warp .. as A fragments, every k step: kept for all heads
  uint32_t ca[N / 16][4];
  const uint32_t c_base = smem_u32(Cs), b_base = smem_u32(Bs);
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
    ldsm_x4(c_base + ((warp * 16 + a_row) * LDN + kk * 16 + a_col) * 2, ca[kk]);
  // scores C_i . B_j for this warp's rows, columns j < 16 (warp + 1)
  float cb[L / 8][4];
#pragma unroll
  for (int nt = 0; nt < L / 8; ++nt) cb[nt][0] = cb[nt][1] = cb[nt][2] = cb[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int nt = 0; nt < L / 8; nt += 2)
      if (nt < 2 * (warp + 1)) {
        uint32_t bb[4];  // B [j][n] is B^T's [n_out][k]: ldmatrix non-trans
        ldsm_x4(b_base + ((nt * 8 + bq_row) * LDN + kk * 16 + bq_col) * 2, bb);
        mma(cb[nt], ca[kk], bb[0], bb[1]);
        mma(cb[nt + 1], ca[kk], bb[2], bb[3]);
      }
  __syncthreads();  // every warp has read B: its buffer takes h_in of head 1

  const int i0 = warp * 16 + g, i1 = i0 + 8;  // this thread's two rows
  for (int k = 0; k < nh; ++k) {
    if (k > 0) {
      cp_wait<0>();
      __syncthreads();  // x and h_in of head k visible to every warp
    }
    if (k + 1 < nh) load_head(k + 1);
    cp_commit();
    const float* cm = cum + k * L;
    const float* dd = dts + k * L;
    const uint32_t h_base = smem_u32(h_stage(k));
    const uint32_t x_base = smem_u32(Xs + (k & 1) * L * LDP);
    float acc[P / 8][4];
#pragma unroll
    for (int pt = 0; pt < P / 8; ++pt) acc[pt][0] = acc[pt][1] = acc[pt][2] = acc[pt][3] = 0.f;
    // C h_in^T: h_in [p][n] is [n_out][k]
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
      for (int pt = 0; pt < P / 8; pt += 2) {
        uint32_t bb[4];
        ldsm_x4(h_base + ((pt * 8 + bq_row) * LDN + kk * 16 + bq_col) * 2, bb);
        mma(acc[pt], ca[kk], bb[0], bb[1]);
        mma(acc[pt + 1], ca[kk], bb[2], bb[3]);
      }
    const float ci0 = cm[i0], ci1 = cm[i1];
    const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
    for (int pt = 0; pt < P / 8; ++pt) {
      acc[pt][0] *= e0;
      acc[pt][1] *= e0;
      acc[pt][2] *= e1;
      acc[pt][3] *= e1;
    }
    // W x over the key steps j < 16 (warp + 1); W from the score registers
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk)
      if (kk <= warp) {
        uint32_t wa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int nt = 2 * kk + half;
          const int j0 = nt * 8 + 2 * t4, j1 = j0 + 1;
          const float cj0 = cm[j0], cj1 = cm[j1], d0 = dd[j0], d1 = dd[j1];
          // the mask before the exp: above the diagonal cum_i - cum_j > 0
          const float w00 = j0 <= i0 ? cb[nt][0] * expf(ci0 - cj0) * d0 : 0.f;
          const float w01 = j1 <= i0 ? cb[nt][1] * expf(ci0 - cj1) * d1 : 0.f;
          const float w10 = j0 <= i1 ? cb[nt][2] * expf(ci1 - cj0) * d0 : 0.f;
          const float w11 = j1 <= i1 ? cb[nt][3] * expf(ci1 - cj1) * d1 : 0.f;
          wa[2 * half] = pack_bf16(w00, w01);      // row g:     a0 (steps 2 t4..), a2 (+ 8)
          wa[2 * half + 1] = pack_bf16(w10, w11);  // row g + 8: a1, a3
        }
#pragma unroll
        for (int pt = 0; pt < P / 8; pt += 2) {
          uint32_t bb[4];  // x [j][p] read k-major: ldmatrix.trans
          ldsm_x4_t(x_base + ((kk * 16 + bv_row) * LDP + pt * 8 + bv_col) * 2, bb);
          mma(acc[pt], wa, bb[0], bb[1]);
          mma(acc[pt + 1], wa, bb[2], bb[3]);
        }
      }
    bf16* yb = y + (((size_t)b * S + s0) * H + h0 + k) * P;
#pragma unroll
    for (int pt = 0; pt < P / 8; ++pt) {
      const int col = pt * 8 + 2 * t4;
      if (i0 < Lc)
        *reinterpret_cast<uint32_t*>(yb + (size_t)i0 * H * P + col) = pack_bf16(acc[pt][0], acc[pt][1]);
      if (i1 < Lc)
        *reinterpret_cast<uint32_t*>(yb + (size_t)i1 * H * P + col) = pack_bf16(acc[pt][2], acc[pt][3]);
    }
  }
}

int launch(const void* x, const float* dt, const float* A, const void* Bm, const void* Cm,
           const float* init, void* y, float* out_state, float* states, void* h_in, float* last,
           int B, int S, int H, int hpb, long long sxb, long long sxs, long long sbb,
           long long sbs, long long scb, long long scs, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)STATE_SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ssd_chunk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SCAN_SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int nc = (S + L - 1) / L;
  const dim3 grid(nc, (H + hpb - 1) / hpb, B);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* bp = static_cast<const bf16*>(Bm);
  const bf16* cp = static_cast<const bf16*>(Cm);
  bf16* hp = static_cast<bf16*>(h_in);
  if (nc > 0) {
    ssd_chunk_state_kernel<<<grid, STATE_THREADS, STATE_SMEM, stream>>>(
        xp, dt, A, bp, states, last, S, H, nc, hpb, sxb, sxs, sbb, sbs);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t quads = (size_t)B * H * P * N / 4;
  ssd_state_pass_kernel<<<(unsigned)((quads + PASS_THREADS - 1) / PASS_THREADS), PASS_THREADS, 0,
                          stream>>>(states, last, init, hp, out_state, B, H, nc, P * N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nc == 0) return (int)err;
  ssd_chunk_scan_kernel<<<grid, SCAN_THREADS, SCAN_SMEM, stream>>>(
      xp, dt, A, bp, cp, hp, static_cast<bf16*>(y), S, H, nc, hpb, sxb, sxs, sbb, sbs, scb, scs);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

enum { VARIANT_TC = 0, VARIANT_SIMT = 1 };

// Steps per chunk of both variants.
extern "C" int ssd_chunk() { return L; }

// Dynamic shared memory of one block of a kernel at head_dim P, d_state N:
// kernel 0 the simt kernel, 1 the tc chunk-state pass, 2 the tc chunk-scan
// pass (the state pass takes none); 0 for a shape tc does not take.
extern "C" size_t ssd_smem_bytes(int kernel, int P, int N) {
  if (kernel == 0) return simt::smem_bytes(P, N);
  if (P != tc::P || N != tc::N) return 0;
  return kernel == 1 ? tc::STATE_SMEM : tc::SCAN_SMEM;
}

// variant: 0 tc (bf16, P = 64, N = 128; hpb heads per block, at most
// 4; scratch states (B, n_chunks, H, P, N) fp32, h_in the same in bf16 and
// last (B, n_chunks, H) fp32, n_chunks = ceil(S / 64)), 1 simt (scratch
// pointers unused).  The final state must not alias init under tc.
extern "C" int ssd_forward(const void* x, const float* dt, const float* A, const void* Bm,
                           const void* Cm, const float* init, void* y, float* out_state,
                           float* states, void* h_in, float* last, int B, int S, int H, int P,
                           int N, long long sxb, long long sxs, long long sbb, long long sbs,
                           long long scb, long long scs, int is_bf16, int variant, int hpb,
                           void* stream) {
  if (P < 8 || P > simt::MAX_PN || P % 8 != 0 || N < 8 || N > simt::MAX_PN || N % 8 != 0 ||
      H < 1 || S < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == VARIANT_TC) {
    if (!is_bf16 || P != tc::P || N != tc::N || hpb < 1 || hpb > tc::MAX_HPB || !states ||
        !h_in || !last)
      return (int)cudaErrorInvalidValue;
    return tc::launch(x, dt, A, Bm, Cm, init, y, out_state, states, h_in, last, B, S, H, hpb, sxb,
                      sxs, sbb, sbs, scb, scs, st);
  }
  if (variant != VARIANT_SIMT) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return simt::launch_simt<__nv_bfloat16>(x, dt, A, Bm, Cm, init, y, out_state, B, S, H, P, N,
                                            sxb, sxs, sbb, sbs, scb, scs, st);
  return simt::launch_simt<float>(x, dt, A, Bm, Cm, init, y, out_state, B, S, H, P, N, sxb, sxs,
                                  sbb, sbs, scb, scs, st);
}
