// Flash attention backward for Hopper (sm_90a), plain C interface.
//
// The gradient of flash_attention.cu's forward: (dq, dk, dv) from q, k, v,
// the forward's output o and the output gradient do, by the
// FlashAttention-2 formulas.  The reference trains through XLA attention
// (its Pallas kernel, src/repro/kernels/flash_attention/kernel.py
// `flash_attention_bh`, has no VJP), so this kernel replaces no TPU kernel:
// it is what lets a loss over the port's forward kernel be differentiated
// on the card.  With s = scale q.k (then cap tanh(s / cap) under a softcap)
// and the masks of the forward:
//
//   lse = log sum_k e^s             delta = rowsum(do * o)
//   P = e^(s - lse)                 dv = sum_q P^T do
//   dP = do v^T                     dS = P (dP - delta) (1 - tanh^2 under a softcap)
//   dq = scale dS k                 dk = scale sum_q dS^T q
//
// Three passes (four launches) on the caller's stream; every sum is fp32 and
// is taken in a fixed order (no atomics), so the same inputs give
// bitwise-equal gradients:
//
//   1  per (row, kv head, 64 packed rows): lse by an online max and sum over
//      the visible 32-key tiles, and delta; both fp32, into the scratch the
//      wrapper allocates.  Packed rows are the forward's: p = qi * G +
//      (h % G), so a block reads K once for all G query heads of its kv head.
//   2  per (row, kv head, 16 keys, query chunk): dk and dv in registers,
//      looping over the 64-row tiles of packed rows that see the keys, so
//      the G query heads' contributions meet in one block (gemma-2b: G = 8).
//      Under a causal mask the first key block is seen by every row and the
//      last by few, so each key block's rows are cut into chunks of 16
//      tiles, one block each, that write fp32 partials; a combine kernel
//      sums each key's partials in chunk order.  (One block per key block
//      made the first one walk 256 tiles at gemma-2b's shape while the
//      average SM had 125.)
//   3  per (row, kv head, 64 packed rows): dq in registers, looping over the
//      visible 32-key tiles (heaviest row blocks first).
//
// Bound: five matrix products of 2 D FLOPs per visible (query head, key)
// pair (pass 1 and 3 recompute s, pass 2 and 3 dP, one each of dv, dk, dq),
// far above the bytes of q, k, v, o, do and the gradients: operations.  This
// first design runs them on the CUDA cores in fp32 (the fp32 path is held
// to 1e-4 and TF32 would miss it), where shared-memory loads, not FMAs, set
// the pace: each thread computes a 2-row by NC-key micro-tile of s and dP
// from fp32 tiles in padded shared memory, and accumulates one float4
// column of dk and dv for 4 contiguous keys (of dq for 16 contiguous rows),
// reading P and dS four at a time.  Tensor cores (wgmma, TMA) are the
// redesign's (ROADMAP Queue 2).
//
// Takes scalar q_offset and kv_len (training passes 0 and Sk); the wrapper
// refuses per-row tensors and any row that sees no key (its P would be a
// uniform softmax over masked keys in the forward's convention).  bf16 or
// fp32 inputs; head_dim a multiple of 4 up to 256.  Layout: q, o, do, dq
// (B, Sq, H, D); k, v, dk, dv (B, Sk, K, D); all contiguous, 16-byte
// aligned.  fa_backward returns the first failing launch's CUDA error, or 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;  // additive-mask convention of the reference

enum Mask { FULL = 0, CAUSAL = 1, LOCAL = 2, PREFIX = 3 };

constexpr int THREADS = 256;
constexpr int MAX_D = 256;
constexpr int ROWS = 64;  // packed rows per tile, every pass
constexpr int BK = 32;    // keys per tile, passes 1 and 3
constexpr int BKV = 16;   // keys per block, pass 2
constexpr int QCHUNK = 16;  // row tiles per pass-2 block (one query chunk)
constexpr int CHUNK_ROWS = ROWS * QCHUNK;
// Accumulators: a thread owns float4 column tid % D4 of a group of
// contiguous rows (keys) tid / D4; there are THREADS / D4 >= 4 groups, so a
// group holds at most ROWS / 4 rows (BKV / 4 keys)
constexpr int MAX_ROWS_PER_THREAD = ROWS / (THREADS / (MAX_D / 4));  // 16
constexpr int MAX_KEYS_PER_THREAD = BKV / (THREADS / (MAX_D / 4));   // 4
constexpr int LDP = BKV + 4;   // row stride of pass 2's P and dS (float4-aligned)
constexpr int LDT = ROWS + 4;  // key stride of pass 3's dS^T (float4-aligned)

struct Geom {
  int Sq, Sk, H, K, D, G, mask, window, prefix, qoff, klim;
  float scale, softcap;
};

__device__ __forceinline__ bool visible(int mask, int qp, int kp, int window, int prefix) {
  switch (mask) {
    case CAUSAL: return kp <= qp;
    case LOCAL: return kp <= qp && kp > qp - window;
    case PREFIX: return kp <= qp || kp < prefix;
    default: return true;
  }
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  *reinterpret_cast<uint32_t*>(&lo) = u.x;
  *reinterpret_cast<uint32_t*>(&hi) = u.y;
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) { *reinterpret_cast<float4*>(p) = x; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

// ROWS packed rows [row0, row0 + nrows) of q, o or do (B, Sq, H, D) into
// dst (ROWS x ld fp32), times mul; rows past nrows are zero.
template <typename T>
__device__ void load_rows(float* dst, const T* __restrict__ src, const Geom& g, int b, int kh,
                          int row0, int nrows, float mul) {
  const int D4 = g.D / 4, ld = g.D + 4;
  for (int i = threadIdx.x; i < ROWS * D4; i += THREADS) {
    const int r = i / D4, c4 = i - r * D4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nrows) {
      const int p = row0 + r;
      const int qi = p / g.G, h = kh * g.G + p % g.G;
      x = load4(src + ((size_t)(b * g.Sq + qi) * g.H + h) * g.D + c4 * 4);
      x.x *= mul; x.y *= mul; x.z *= mul; x.w *= mul;
    }
    store4(dst + r * ld + c4 * 4, x);
  }
}

// n keys [k0, k0 + n) of k or v (B, Sk, K, D) into dst (n x ld fp32); keys
// at or past Sk are zero.
template <typename T>
__device__ void load_keys(float* dst, const T* __restrict__ src, const Geom& g, int b, int kh,
                          int k0, int n) {
  const int D4 = g.D / 4, ld = g.D + 4;
  for (int i = threadIdx.x; i < n * D4; i += THREADS) {
    const int c = i / D4, c4 = i - c * D4;
    const int kp = k0 + c;
    const float4 x = kp < g.Sk ? load4(src + ((size_t)(b * g.Sk + kp) * g.K + kh) * g.D + c4 * 4)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(dst + c * ld + c4 * 4, x);
  }
}

// acc[i][j] = A[r0 + i] . Bm[c0 + 8 j] over D (rows of padded fp32 tiles):
// thread tid holds rows r0 = 2 (tid / 8), r0 + 1 and keys tid % 8 + 8 j.
template <int NC>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bm, int ld, int D4,
                                         float (&acc)[2][NC]) {
  const int r0 = 2 * (threadIdx.x / 8), c0 = threadIdx.x % 8;
  const float4* a0 = reinterpret_cast<const float4*>(A + r0 * ld);
  const float4* a1 = reinterpret_cast<const float4*>(A + (r0 + 1) * ld);
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[0][j] = acc[1][j] = 0.f;
  for (int d = 0; d < D4; ++d) {
    const float4 x0 = a0[d], x1 = a1[d];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const float4 y = reinterpret_cast<const float4*>(Bm + (c0 + 8 * j) * ld)[d];
      acc[0][j] = dot4(x0, y, acc[0][j]);
      acc[1][j] = dot4(x1, y, acc[1][j]);
    }
  }
}

// P and dS of the thread's micro-tile (rows r0, r0 + 1 of the tile starting
// at packed row p0; keys c0 + 8 j of the tile starting at key k0), written to
// Ps (if given) and dSs at r * rs + c * cs.  Invisible pairs, rows past
// nrows and keys past nk get 0.
template <int NC>
__device__ __forceinline__ void probs_and_grads(const Geom& g, const float (&s)[2][NC],
                                                const float (&dp)[2][NC], const float* lse_s,
                                                const float* dl_s, int p0, int nrows, int k0,
                                                int nk, float* Ps, float* dSs, int rs, int cs) {
  const int r0 = 2 * (threadIdx.x / 8), c0 = threadIdx.x % 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + i;
    const int qp = g.qoff + (p0 + r) / g.G;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = c0 + 8 * j, kp = k0 + c;
      float val = s[i][j], t = 0.f;
      if (g.softcap > 0.f) {
        t = tanhf(val / g.softcap);
        val = t * g.softcap;
      }
      const bool ok =
          r < nrows && c < nk && kp < g.klim && visible(g.mask, qp, kp, g.window, g.prefix);
      const float pr = ok ? expf(val - lse_s[r]) : 0.f;
      float ds = pr * (dp[i][j] - dl_s[r]);
      if (g.softcap > 0.f) ds *= 1.f - t * t;
      if (Ps) Ps[r * rs + c * cs] = pr;
      dSs[r * rs + c * cs] = ds;
    }
  }
}

size_t smem_bytes(int pass, int D) {
  const size_t ld = D + 4;
  switch (pass) {
    case 1: return sizeof(float) * (ROWS * ld + BK * ld + ROWS * (BK + 1) + 2 * ROWS);
    case 2: return sizeof(float) * (2 * BKV * ld + 2 * ROWS * ld + 2 * ROWS * LDP + 2 * ROWS);
    case 3: return sizeof(float) * (2 * ROWS * ld + 2 * BK * ld + BK * LDT + 2 * ROWS);
    default: return 0;
  }
}

// ---------------------------------------------------------------------------
// pass 1: lse and delta
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fa_bwd_lse_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
                  const T* __restrict__ dout, float* __restrict__ lse,
                  float* __restrict__ delta, Geom g) {
  extern __shared__ float4 smem4[];
  const int ld = g.D + 4, D4 = g.D / 4;
  float* Qs = reinterpret_cast<float*>(smem4);  // ROWS x ld, scaled
  float* Ks = Qs + ROWS * ld;                   // BK x ld
  float* Ss = Ks + BK * ld;                     // ROWS x (BK + 1)
  float* m_s = Ss + ROWS * (BK + 1);
  float* l_s = m_s + ROWS;

  const int b = blockIdx.z, kh = blockIdx.y;
  const int R = g.Sq * g.G;
  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, R - row0);
  const size_t base = (size_t)(b * g.K + kh) * R + row0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  load_rows(Qs, q, g, b, kh, row0, nrows, g.scale);
  for (int r = tid; r < ROWS; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  // delta = rowsum(do * o): one warp per row
  for (int r = warp; r < nrows; r += THREADS / 32) {
    const int p = row0 + r;
    const size_t off = ((size_t)(b * g.Sq + p / g.G) * g.H + kh * g.G + p % g.G) * g.D;
    float acc = 0.f;
    for (int c4 = lane; c4 < D4; c4 += 32) acc = dot4(load4(dout + off + 4 * c4), load4(o + off + 4 * c4), acc);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (lane == 0) delta[base + r] = acc;
  }

  // the keys any row of the block can see
  const int q_lo = g.qoff + row0 / g.G, q_hi = g.qoff + (row0 + nrows - 1) / g.G;
  int end = g.klim;
  if (g.mask == CAUSAL || g.mask == LOCAL) end = min(end, q_hi + 1);
  if (g.mask == PREFIX) end = min(end, max(q_hi + 1, g.prefix));
  const int beg = g.mask == LOCAL ? max(0, q_lo - g.window + 1) / BK * BK : 0;

  const int r0 = 2 * (tid / 8), c0 = tid % 8;
  for (int k0 = beg; k0 < end; k0 += BK) {
    __syncthreads();  // the previous tile's K and scores are consumed
    load_keys(Ks, k, g, b, kh, k0, BK);
    __syncthreads();
    float s[2][4];
    dot_tile<4>(Qs, Ks, ld, D4, s);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + i, qp = g.qoff + (row0 + r) / g.G;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + 8 * j, kp = k0 + c;
        float val = s[i][j];
        if (g.softcap > 0.f) val = tanhf(val / g.softcap) * g.softcap;
        const bool ok = r < nrows && kp < g.klim && visible(g.mask, qp, kp, g.window, g.prefix);
        Ss[r * (BK + 1) + c] = ok ? val : NEG_INF;
      }
    }
    __syncthreads();
    // online max and sum: one warp per row, one lane per key (the forward's)
    for (int r = warp; r < nrows; r += THREADS / 32) {
      const float v = Ss[r * (BK + 1) + lane];
      float mx = v;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = expf(v - m_new);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      if (lane == 0) {
        l_s[r] = l_s[r] * expf(m_old - m_new) + sum;
        m_s[r] = m_new;
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < nrows; r += THREADS) lse[base + r] = m_s[r] + logf(l_s[r]);
}

// ---------------------------------------------------------------------------
// pass 2: dk and dv, per key block and query chunk
// ---------------------------------------------------------------------------

// The packed rows [x, y) whose queries see any key of [k0, k0 + nk).
__device__ __forceinline__ int2 rows_seeing(Geom g, int k0, int nk) {
  int qp_lo = g.qoff, qp_hi = g.qoff + g.Sq;
  const int k_last = min(k0 + nk, g.klim) - 1;
  if (k_last < k0) qp_hi = qp_lo;  // every key of the block is past kv_len
  else if (g.mask == CAUSAL) qp_lo = max(qp_lo, k0);
  else if (g.mask == LOCAL) {
    qp_lo = max(qp_lo, k0);
    qp_hi = min(qp_hi, k_last + g.window);
  } else if (g.mask == PREFIX && k0 >= g.prefix) qp_lo = max(qp_lo, k0);
  const int p_lo = (qp_lo - g.qoff) * g.G;
  return make_int2(p_lo, max(p_lo, (qp_hi - g.qoff) * g.G));
}

// Query chunks of key block kb (at least one, which may be empty).
__device__ __forceinline__ int chunks_of(Geom g, int kb) {
  const int k0 = kb * BKV;
  const int2 p = rows_seeing(g, k0, min(BKV, g.Sk - k0));
  return max(1, (p.y - p.x + CHUNK_ROWS - 1) / CHUNK_ROWS);
}

// Grid (key blocks, chunks, B * K): the block's partial dk and dv go to
// part_k / part_v (chunk, B, Sk, K, D) fp32; a block past its key block's
// last chunk returns at once.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ part_k,
                  float* __restrict__ part_v, int B, Geom g) {
  extern __shared__ float4 smem4[];
  const int ld = g.D + 4, D4 = g.D / 4, ld4 = ld / 4;
  float* Ks = reinterpret_cast<float*>(smem4);  // BKV x ld
  float* Vs = Ks + BKV * ld;                    // BKV x ld
  float* Qs = Vs + BKV * ld;                    // ROWS x ld, scaled
  float* dOs = Qs + ROWS * ld;                  // ROWS x ld
  float* Ps = dOs + ROWS * ld;                  // ROWS x LDP
  float* dSs = Ps + ROWS * LDP;                 // ROWS x LDP
  float* lse_s = dSs + ROWS * LDP;
  float* dl_s = lse_s + ROWS;

  const int b = blockIdx.z / g.K, kh = blockIdx.z % g.K;
  const int R = g.Sq * g.G;
  const int k0 = blockIdx.x * BKV;
  const int nk = min(BKV, g.Sk - k0);
  const int chunk = blockIdx.y;
  const int2 rows = rows_seeing(g, k0, nk);
  const int c_lo = rows.x + chunk * CHUNK_ROWS, c_hi = min(rows.y, c_lo + CHUNK_ROWS);
  if (chunk > 0 && c_lo >= rows.y) return;  // past the last chunk (uniform over the block)
  const size_t base = (size_t)(b * g.K + kh) * R;
  const int tid = threadIdx.x;

  load_keys(Ks, k, g, b, kh, k0, BKV);
  load_keys(Vs, v, g, b, kh, k0, BKV);

  // thread: float4 column cg of keys [c0, c0 + kpt)
  const int groups = THREADS / D4, kpt = (BKV + groups - 1) / groups;
  const int cg = tid % D4, c0 = tid / D4 * kpt;
  const bool owner = tid < groups * D4 && c0 < BKV;
  float4 dk_acc[MAX_KEYS_PER_THREAD], dv_acc[MAX_KEYS_PER_THREAD];
#pragma unroll
  for (int j = 0; j < MAX_KEYS_PER_THREAD; ++j)
    dk_acc[j] = dv_acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int p0 = c_lo; p0 < c_hi; p0 += ROWS) {
    const int nrows = min(ROWS, c_hi - p0);
    __syncthreads();  // the previous tile is consumed
    load_rows(Qs, q, g, b, kh, p0, nrows, g.scale);
    load_rows(dOs, dout, g, b, kh, p0, nrows, 1.f);
    for (int r = tid; r < ROWS; r += THREADS) {
      lse_s[r] = r < nrows ? lse[base + p0 + r] : 0.f;
      dl_s[r] = r < nrows ? delta[base + p0 + r] : 0.f;
    }
    __syncthreads();
    float s[2][2], dp[2][2];
    dot_tile<2>(Qs, Ks, ld, D4, s);
    dot_tile<2>(dOs, Vs, ld, D4, dp);
    probs_and_grads<2>(g, s, dp, lse_s, dl_s, p0, nrows, k0, nk, Ps, dSs, LDP, 1);
    __syncthreads();
    if (owner) {
      const float4* Q4 = reinterpret_cast<const float4*>(Qs);
      const float4* dO4 = reinterpret_cast<const float4*>(dOs);
      for (int r = 0; r < nrows; ++r) {
        const float4 qv = Q4[r * ld4 + cg], dov = dO4[r * ld4 + cg];
        if (kpt == 4) {  // D = 256: one float4 of P and one of dS a row
          const float4 pr = *reinterpret_cast<const float4*>(Ps + r * LDP + c0);
          const float4 ds = *reinterpret_cast<const float4*>(dSs + r * LDP + c0);
          axpy4(pr.x, dov, dv_acc[0]); axpy4(pr.y, dov, dv_acc[1]);
          axpy4(pr.z, dov, dv_acc[2]); axpy4(pr.w, dov, dv_acc[3]);
          axpy4(ds.x, qv, dk_acc[0]); axpy4(ds.y, qv, dk_acc[1]);
          axpy4(ds.z, qv, dk_acc[2]); axpy4(ds.w, qv, dk_acc[3]);
        } else {
#pragma unroll
          for (int j = 0; j < MAX_KEYS_PER_THREAD; ++j) {
            if (j < kpt && c0 + j < BKV) {
              axpy4(Ps[r * LDP + c0 + j], dov, dv_acc[j]);
              axpy4(dSs[r * LDP + c0 + j], qv, dk_acc[j]);
            }
          }
        }
      }
    }
  }
  if (owner) {
#pragma unroll
    for (int j = 0; j < MAX_KEYS_PER_THREAD; ++j) {
      const int c = c0 + j;
      if (j < kpt && c < nk) {
        const size_t off =
            (((size_t)(chunk * B + b) * g.Sk + k0 + c) * g.K + kh) * g.D + cg * 4;
        *reinterpret_cast<float4*>(part_k + off) = dk_acc[j];
        *reinterpret_cast<float4*>(part_v + off) = dv_acc[j];
      }
    }
  }
}

// dk and dv: each key's partials summed in chunk order.  Grid (key blocks,
// B * K); a thread sums float4 columns of the block's keys.
template <typename T>
__global__ void __launch_bounds__(256)
fa_bwd_dkv_combine(const float* __restrict__ part_k, const float* __restrict__ part_v,
                   T* __restrict__ dk, T* __restrict__ dv, int B, Geom g) {
  const int b = blockIdx.y / g.K, kh = blockIdx.y % g.K;
  const int k0 = blockIdx.x * BKV, nk = min(BKV, g.Sk - k0);
  const int chunks = chunks_of(g, blockIdx.x);
  const int D4 = g.D / 4;
  const size_t stride = (size_t)B * g.Sk * g.K * g.D;  // one chunk's partials
  for (int i = threadIdx.x; i < nk * D4; i += blockDim.x) {
    const int c = i / D4, c4 = i - c * D4;
    const size_t off = ((size_t)(b * g.Sk + k0 + c) * g.K + kh) * g.D + 4 * c4;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int ch = 0; ch < chunks; ++ch) {
      const float4 a = *reinterpret_cast<const float4*>(part_k + ch * stride + off);
      const float4 e = *reinterpret_cast<const float4*>(part_v + ch * stride + off);
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
      sv.x += e.x; sv.y += e.y; sv.z += e.z; sv.w += e.w;
    }
    store4(dk + off, sk);
    store4(dv + off, sv);
  }
}

// ---------------------------------------------------------------------------
// pass 3: dq
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, Geom g) {
  extern __shared__ float4 smem4[];
  const int ld = g.D + 4, D4 = g.D / 4, ld4 = ld / 4;
  float* Qs = reinterpret_cast<float*>(smem4);  // ROWS x ld, scaled
  float* dOs = Qs + ROWS * ld;                  // ROWS x ld
  float* Ks = dOs + ROWS * ld;                  // BK x ld
  float* Vs = Ks + BK * ld;                     // BK x ld
  float* dSt = Vs + BK * ld;                    // BK x LDT: dS transposed
  float* lse_s = dSt + BK * LDT;
  float* dl_s = lse_s + ROWS;

  const int b = blockIdx.z, kh = blockIdx.y;
  const int R = g.Sq * g.G;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // heaviest (latest) rows first
  const int nrows = min(ROWS, R - row0);
  const size_t base = (size_t)(b * g.K + kh) * R + row0;
  const int tid = threadIdx.x;

  load_rows(Qs, q, g, b, kh, row0, nrows, g.scale);
  load_rows(dOs, dout, g, b, kh, row0, nrows, 1.f);
  for (int r = tid; r < ROWS; r += THREADS) {
    lse_s[r] = r < nrows ? lse[base + r] : 0.f;
    dl_s[r] = r < nrows ? delta[base + r] : 0.f;
  }

  const int q_lo = g.qoff + row0 / g.G, q_hi = g.qoff + (row0 + nrows - 1) / g.G;
  int end = g.klim;
  if (g.mask == CAUSAL || g.mask == LOCAL) end = min(end, q_hi + 1);
  if (g.mask == PREFIX) end = min(end, max(q_hi + 1, g.prefix));
  const int beg = g.mask == LOCAL ? max(0, q_lo - g.window + 1) / BK * BK : 0;

  // thread: float4 column cg of rows [r0, r0 + rpt)
  const int groups = THREADS / D4, rpt = (ROWS + groups - 1) / groups;
  const int cg = tid % D4, r0 = tid / D4 * rpt;
  const bool owner = tid < groups * D4 && r0 < ROWS;
  float4 acc[MAX_ROWS_PER_THREAD];
#pragma unroll
  for (int j = 0; j < MAX_ROWS_PER_THREAD; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = beg; k0 < end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    load_keys(Ks, k, g, b, kh, k0, BK);
    load_keys(Vs, v, g, b, kh, k0, BK);
    __syncthreads();
    float s[2][4], dp[2][4];
    dot_tile<4>(Qs, Ks, ld, D4, s);
    dot_tile<4>(dOs, Vs, ld, D4, dp);
    probs_and_grads<4>(g, s, dp, lse_s, dl_s, row0, nrows, k0, BK, nullptr, dSt, 1, LDT);
    __syncthreads();
    if (owner) {
      const float4* K4 = reinterpret_cast<const float4*>(Ks);
      for (int c = 0; c < BK; ++c) {
        const float4 kv = K4[c * ld4 + cg];
        const float* ds = dSt + c * LDT + r0;
        if (rpt % 4 == 0) {  // four rows of dS a load
#pragma unroll
          for (int j = 0; j < MAX_ROWS_PER_THREAD; j += 4) {
            if (j < rpt) {
              const float4 d4 = *reinterpret_cast<const float4*>(ds + j);
              axpy4(d4.x, kv, acc[j]);
              axpy4(d4.y, kv, acc[j + 1]);
              axpy4(d4.z, kv, acc[j + 2]);
              axpy4(d4.w, kv, acc[j + 3]);
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < MAX_ROWS_PER_THREAD; ++j)
            if (j < rpt && r0 + j < ROWS) axpy4(ds[j], kv, acc[j]);
        }
      }
    }
  }
  if (owner) {
#pragma unroll
    for (int j = 0; j < MAX_ROWS_PER_THREAD; ++j) {
      const int r = r0 + j;
      if (j < rpt && r < nrows) {
        const int p = row0 + r;
        const int qi = p / g.G, h = kh * g.G + p % g.G;
        float4 x = acc[j];
        x.x *= g.scale; x.y *= g.scale; x.z *= g.scale; x.w *= g.scale;
        store4(dq + ((size_t)(b * g.Sq + qi) * g.H + h) * g.D + cg * 4, x);
      }
    }
  }
}

// Scratch, in floats, each part a multiple of 4: lse and delta (B, K, Sq*G);
// the dk and dv partials (chunks, B, Sk, K, D) each.
struct Scratch {
  size_t lse, part, total;
  int chunks;
  Scratch(int B, int Sq, int Sk, int H, int K, int D) {
    const size_t rows = ((size_t)B * K * Sq * (H / K) + 3) / 4 * 4;
    const int row_tiles = (Sq * (H / K) + ROWS - 1) / ROWS;
    chunks = row_tiles > QCHUNK ? (row_tiles + QCHUNK - 1) / QCHUNK : 1;
    lse = rows;
    part = (size_t)chunks * B * Sk * K * D;
    total = 2 * rows + 2 * part;
  }
};

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, float* scratch, int B, const Geom& g, cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const Scratch sc(B, g.Sq, g.Sk, g.H, g.K, g.D);
  float* lse = scratch;
  float* delta = lse + sc.lse;
  float* part_k = delta + sc.lse;
  float* part_v = part_k + sc.part;
  const int row_blocks = (g.Sq * g.G + ROWS - 1) / ROWS;
  const int key_blocks = (g.Sk + BKV - 1) / BKV;
  const dim3 block(THREADS);
  static bool smem_set = false;  // once per type, at the largest head_dim
  cudaError_t e;
  if (!smem_set) {
    if ((e = cudaFuncSetAttribute(fa_bwd_lse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_bytes(1, MAX_D))) != cudaSuccess ||
        (e = cudaFuncSetAttribute(fa_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_bytes(2, MAX_D))) != cudaSuccess ||
        (e = cudaFuncSetAttribute(fa_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_bytes(3, MAX_D))) != cudaSuccess)
      return (int)e;
    smem_set = true;
  }

  fa_bwd_lse_kernel<T><<<dim3(row_blocks, g.K, B), block, smem_bytes(1, g.D), st>>>(
      qt, kt, static_cast<const T*>(o), dot, lse, delta, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  fa_bwd_dkv_kernel<T><<<dim3(key_blocks, sc.chunks, B * g.K), block,
                         smem_bytes(2, g.D), st>>>(qt, kt, vt, dot, lse, delta, part_k, part_v,
                                                   B, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  fa_bwd_dkv_combine<T><<<dim3(key_blocks, B * g.K), 256, 0, st>>>(
      part_k, part_v, static_cast<T*>(dk), static_cast<T*>(dv), B, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  fa_bwd_dq_kernel<T><<<dim3(row_blocks, g.K, B), block, smem_bytes(3, g.D), st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), g);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block of pass 1, 2 or 3 at head_dim D.
extern "C" size_t fa_bwd_smem_bytes(int pass, int D) { return smem_bytes(pass, D); }

// fp32 scratch fa_backward needs, in floats.
extern "C" size_t fa_bwd_scratch_floats(int B, int Sq, int Sk, int H, int K, int D) {
  return Scratch(B, Sq, Sk, H, K, D).total;
}

// scratch: fa_bwd_scratch_floats(...) fp32, 16-byte aligned.
extern "C" int fa_backward(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, void* dq, void* dk, void* dv, float* scratch, int B,
                           int Sq, int Sk, int H, int K, int D, int mask, int window, int prefix,
                           int q_offset, int kv_len, float scale, float softcap, int is_bf16,
                           void* stream) {
  if (D < 4 || D > MAX_D || D % 4 != 0 || K < 1 || H % K != 0 || mask < FULL || mask > PREFIX ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Sk == 0) return 0;
  const Geom g{Sq, Sk, H, K, D, H / K, mask, window, prefix, q_offset, kv_len < Sk ? kv_len : Sk,
               scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, scratch, B, g, st);
  return launch<float>(q, k, v, o, dout, dq, dk, dv, scratch, B, g, st);
}
