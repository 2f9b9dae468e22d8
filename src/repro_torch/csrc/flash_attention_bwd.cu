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
// Two variants behind one entry point, fa_backward; the caller (the Python
// wrapper's plan_bwd()) names the variant and nothing here picks one.  Both
// run three passes (four launches) on the caller's stream, take every sum in
// fp32 in a fixed order (no atomics), so the same inputs give bitwise-equal
// gradients, and pack rows as the forward does: p = qi * G + (h % G), so a
// block reads K and V once for all G query heads of its kv head.
//
// Bound: five matrix products of 2 D FLOPs per visible (query head, key)
// pair (s recomputed, dP, dv, dk, dq), far above the bytes of q, k, v, o,
// do and the gradients: operations.
//
// tc   bf16, D in {32, 64, 128, 256}, G dividing 64.  FlashAttention-2/3's
//      passes on the tensor cores (wgmma, bf16 operands, fp32
//      accumulators), each block two warpgroups, tiles streamed by TMA
//      (128 B swizzle, 64 B at D = 32) through two-stage mbarrier rings:
//   1  per (row, kv head, 64 packed rows): lse from S = Q K^T over the
//      visible 64-key tiles (the warpgroups take alternate tiles, each an
//      online max and sum, merged at the end), delta = rowsum(do o);
//   2  per (row, kv head, 64-key block, query chunk), transposed: S^T =
//      K Q^T and dP^T = V dO^T, each warpgroup 32 of the tile's 64 rows
//      (m64n32), so P^T = e^(S^T - lse) and dS^T = P^T (1 - tanh^2)
//      (dP^T - delta) are computed where they land; both go to shared
//      memory as bf16 tiles, the A operands of dV += P^T dO and dK += dS^T
//      Q with dO and Q read MN-major (the forward's V).  At D >= 128 the
//      warpgroups split D (dk + dv of 64 keys at D = 256 are 256 fp32
//      registers a thread), below it the products' depth.  K and V stay
//      resident; Q and dO stream.  The chunk (plan: the fewest row tiles
//      keeping the grid within two waves of 132 blocks) writes fp32
//      partials, summed in chunk order by fa_bwd_dkv_combine;
//   3  per (row, kv head, 64 packed rows): S = Q K^T and dP = dO V^T, each
//      warpgroup 32 of the tile's keys; dS to shared memory; dQ += dS K
//      split as in pass 2, K and V streaming, heaviest row blocks first.
//      Masks are applied before the exp, only on tiles that cross a mask
//      edge or kv_len.  Against the bound: the passes run eight products
//      where it counts five (S in all three, dP in two, as lse is not kept
//      from the forward), and inside a tile the score products, the exp and
//      the exchange, the barriers and the accumulating products run one
//      after another (no ping-pong of two row tiles as in FlashAttention-3),
//      so the tensor cores wait while the rest runs.  How a pass's time
//      splits among these is not measured (PERF.md, section 7).
// simt the first design: fp32 (held to 1e-4, which TF32 would miss)
//      and other head dims, on the CUDA cores, where shared-memory
//      loads, not FMAs, set the pace:
//   1  per (row, kv head, 64 packed rows): lse by an online max and sum
//      over the visible 32-key tiles, and delta; both fp32, into the
//      scratch the wrapper allocates.
//   2  per (row, kv head, 16 keys, query chunk): dk and dv in registers,
//      looping over the 64-row tiles of packed rows that see the keys, so
//      the G query heads' contributions meet in one block (gemma-2b: G =
//      8).  Under a causal mask the first key block is seen by every row
//      and the last by few, so each key block's rows are cut into chunks
//      of 16 tiles, one block each, that write fp32 partials; a combine
//      kernel sums each key's partials in chunk order.
//   3  per (row, kv head, 64 packed rows): dq in registers, looping over
//      the visible 32-key tiles (heaviest row blocks first).
//      Each thread computes a 2-row by NC-key micro-tile of s and dP from
//      fp32 tiles in padded shared memory, and accumulates one float4
//      column of dk and dv for 4 contiguous keys (of dq for 16 contiguous
//      rows), reading P and dS four at a time.
//
// Takes scalar q_offset and kv_len (training passes 0 and Sk); the wrapper
// refuses per-row tensors and any row that sees no key (its P would be a
// uniform softmax over masked keys in the forward's convention).  Layout:
// q, o, do, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, K, D); all contiguous,
// 16-byte aligned.  fa_backward returns the first failing call's CUDA
// error, or 0.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;  // additive-mask convention of the reference

enum Mask { FULL = 0, CAUSAL = 1, LOCAL = 2, PREFIX = 3 };
enum BwdVariant { BWD_TC = 0, BWD_SIMT = 1 };

constexpr int THREADS = 256;
constexpr int MAX_D = 256;
constexpr int ROWS = 64;  // packed rows per tile, every pass
constexpr int BK = 32;    // keys per tile, passes 1 and 3
constexpr int BKV = 16;   // keys per block, pass 2
constexpr int QCHUNK = 16;  // row tiles per pass-2 block (one query chunk)
constexpr int CHUNK_ROWS = ROWS * QCHUNK;
constexpr int COMBINE_KEYS = 8;  // keys per block of fa_bwd_dkv_combine
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

// Query chunks of crows packed rows of the key block [k0, k0 + bkeys) (at
// least one, which may be empty).
__device__ __forceinline__ int chunks_of(Geom g, int k0, int bkeys, int crows) {
  const int2 p = rows_seeing(g, k0, min(bkeys, g.Sk - k0));
  return max(1, (p.y - p.x + crows - 1) / crows);
}

// The chunks of the key blocks before kb (BKEYS wide): where kb's first
// chunk lies among the tc dk/dv pass's packed partials.  Each lane counts
// every 32nd key block and the warp adds them up, so all 32 lanes of a
// warp must call.
__device__ __forceinline__ int chunks_before(Geom g, int kb, int bkeys, int crows) {
  int n = 0;
  for (int j = threadIdx.x & 31; j < kb; j += 32) n += chunks_of(g, j * bkeys, bkeys, crows);
  for (int w = 16; w > 0; w >>= 1) n += __shfl_xor_sync(0xffffffffu, n, w);
  return n;
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

// dk and dv: each key's partials summed in chunk order.  Both variants'
// dk/dv passes end with it: their key blocks are BKEYS wide (simt 16, tc
// 64) and their query chunks crows packed rows.  simt's partials are
// (chunk, B, Sk, K, D), one slab per chunk over every key; tc's are PACKED:
// (slot, B * K, BKEYS, D), one slot per chunk there is, key block by key
// block, each key block's chunks in order.  Grid (Sk / COMBINE_KEYS, B *
// K); a thread sums float4 columns of the block's keys.
template <typename T, int BKEYS, bool PACKED>
__global__ void __launch_bounds__(256)
fa_bwd_dkv_combine(const float* __restrict__ part_k, const float* __restrict__ part_v,
                   T* __restrict__ dk, T* __restrict__ dv, int B, int crows, Geom g) {
  const int b = blockIdx.y / g.K, kh = blockIdx.y % g.K;
  const int k0 = blockIdx.x * COMBINE_KEYS, nk = min(COMBINE_KEYS, g.Sk - k0);
  const int kb = k0 / BKEYS;  // COMBINE_KEYS divides BKEYS: one key block
  const int chunks = chunks_of(g, kb * BKEYS, BKEYS, crows);
  const int D4 = g.D / 4;
  size_t base, stride, key_stride;  // the block's first key in chunk 0; chunk and key strides
  if (PACKED) {
    stride = (size_t)gridDim.y * BKEYS * g.D;
    key_stride = g.D;
    base = (size_t)chunks_before(g, kb, BKEYS, crows) * stride +
           ((size_t)blockIdx.y * BKEYS + k0 - kb * BKEYS) * g.D;
  } else {
    stride = (size_t)B * g.Sk * g.K * g.D;
    key_stride = (size_t)g.K * g.D;
    base = ((size_t)(b * g.Sk + k0) * g.K + kh) * g.D;
  }
  for (int i = threadIdx.x; i < nk * D4; i += blockDim.x) {
    const int c = i / D4, c4 = i - c * D4;
    const size_t off = ((size_t)(b * g.Sk + k0 + c) * g.K + kh) * g.D + 4 * c4;
    const size_t poff = base + c * key_stride + 4 * c4;
    float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
    for (int ch = 0; ch < chunks; ++ch) {
      const float4 a = *reinterpret_cast<const float4*>(part_k + ch * stride + poff);
      const float4 e = *reinterpret_cast<const float4*>(part_v + ch * stride + poff);
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
// then the dk and dv partials, `part` floats each: simt's (chunks, B, Sk,
// K, D) for query chunks of QCHUNK 64-row tiles, tc's packed (items, B *
// K, 64, D) for the `items` chunks of a (row, kv head) over its key blocks.
struct Scratch {
  size_t lse, part, total;
  int chunks;  // simt's query chunks a key block
  Scratch(int B, int Sq, int Sk, int H, int K, int D, int variant, int items) {
    lse = ((size_t)B * K * Sq * (H / K) + 3) / 4 * 4;
    const int row_tiles = (Sq * (H / K) + ROWS - 1) / ROWS;
    chunks = row_tiles > QCHUNK ? (row_tiles + QCHUNK - 1) / QCHUNK : 1;
    part = variant == BWD_TC ? (size_t)B * K * items * ROWS * D : (size_t)chunks * B * Sk * K * D;
    total = 2 * lse + 2 * part;
  }
};

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, float* scratch, int B, const Geom& g, cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const Scratch sc(B, g.Sq, g.Sk, g.H, g.K, g.D, BWD_SIMT, 0);
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
  fa_bwd_dkv_combine<T, BKV, false><<<dim3((g.Sk + COMBINE_KEYS - 1) / COMBINE_KEYS, B * g.K),
                                       256, 0, st>>>(
      part_k, part_v, static_cast<T*>(dk), static_cast<T*>(dv), B, CHUNK_ROWS, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  fa_bwd_dq_kernel<T><<<dim3(row_blocks, g.K, B), block, smem_bytes(3, g.D), st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), g);
  return (int)cudaGetLastError();
}

// ===========================================================================
// tc: bf16 on the tensor cores (wgmma), FlashAttention-2/3's three passes
// ===========================================================================

namespace tc {

constexpr int TILE = 64;  // rows of every tile: 64 packed rows, or 64 keys
static_assert(TILE == ROWS, "Scratch sizes the tc partials by ROWS keys a block");
constexpr float LOG2E = 1.4426950408889634f;

// A 64-row tile of width D in the swizzled layout wgmma reads (the
// forward's): column blocks of SWE elements, each 64 rows of SW bytes.
// With SPLIT_N the two warpgroups of a block split an accumulator's D
// columns (D >= 128: dk + dv at D = 256 would be 256 registers a thread in
// one warpgroup); else each holds every column and takes half the
// product's depth, and the halves are summed in a fixed order at the end.
template <int D>
struct Geo {
  static constexpr int SWE = D < 64 ? D : 64;
  static constexpr int SW = SWE * 2;                // 128 B, or 64 B at D = 32
  static constexpr int NCB = D / SWE;
  static constexpr int LAYOUT = SW == 128 ? 1 : 2;  // descriptor swizzle: 128 B / 64 B
  static constexpr int SWZ = SW == 128 ? 7 : 3;     // address bits 7.. XORed into bits 4..
  static constexpr int BYTES = TILE * D * 2;
  static constexpr bool SPLIT_N = D >= 128;
  static constexpr int NW = SPLIT_N ? D / 2 : D;    // accumulator columns of a warpgroup
};
constexpr int XBYTES = TILE * TILE * 2;  // a bf16 64 x 64 exchange tile (P^T, dS^T, dS)

// Dynamic shared memory (1 KB of alignment slack; every tile 1024-aligned;
// 64 bytes of mbarriers at the end):
//   pass 1  Q, two K tiles a warpgroup, warpgroup 1's (m, l)
//   pass 2  K, V, two (Q, dO) stages, P^T, dS^T, two (lse, delta) stages
//   pass 3  Q, dO, two (K, V) stages, dS, lse and delta
template <int D>
constexpr size_t smem_bytes(int pass) {
  return 1024 + 64 +
         (pass == 1   ? 5 * (size_t)Geo<D>::BYTES + 2 * TILE * 4
          : pass == 2 ? 6 * (size_t)Geo<D>::BYTES + 2 * XBYTES + 4 * TILE * 4
                      : 6 * (size_t)Geo<D>::BYTES + XBYTES + 2 * TILE * 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));  // 0 source bytes: the hardware writes zeros
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
// every copy of this thread has landed, and is visible to wgmma (the async
// proxy) once the caller's barrier has passed
__device__ __forceinline__ void cp_async_drain() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// A wait that never ends is a fault: trap after ~2^26 polls (seconds), so
// a broken pipeline fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (uint32_t n = 0; !mbar_try(bar, parity); ++n)
    if (n == (1u << 26)) __trap();
}
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load5(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, int c3, int c4, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4),
      "r"(bar)
      : "memory");
}
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bar_wg2(int id) {  // both warpgroups of the block
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout; tiles are 1024-byte aligned, so
// the base offset is 0.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ---- generated: one wrapper per wgmma shape the tc variant runs; both
// operands from shared memory, A K-major; _t: B MN-major (transposed) ----
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_m64n32(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_t_m64n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_t_m64n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_t_m64n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// ---- end of generated wrappers ----

template <int N>
__device__ __forceinline__ void wgmma_ss_t(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 32) wgmma_ss_t_m64n32(d, da, db);
  else if constexpr (N == 64) wgmma_ss_t_m64n64(d, da, db);
  else wgmma_ss_t_m64n128(d, da, db);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// Byte offset of 16-byte chunk c of row r in a 64-row tile of width D.
template <int D>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  using Gm = Geo<D>;
  const int cb = c / (Gm::SWE / 8), cc = c % (Gm::SWE / 8);
  const uint32_t off = cb * TILE * Gm::SW + r * Gm::SW + cc * 16;
  return off ^ (((off >> 7) & Gm::SWZ) << 4);
}

// Packed rows [p0, p0 + 64) of q, o or do (B, Sq, H, D) of kv head kh into
// the tile at dst (rows at or past Sq*G read as zero), by threads t, t + n, ...
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                          const Geom& g, int b, int kh, int p0, int t, int n) {
  const int R = g.Sq * g.G;
  for (int i = t; i < TILE * D / 8; i += n) {
    const int r = i / (D / 8), c = i % (D / 8), p = p0 + r;
    const bool ok = p < R;
    const __nv_bfloat16* s =
        ok ? src + ((size_t)(b * g.Sq + p / g.G) * g.H + kh * g.G + p % g.G) * D + c * 8 : src;
    cp_async16(dst + swz<D>(r, c), s, ok);
  }
}

// Keys [k0, k0 + 64) of k or v (B, Sk, K, D) into the tile at dst (keys at
// or past Sk read as zero).
template <int D>
__device__ __forceinline__ void load_keys(uint32_t dst, const __nv_bfloat16* __restrict__ src,
                                          const Geom& g, int b, int kh, int k0, int t, int n) {
  for (int i = t; i < TILE * D / 8; i += n) {
    const int r = i / (D / 8), c = i % (D / 8), kp = k0 + r;
    const bool ok = kp < g.Sk;
    const __nv_bfloat16* s = ok ? src + ((size_t)(b * g.Sk + kp) * g.K + kh) * D + c * 8 : src;
    cp_async16(dst + swz<D>(r, c), s, ok);
  }
}

// 64 floats of one (row, kv head)'s lse or delta from packed row p0 (zero
// at or past R).
__device__ __forceinline__ void load_stats(uint32_t dst, const float* __restrict__ src, int p0,
                                           int R, int t, int n) {
  for (int r = t; r < TILE; r += n) cp_async4(dst + 4 * r, src + min(p0 + r, R - 1), p0 + r < R);
}

// A 64-row tile by TMA into dst, one box per column block, completing on
// bar: keys [k0, k0 + 64) of kv head kh through a map of k or v as {D, K,
// Sk, B} (keys at or past Sk read as zero).
template <int D>
__device__ __forceinline__ void tma_keys(uint32_t dst, const CUtensorMap* map, int b, int kh,
                                         int k0, uint32_t bar) {
  using Gm = Geo<D>;
#pragma unroll
  for (int cb = 0; cb < Gm::NCB; ++cb)
    tma_load4(dst + cb * TILE * Gm::SW, map, cb * Gm::SWE, kh, k0, b, bar);
}
// ... or packed rows [p0, p0 + 64) of kv head kh through a map of q or do as
// {D, G, K, Sq, B}: 64 / G queries of G heads (p0 a multiple of G; queries
// at or past Sq read as zero).
template <int D>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map, int b, int kh,
                                         int p0, int G, uint32_t bar) {
  using Gm = Geo<D>;
#pragma unroll
  for (int cb = 0; cb < Gm::NCB; ++cb)
    tma_load5(dst + cb * TILE * Gm::SW, map, cb * Gm::SWE, 0, kh, p0 / G, b, bar);
}

// acc = A B^T over D, for the N rows of B from row b_row: A and B 64-row
// tiles of width D (K-major).
template <int D, int N>
__device__ __forceinline__ void mma_scores(float (&acc)[N / 2], uint32_t a, uint32_t b, int b_row) {
  using Gm = Geo<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk * 16 / Gm::SWE) * TILE * Gm::SW + (kk * 16 % Gm::SWE) * 2;
    const uint64_t da = desc(a + off, 16, 8 * Gm::SW, Gm::LAYOUT);
    const uint64_t db = desc(b + b_row * Gm::SW + off, 16, 8 * Gm::SW, Gm::LAYOUT);
    if constexpr (N == 64) wgmma_ss_m64n64(acc, da, db, kk > 0);
    else wgmma_ss_m64n32(acc, da, db, kk > 0);
  }
}

// acc += X B over 64: X a 64 x 64 exchange tile (K-major A), B a 64-row
// tile of width D read MN-major (the forward's V).  With SPLIT_N warpgroup
// wg takes columns [wg D / 2, (wg + 1) D / 2) over all 64; else every
// column over depth [32 wg, 32 wg + 32).
template <int D>
__device__ __forceinline__ void mma_accum(float (&acc)[Geo<D>::NW / 2], uint32_t x, uint32_t b,
                                          int wg) {
  using Gm = Geo<D>;
  constexpr int STEPS = Gm::SPLIT_N ? TILE / 16 : TILE / 32;
  const uint32_t b0 = Gm::SPLIT_N ? b + wg * (Gm::NCB / 2) * TILE * Gm::SW : b;
  const int kk0 = Gm::SPLIT_N ? 0 : STEPS * wg;
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    const int kk = kk0 + j;
    wgmma_ss_t<Gm::NW>(acc, desc(x + kk * 32, 16, 8 * 128, 1),
                       desc(b0 + kk * 16 * Gm::SW, TILE * Gm::SW, 8 * Gm::SW, Gm::LAYOUT));
  }
}

// Fragment element i of thread t: (row, column) of a 64 x N accumulator.
__device__ __forceinline__ int frag_row(int i, int t) {
  return t / 32 * 16 + t % 32 / 4 + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int i, int t) { return 8 * (i >> 2) + 2 * (t % 4) + (i & 1); }

// A warpgroup's 64 x 32 fp32 fragment x as bf16 into columns [col0,
// col0 + 32) of an exchange tile: rows of 64 elements, 128 B swizzle (the
// K-major A operand of the next product).
__device__ __forceinline__ void store_half(uint8_t* tile, const float (&x)[16], int col0, int t) {
#pragma unroll
  for (int i = 0; i < 16; i += 2) {
    uint32_t off = frag_row(i, t) * 128 + (col0 + frag_col(i, t)) * 2;
    off ^= ((off >> 7) & 7) << 4;
    *reinterpret_cast<uint32_t*>(tile + off) = pack_bf16(x[i], x[i + 1]);
  }
}

// Whether every key of [k0, k0 + 64) is visible to every query q_lo..q_hi.
__device__ __forceinline__ bool interior(const Geom& g, int k0, int q_lo, int q_hi) {
  const int k_last = k0 + TILE - 1;
  if (k_last >= g.klim) return false;
  switch (g.mask) {
    case CAUSAL: return k_last <= q_lo;
    case LOCAL: return k_last <= q_lo && k0 > q_hi - g.window;
    case PREFIX: return k_last <= q_lo || k_last < g.prefix;
    default: return true;
  }
}

// From a warpgroup's half (columns [col0, col0 + 32)) of a 64 x 64 tile of
// raw q.k products s and of dP (T: rows are keys and columns packed rows,
// else the transpose): s becomes P = e^(s - lse) and dp becomes
// dS = P (1 - tanh^2) (dP - delta) (no tanh factor without a softcap).
// lse2 and dl: the tile's 64 packed rows' lse (log2 domain) and delta.
// Invisible pairs, keys at or past kv_len and packed rows at or past nrows
// get 0.
template <bool T>
__device__ __forceinline__ void dscores(float (&s)[16], float (&dp)[16], const float* lse2,
                                        const float* dl, const Geom& g, int p0, int nrows, int k0,
                                        int col0, bool inner, int t) {
  const float sl2 = g.scale * LOG2E;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int m = frag_row(i, t), n = col0 + frag_col(i, t);
    const int r = T ? n : m, c = T ? m : n;
    float l2, dt = 1.f;
    if (g.softcap > 0.f) {
      const float th = tanhf(s[i] * g.scale / g.softcap);
      l2 = th * g.softcap * LOG2E;
      dt = 1.f - th * th;
    } else {
      l2 = s[i] * sl2;
    }
    bool ok = inner;
    if (!inner) {
      const int kp = k0 + c;
      ok = r < nrows && kp < g.klim &&
           visible(g.mask, g.qoff + (p0 + r) / g.G, kp, g.window, g.prefix);
    }
    const float p = ok ? ex2(l2 - lse2[r]) : 0.f;
    s[i] = p;
    dp[i] = p * dt * (dp[i] - dl[r]);
  }
}

__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 u = __bfloat1622float2(x[j]), w = __bfloat1622float2(y[j]);
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

// The keys [beg, end) that queries q_lo..q_hi can see, beg rounded down to
// a tile.
__device__ __forceinline__ int2 key_range(const Geom& g, int q_lo, int q_hi) {
  int end = g.klim;
  if (g.mask == CAUSAL || g.mask == LOCAL) end = min(end, q_hi + 1);
  if (g.mask == PREFIX) end = min(end, max(q_hi + 1, g.prefix));
  const int beg = g.mask == LOCAL ? max(0, q_lo - g.window + 1) / TILE * TILE : 0;
  return make_int2(beg, end);
}

// ---------------------------------------------------------------------------
// pass 1: lse (log2 domain) and delta, per (row, kv head, 64 packed rows).
// Two warpgroups take alternate visible 64-key tiles, each through its own
// two-stage TMA ring: S = Q K^T by wgmma, an online max and sum in
// registers as in the forward; warpgroup 1's (m, l) is merged into
// warpgroup 0's at the end, in that order.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(256, 1)
fa_bwd_tc_lse(const __grid_constant__ CUtensorMap tm_k, const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
              float* __restrict__ lse2, float* __restrict__ delta, Geom g) {
  using Gm = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_k = s_q + Gm::BYTES;  // warpgroup w's stage st: tile 2 w + st
  float* ml = reinterpret_cast<float*>(smem + 5 * Gm::BYTES);  // warpgroup 1's m, then l
  const uint32_t s_bar = smem_u32(ml + 2 * TILE);             // full[2 w + st]
  const int b = blockIdx.z, kh = blockIdx.y, R = g.Sq * g.G;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * TILE;  // heaviest first
  const int nrows = min(TILE, R - row0);
  const size_t base = (size_t)(b * g.K + kh) * R + row0;
  const int t = threadIdx.x, wg = t / 128, tw = t % 128, warp = t / 32, lane = t % 32;
  const int q_lo = g.qoff + row0 / g.G, q_hi = g.qoff + (row0 + nrows - 1) / g.G;
  const int2 kr = key_range(g, q_lo, q_hi);
  const int ntiles = kr.y > kr.x ? (kr.y - kr.x + TILE - 1) / TILE : 0;
  const int mine = ntiles > wg ? (ntiles - wg + 1) / 2 : 0;  // tiles wg, wg + 2, ...
  auto full = [&](int j) { return s_bar + 8 * (2 * wg + (j & 1)); };
  auto load_tile = [&](int j) {  // one thread of the warpgroup
    mbar_expect_tx(full(j), Gm::BYTES);
    tma_keys<D>(s_k + (2 * wg + (j & 1)) * Gm::BYTES, &tm_k, b, kh, kr.x + (2 * j + wg) * TILE,
                full(j));
  };

  if (t == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(s_bar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tw == 0 && mine > 0) load_tile(0);
  load_rows<D>(s_q, q, g, b, kh, row0, t, 256);
  cp_async_commit();

  for (int r = warp; r < nrows; r += 8) {  // delta = rowsum(do * o): a warp per row
    const int p = row0 + r;
    const size_t off = ((size_t)(b * g.Sq + p / g.G) * g.H + kh * g.G + p % g.G) * D;
    float acc = 0.f;
    for (int c = lane; c < D / 8; c += 32)
      acc = dot8(*reinterpret_cast<const uint4*>(dout + off + 8 * c),
                 *reinterpret_cast<const uint4*>(o + off + 8 * c), acc);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
    if (lane == 0) delta[base + r] = acc;
  }
  cp_async_drain();
  __syncthreads();  // Q landed

  const int ra = frag_row(0, tw);  // the thread's rows ra, ra + 8
  const float sl2 = g.scale * LOG2E;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < mine; ++j) {
    const int k0 = kr.x + (2 * j + wg) * TILE;
    if (j > 0)  // the warpgroup is done with tile j - 1, whose stage tile j + 1 takes
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (tw == 0 && j + 1 < mine) load_tile(j + 1);
    mbar_wait(full(j), (j >> 1) & 1);
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
    mma_scores<D, 64>(sc, s_q, s_k + (2 * wg + (j & 1)) * Gm::BYTES, 0);
    wgmma_commit();
    wgmma_wait0();
    fence_operands(sc);
    const bool inner = nrows == TILE && interior(g, k0, q_lo, q_hi);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = g.softcap > 0.f ? tanhf(sc[i] * g.scale / g.softcap) * g.softcap * LOG2E
                                : sc[i] * sl2;
      if (!inner) {
        const int r = frag_row(i, tw), kp = k0 + frag_col(i, tw);
        if (!(r < nrows && kp < g.klim &&
              visible(g.mask, g.qoff + (row0 + r) / g.G, kp, g.window, g.prefix)))
          x = NEG_INF;
      }
      sc[i] = x;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) mx1 = fmaxf(mx1, sc[i]);
      else mx0 = fmaxf(mx0, sc[i]);
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) s1 += ex2(sc[i] - mx1);
      else s0 += ex2(sc[i] - mx0);
    }
    l0 = l0 * ex2(m0 - mx0) + s0;  // this thread's share; the quad is summed at the end
    l1 = l1 * ex2(m1 - mx1) + s1;
    m0 = mx0;
    m1 = mx1;
  }
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const bool writer = tw % 4 == 0;
  if (wg == 1 && writer) {
    ml[ra] = m0;
    ml[ra + 8] = m1;
    ml[TILE + ra] = l0;
    ml[TILE + ra + 8] = l1;
  }
  __syncthreads();
  if (wg == 0 && writer) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ra + 8 * h;
      const float ma = h ? m1 : m0, la = h ? l1 : l0, mb = ml[r], lb = ml[TILE + r];
      const float mx = fmaxf(ma, mb);
      if (r < nrows) lse2[base + r] = mx + log2f(la * ex2(ma - mx) + lb * ex2(mb - mx));
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2: dk and dv per (row, kv head, 64-key block, query chunk of crows
// packed rows), in the transposed orientation.  Two warpgroups; K and V
// stay resident, the Q and dO tiles stream through a two-stage TMA ring
// (their rows' lse and delta beside them by cp.async).  Per row tile,
// warpgroup wg computes its 32 rows of S^T = K Q^T and dP^T = V dO^T, then
// P^T and dS^T there, and writes both as bf16 into shared exchange tiles;
// after one barrier both run dV += P^T dO and dK += dS^T Q on their share
// (Geo::SPLIT_N).
// Grid (key blocks, chunks, B * K), launched chunk by chunk; a block past
// its key block's last chunk returns at once.  Partials packed (slot, B *
// K, 64, D) fp32 (fa_bwd_dkv_combine's layout), dk times scale;
// fa_bwd_dkv_combine sums the chunks in order.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(256, 1)
fa_bwd_tc_dkv(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
              const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
              const float* __restrict__ lse2, const float* __restrict__ delta,
              float* __restrict__ part_k, float* __restrict__ part_v, int crows, Geom g) {
  using Gm = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t s_k = smem_u32(smem), s_v = s_k + Gm::BYTES;
  const uint32_t s_q = s_v + Gm::BYTES;        // two stages
  const uint32_t s_do = s_q + 2 * Gm::BYTES;   // two stages
  uint8_t* x_p = smem + 6 * Gm::BYTES;         // P^T, bf16
  uint8_t* x_ds = x_p + XBYTES;                // dS^T, bf16
  float* st_lse = reinterpret_cast<float*>(x_ds + XBYTES);  // two stages of 64
  float* st_dl = st_lse + 2 * TILE;                          // two stages of 64
  const uint32_t s_bar = smem_u32(st_dl + 2 * TILE);         // full[st]

  const int b = blockIdx.z / g.K, kh = blockIdx.z % g.K, R = g.Sq * g.G;
  const int k0 = blockIdx.x * TILE, nk = min(TILE, g.Sk - k0);
  const int chunk = blockIdx.y;
  const int2 rows = rows_seeing(g, k0, nk);
  const int c_lo = rows.x + chunk * crows, c_hi = min(rows.y, c_lo + crows);
  if (chunk > 0 && c_lo >= rows.y) return;  // past the last chunk (uniform over the block)
  const int ntiles = c_hi > c_lo ? (c_hi - c_lo + TILE - 1) / TILE : 0;
  const float* lse_b = lse2 + (size_t)(b * g.K + kh) * R;
  const float* dl_b = delta + (size_t)(b * g.K + kh) * R;
  const int t = threadIdx.x, wg = t / 128, tw = t % 128;

  auto load_tile = [&](int it) {  // Q and dO by thread 0's TMA, the stats by every thread
    const int st = it & 1, p0 = c_lo + it * TILE;
    if (t == 0) {
      mbar_expect_tx(s_bar + 8 * st, 2 * Gm::BYTES);
      tma_rows<D>(s_q + st * Gm::BYTES, &tm_q, b, kh, p0, g.G, s_bar + 8 * st);
      tma_rows<D>(s_do + st * Gm::BYTES, &tm_do, b, kh, p0, g.G, s_bar + 8 * st);
    }
    load_stats(smem_u32(st_lse + st * TILE), lse_b, p0, R, t, 256);
    load_stats(smem_u32(st_dl + st * TILE), dl_b, p0, R, t, 256);
  };
  if (t == 0) {
    mbar_init(s_bar, 1);
    mbar_init(s_bar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  load_keys<D>(s_k, k, g, b, kh, k0, t, 256);
  load_keys<D>(s_v, v, g, b, kh, k0, t, 256);
  if (ntiles > 0) load_tile(0);
  cp_async_commit();

  float dv[Gm::NW / 2], dk[Gm::NW / 2];
#pragma unroll
  for (int i = 0; i < Gm::NW / 2; ++i) dv[i] = dk[i] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1, p0 = c_lo + it * TILE, nrows = min(TILE, c_hi - p0);
    cp_async_drain();
    __syncthreads();  // tile it's stats landed; both warpgroups are done with tile it - 1
    if (it + 1 < ntiles) {
      load_tile(it + 1);
      cp_async_commit();
    }
    mbar_wait(s_bar + 8 * st, (it >> 1) & 1);  // tile it's Q and dO
    const uint32_t sq = s_q + st * Gm::BYTES, sdo = s_do + st * Gm::BYTES;
    float sc[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
    mma_scores<D, 32>(sc, s_k, sq, 32 * wg);   // S^T, this warpgroup's 32 rows
    mma_scores<D, 32>(dp, s_v, sdo, 32 * wg);  // dP^T
    wgmma_commit();
    wgmma_wait0();
    fence_operands(sc);
    fence_operands(dp);
    const bool inner =
        nrows == TILE && interior(g, k0, g.qoff + p0 / g.G, g.qoff + (p0 + TILE - 1) / g.G);
    dscores<true>(sc, dp, st_lse + st * TILE, st_dl + st * TILE, g, p0, nrows, k0, 32 * wg, inner,
                  tw);
    store_half(x_p, sc, 32 * wg, tw);
    store_half(x_ds, dp, 32 * wg, tw);
    fence_async();
    bar_wg2(1);  // P^T and dS^T are whole in shared memory
    wgmma_fence();
    mma_accum<D>(dv, smem_u32(x_p), sdo, wg);  // dV += P^T dO
    mma_accum<D>(dk, smem_u32(x_ds), sq, wg);  // dK += dS^T Q
    wgmma_commit();
    wgmma_wait0();
    fence_operands(dv);
    fence_operands(dk);
  }
  cp_async_drain();  // a block with no tile still has its K and V loads in flight

  if constexpr (!Gm::SPLIT_N) {  // warpgroup 1's half of the depth, added in a fixed order
    float* red = reinterpret_cast<float*>(smem + 2 * Gm::BYTES);  // the Q and dO stages
    __syncthreads();
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < Gm::NW / 2; ++i) {
        red[i * 128 + tw] = dv[i];
        red[(Gm::NW / 2 + i) * 128 + tw] = dk[i];
      }
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int i = 0; i < Gm::NW / 2; ++i) {
      dv[i] += red[i * 128 + tw];
      dk[i] += red[(Gm::NW / 2 + i) * 128 + tw];
    }
  }
  const int col0 = Gm::SPLIT_N ? wg * Gm::NW : 0;
  const int slot = chunks_before(g, blockIdx.x, TILE, crows) + chunk;
#pragma unroll
  for (int i = 0; i < Gm::NW / 2; i += 2) {
    const int m = frag_row(i, tw);
    if (m < nk) {
      const size_t off = (((size_t)slot * gridDim.z + blockIdx.z) * TILE + m) * D + col0 +
                         frag_col(i, tw);
      *reinterpret_cast<float2*>(part_k + off) = make_float2(dk[i] * g.scale, dk[i + 1] * g.scale);
      *reinterpret_cast<float2*>(part_v + off) = make_float2(dv[i], dv[i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// pass 3: dq per (row, kv head, 64 packed rows).  Two warpgroups; Q and dO
// stay resident, K and V tiles stream through a two-stage TMA ring over the
// visible keys (heaviest row blocks first).  Per key tile,
// warpgroup wg computes its 32 keys of S = Q K^T and dP = dO V^T, then dS
// there, as bf16 into a shared tile; after one barrier both run dQ += dS K
// on their share.  dq = scale dQ.  No atomics: every sum is in a fixed
// order.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(256, 1)
fa_bwd_tc_dq(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
             const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse2, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, Geom g) {
  using Gm = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  const uint32_t s_q = smem_u32(smem), s_do = s_q + Gm::BYTES;
  const uint32_t s_k = s_do + Gm::BYTES;      // two stages
  const uint32_t s_v = s_k + 2 * Gm::BYTES;   // two stages
  uint8_t* x_ds = smem + 6 * Gm::BYTES;       // dS, bf16
  float* st_lse = reinterpret_cast<float*>(x_ds + XBYTES);
  float* st_dl = st_lse + TILE;
  const uint32_t s_bar = smem_u32(st_dl + TILE);  // full[st]

  const int b = blockIdx.z, kh = blockIdx.y, R = g.Sq * g.G;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * TILE;  // heaviest first
  const int nrows = min(TILE, R - row0);
  const size_t base = (size_t)(b * g.K + kh) * R;
  const int t = threadIdx.x, wg = t / 128, tw = t % 128;
  const int q_lo = g.qoff + row0 / g.G, q_hi = g.qoff + (row0 + nrows - 1) / g.G;
  const int2 kr = key_range(g, q_lo, q_hi);
  const int ntiles = kr.y > kr.x ? (kr.y - kr.x + TILE - 1) / TILE : 0;

  auto load_tile = [&](int it) {  // thread 0
    const int st = it & 1, k0 = kr.x + it * TILE;
    mbar_expect_tx(s_bar + 8 * st, 2 * Gm::BYTES);
    tma_keys<D>(s_k + st * Gm::BYTES, &tm_k, b, kh, k0, s_bar + 8 * st);
    tma_keys<D>(s_v + st * Gm::BYTES, &tm_v, b, kh, k0, s_bar + 8 * st);
  };
  if (t == 0) {
    mbar_init(s_bar, 1);
    mbar_init(s_bar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0 && ntiles > 0) load_tile(0);
  load_rows<D>(s_q, q, g, b, kh, row0, t, 256);
  load_rows<D>(s_do, dout, g, b, kh, row0, t, 256);
  load_stats(smem_u32(st_lse), lse2 + base, row0, R, t, 256);
  load_stats(smem_u32(st_dl), delta + base, row0, R, t, 256);
  cp_async_commit();
  cp_async_drain();

  float acc[Gm::NW / 2];
#pragma unroll
  for (int i = 0; i < Gm::NW / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int st = it & 1, k0 = kr.x + it * TILE;
    __syncthreads();  // Q, dO and the stats landed; both warpgroups are done with tile it - 1
    if (t == 0 && it + 1 < ntiles) load_tile(it + 1);
    mbar_wait(s_bar + 8 * st, (it >> 1) & 1);  // tile it's K and V
    const uint32_t sk = s_k + st * Gm::BYTES;
    float sc[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = dp[i] = 0.f;
    wgmma_fence();
    mma_scores<D, 32>(sc, s_q, sk, 32 * wg);                    // S, this warpgroup's 32 keys
    mma_scores<D, 32>(dp, s_do, s_v + st * Gm::BYTES, 32 * wg);  // dP
    wgmma_commit();
    wgmma_wait0();
    fence_operands(sc);
    fence_operands(dp);
    const bool inner = nrows == TILE && interior(g, k0, q_lo, q_hi);
    dscores<false>(sc, dp, st_lse, st_dl, g, row0, nrows, k0, 32 * wg, inner, tw);
    store_half(x_ds, dp, 32 * wg, tw);
    fence_async();
    bar_wg2(1);  // dS is whole in shared memory
    wgmma_fence();
    mma_accum<D>(acc, smem_u32(x_ds), sk, wg);  // dQ += dS K
    wgmma_commit();
    wgmma_wait0();
    fence_operands(acc);
  }

  if constexpr (!Gm::SPLIT_N) {  // warpgroup 1's half of the depth, added in a fixed order
    float* red = reinterpret_cast<float*>(smem + 2 * Gm::BYTES);  // the K and V stages
    __syncthreads();
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < Gm::NW / 2; ++i) red[i * 128 + tw] = acc[i];
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int i = 0; i < Gm::NW / 2; ++i) acc[i] += red[i * 128 + tw];
  }
  const int col0 = Gm::SPLIT_N ? wg * Gm::NW : 0;
#pragma unroll
  for (int i = 0; i < Gm::NW / 2; i += 2) {
    const int m = frag_row(i, tw);
    if (m < nrows) {
      const int p = row0 + m;
      __nv_bfloat16* out = dq + ((size_t)(b * g.Sq + p / g.G) * g.H + kh * g.G + p % g.G) * D;
      *reinterpret_cast<uint32_t*>(out + col0 + frag_col(i, tw)) =
          pack_bf16(acc[i] * g.scale, acc[i + 1] * g.scale);
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time (no libcuda link)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (res == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor of `rank` dims (innermost first; strides in bytes of dims
// 1..) whose box is one swizzled column block of 64 rows; out-of-range
// coordinates read as zero.
template <int D>
bool make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box) {
  using Gm = Geo<D>;
  EncodeTiled enc = encode_fn();
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  return enc && enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                    strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                    Gm::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// k or v (B, Sk, K, D) as {D, K, Sk, B}: a box is 64 keys of one kv head.
template <int D>
bool make_keys_map(CUtensorMap* map, const void* base, int B, int Sk, int K) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)K, (cuuint64_t)Sk, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)K * D * 2,
                                 (cuuint64_t)Sk * K * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Geo<D>::SWE, 1, TILE, 1};
  return make_map<D>(map, base, 4, dims, strides, box);
}

// q or do (B, Sq, H, D) as {D, G, K, Sq, B}: a box is 64 / G queries of the
// G heads of one kv head, 64 packed rows in order (G divides 64).
template <int D>
bool make_rows_map(CUtensorMap* map, const void* base, int B, int Sq, int H, int K) {
  const int G = H / K;
  const cuuint64_t dims[5] = {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)K, (cuuint64_t)Sq,
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)D * 2, (cuuint64_t)G * D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)Sq * H * D * 2};
  const cuuint32_t box[5] = {(cuuint32_t)Geo<D>::SWE, (cuuint32_t)G, 1, (cuuint32_t)(TILE / G),
                             1};
  return make_map<D>(map, base, 5, dims, strides, box);
}

}  // namespace tc

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* o, const void* dout,
              void* dq, void* dk, void* dv, float* scratch, int B, int qchunk, int items,
              const Geom& g, cudaStream_t st) {
  using bf = __nv_bfloat16;
  static bool smem_set = false;
  cudaError_t e;
  if (!smem_set) {
    if ((e = cudaFuncSetAttribute(tc::fa_bwd_tc_lse<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)tc::smem_bytes<D>(1))) != cudaSuccess ||
        (e = cudaFuncSetAttribute(tc::fa_bwd_tc_dkv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)tc::smem_bytes<D>(2))) != cudaSuccess ||
        (e = cudaFuncSetAttribute(tc::fa_bwd_tc_dq<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)tc::smem_bytes<D>(3))) != cudaSuccess)
      return (int)e;
    smem_set = true;
  }
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  if (!tc::make_rows_map<D>(&tm_q, q, B, g.Sq, g.H, g.K) ||
      !tc::make_rows_map<D>(&tm_do, dout, B, g.Sq, g.H, g.K) ||
      !tc::make_keys_map<D>(&tm_k, k, B, g.Sk, g.K) || !tc::make_keys_map<D>(&tm_v, v, B, g.Sk, g.K))
    return (int)cudaErrorInvalidValue;
  const bf* qt = static_cast<const bf*>(q);
  const bf* kt = static_cast<const bf*>(k);
  const bf* vt = static_cast<const bf*>(v);
  const bf* dot = static_cast<const bf*>(dout);
  const Scratch sc(B, g.Sq, g.Sk, g.H, g.K, g.D, BWD_TC, items);
  float* lse2 = scratch;
  float* delta = lse2 + sc.lse;
  float* part_k = delta + sc.lse;
  float* part_v = part_k + sc.part;
  const int crows = qchunk * tc::TILE;
  const int row_blocks = (g.Sq * g.G + tc::TILE - 1) / tc::TILE;
  // chunks a key block has at most (under a causal mask the first's count)
  const int chunks = row_blocks > qchunk ? (row_blocks + qchunk - 1) / qchunk : 1;
  tc::fa_bwd_tc_lse<D><<<dim3(row_blocks, g.K, B), 256, tc::smem_bytes<D>(1), st>>>(
      tm_k, qt, static_cast<const bf*>(o), dot, lse2, delta, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  tc::fa_bwd_tc_dkv<D><<<dim3((g.Sk + tc::TILE - 1) / tc::TILE, chunks, B * g.K), 256,
                         tc::smem_bytes<D>(2), st>>>(
      tm_q, tm_do, kt, vt, lse2, delta, part_k, part_v, crows, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  fa_bwd_dkv_combine<bf, tc::TILE, true><<<dim3((g.Sk + COMBINE_KEYS - 1) / COMBINE_KEYS, B * g.K),
                                            256, 0, st>>>(
      part_k, part_v, static_cast<bf*>(dk), static_cast<bf*>(dv), B, crows, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  tc::fa_bwd_tc_dq<D><<<dim3(row_blocks, g.K, B), 256, tc::smem_bytes<D>(3), st>>>(
      tm_k, tm_v, qt, dot, lse2, delta, static_cast<bf*>(dq), g);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block of pass 1, 2 or 3 of `variant` (0 tc,
// 1 simt) at head_dim D; 0 where the variant has no instance.
extern "C" size_t fa_bwd_smem_bytes(int variant, int pass, int D) {
  if (variant == BWD_SIMT) return smem_bytes(pass, D);
  if (variant != BWD_TC) return 0;
  switch (D) {
    case 32: return tc::smem_bytes<32>(pass);
    case 64: return tc::smem_bytes<64>(pass);
    case 128: return tc::smem_bytes<128>(pass);
    case 256: return tc::smem_bytes<256>(pass);
    default: return 0;
  }
}

// fp32 scratch fa_backward needs, in floats, for `variant`; items: the tc
// variant's query chunks of a (row, kv head) over its key blocks (simt's
// chunks are fixed).
extern "C" size_t fa_bwd_scratch_floats(int B, int Sq, int Sk, int H, int K, int D, int variant,
                                        int items) {
  return Scratch(B, Sq, Sk, H, K, D, variant, items).total;
}

// scratch: fa_bwd_scratch_floats(...) fp32, 16-byte aligned.  variant: 0
// tc (bf16, D in {32, 64, 128, 256}, H / K dividing 64; qchunk >= 1 row
// tiles per query chunk of its dk/dv pass; items its chunks of a (row, kv
// head) over its key blocks, per 64-key block max(1, ceil(rows seeing it /
// (64 qchunk)))), 1 simt; the caller's plan names them, and a variant that
// cannot take the call returns cudaErrorInvalidValue.  device: the
// tensors' card, made current first (a thread that has run nothing on it,
// as autograd's backward thread may be, has no current context, and the
// tensor maps need one).
extern "C" int fa_backward(const void* q, const void* k, const void* v, const void* o,
                           const void* dout, void* dq, void* dk, void* dv, float* scratch, int B,
                           int Sq, int Sk, int H, int K, int D, int mask, int window, int prefix,
                           int q_offset, int kv_len, float scale, float softcap, int is_bf16,
                           int variant, int qchunk, int items, int device, void* stream) {
  if (D < 4 || D > MAX_D || D % 4 != 0 || K < 1 || H % K != 0 || mask < FULL || mask > PREFIX ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || Sk == 0) return 0;
  const Geom g{Sq, Sk, H, K, D, H / K, mask, window, prefix, q_offset, kv_len < Sk ? kv_len : Sk,
               scale, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (variant == BWD_TC) {
    if (!is_bf16 || qchunk < 1 || items < 1 || tc::TILE % g.G != 0)
      return (int)cudaErrorInvalidValue;
    switch (D) {
      case 32:
        return launch_tc<32>(q, k, v, o, dout, dq, dk, dv, scratch, B, qchunk, items, g, st);
      case 64:
        return launch_tc<64>(q, k, v, o, dout, dq, dk, dv, scratch, B, qchunk, items, g, st);
      case 128:
        return launch_tc<128>(q, k, v, o, dout, dq, dk, dv, scratch, B, qchunk, items, g, st);
      case 256:
        return launch_tc<256>(q, k, v, o, dout, dq, dk, dv, scratch, B, qchunk, items, g, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (variant != BWD_SIMT) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, scratch, B, g, st);
  return launch<float>(q, k, v, o, dout, dq, dk, dv, scratch, B, g, st);
}
