// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `flash_attention_bh` (body `_fa_kernel`)
// in src/repro/kernels/flash_attention/kernel.py: softmax(scale * Q K^T,
// optional tanh softcap) V with an online softmax over kv tiles.  The
// running max, denominator and output accumulator are fp32; the kv tail is
// masked and kv tiles that no row of the block can see are skipped.
//
// Beyond the TPU kernel it does what the model path needs:
//   * GQA without a materialised repeat: a block of kv head `kh` reads
//     K/V once for all G = H / K query heads of its group.  Its rows are
//     packed (query position, head in group) pairs, p = qi * G + (h % G);
//   * per-row (B,) int32 `q_offset` and `kv_len` (per-slot serve decode,
//     right-padded batched prefill), or one scalar for every row (a null
//     row pointer);
//   * the `prefix` mask besides `full`, `causal` and `local`;
//   * head_dim up to 256 (a multiple of 4), bf16 or fp32 inputs.
//
// Layout: q/o (B, Sq, H, D), k/v (B, Sk, K, D), all contiguous.
//
// Three variants behind one entry point, `fa_forward`.  The caller (the
// Python wrapper's `plan()`) names the variant; nothing here picks one.
//
//   tc    bf16 prefill (packed rows Sq*G > 64, D in {32, 64, 128, 256}).
//         Bound by tensor-core FLOPs.  FlashAttention-3's shape: a block of
//         64 or 128 packed rows, one or two warpgroups of 64 rows; one
//         thread streams 64-key K and V tiles through a 2-stage ring with
//         TMA (128-byte swizzle, four 64-column boxes a row at D = 256) and
//         mbarriers; S = Q K^T by wgmma m64n64k16 from shared
//         memory, the online softmax in registers (exp2 with log2(e) folded
//         into the scale), P rounded to bf16 in registers as wgmma's A
//         operand for O += P V (m64nDk16, V read MN-major).  The
//         element-wise mask runs only on tiles that cross a mask edge or
//         kv_len; row blocks run heaviest (latest queries) first.
//   split bf16 or fp32 decode (Sq*G <= 64).  Bound by the bytes of the KV
//         cache.  The grid is (n_split, K, B): each block takes every packed
//         row of its (row, kv head) over one contiguous share of the keys
//         those rows can see, streams K and V with 16-byte cp.async into a
//         double buffer, and writes fp32 partials (acc, m, l); a second
//         kernel, fa_decode_combine, merges them.  In bf16 with at most 16
//         packed rows and D in {64, 128, 256} (every decode step of the
//         served models) the products run on the tensor cores (mma.sync
//         m16n8k16 from ldmatrix); otherwise (fp32, held to 2e-5, or more
//         rows) in fp32 on the CUDA cores, whose instructions and not the
//         bytes then set the time.
//   simt  the first design (fp32 tiles, CUDA-core FMAs): fp32 prefill and
//         head dims the tc variant does not instantiate.  fp32 stays off
//         the tensor cores: TF32 would miss the 2e-5 fp32 tolerance.
//
// Every launch uses the caller's stream and allocates nothing (the split
// scratch comes from the wrapper); fa_forward returns cudaGetLastError()
// (0 on success).  The variants share this one file, so the build's source
// hash covers all of them.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;  // additive-mask convention of the reference

enum Mask { FULL = 0, CAUSAL = 1, LOCAL = 2, PREFIX = 3 };
enum Variant { TC = 0, SPLIT = 1, SIMT = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ bool visible(int mask, int qp, int kp, int window, int prefix) {
  switch (mask) {
    case CAUSAL: return kp <= qp;
    case LOCAL: return kp <= qp && kp > qp - window;
    case PREFIX: return kp <= qp || kp < prefix;
    default: return true;
  }
}

// The kv range [beg, end) that queries q_lo..q_hi of one row can see.
__device__ __forceinline__ void kv_range(int mask, int q_lo, int q_hi, int klim, int window,
                                         int prefix, int& beg, int& end) {
  end = klim;
  if (mask == CAUSAL || mask == LOCAL) end = min(end, q_hi + 1);
  if (mask == PREFIX) end = min(end, max(q_hi + 1, prefix));
  beg = mask == LOCAL ? max(0, q_lo - window + 1) : 0;
}

struct Rows {  // per-row int32 (B,) pointers, or one scalar each
  const int* q_offset;
  const int* kv_len;
  int q_offset_s, kv_len_s;
  __device__ __forceinline__ int qoff(int b) const { return q_offset ? q_offset[b] : q_offset_s; }
  __device__ __forceinline__ int klen(int b) const { return kv_len ? kv_len[b] : kv_len_s; }
};

// ===========================================================================
// simt: the first design, unchanged but for the row arguments
// ===========================================================================

constexpr int ROWS = 64;        // packed rows (query position x group head) per block
constexpr int BK = 32;          // keys per kv tile (= warp size: one lane per key)
constexpr int THREADS = 256;
constexpr int MAX_D = 256;
constexpr int MAX_ROW_ITERS = ROWS / (THREADS / (MAX_D / 4));  // 16

size_t smem_bytes(int D) {
  const int ld = D + 4;
  return sizeof(float) * (size_t)(ROWS * ld + BK * ld + BK * D + ROWS * (BK + 1) + 3 * ROWS);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, Rows rows, int Sq, int Sk, int H, int K, int D, int mask,
          int window, int prefix, float scale, float softcap) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = D + 4;               // padded row stride: float4-aligned, no bank conflicts
  float* Qs = smem;                   // ROWS x ld, pre-scaled queries
  float* Ks = Qs + ROWS * ld;         // BK x ld
  float* Vs = Ks + BK * ld;           // BK x D
  float* Ss = Vs + BK * D;            // ROWS x (BK + 1): scores, then probabilities
  float* m_s = Ss + ROWS * (BK + 1);  // running max per row
  float* l_s = m_s + ROWS;            // running denominator per row
  float* a_s = l_s + ROWS;            // rescale factor of the current tile

  const int G = H / K;
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, Sq * G - row0);
  const int tid = threadIdx.x;
  const int qoff = rows.qoff(b);
  const int klim = min(rows.klen(b), Sk);
  const int D4 = D / 4;

  for (int i = tid; i < nrows * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int p = row0 + r;
    const int qi = p / G, h = kh * G + p % G;
    Qs[r * ld + d] = to_f(q[((size_t)(b * Sq + qi) * H + h) * D + d]) * scale;
  }
  for (int r = tid; r < ROWS; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  // kv range any row of this block can see (block-level prune)
  int k_beg, k_end;
  kv_range(mask, qoff + row0 / G, qoff + (row0 + nrows - 1) / G, klim, window, prefix, k_beg,
           k_end);
  k_beg = (k_beg / BK) * BK;

  // output accumulator in registers: thread owns float4 column `cg` of rows
  // r0, r0 + rstride, ...
  const int rstride = THREADS / D4;
  const int cg = tid % D4;
  const int r0 = tid / D4;
  const bool pv_thread = r0 < rstride;
  float4 acc[MAX_ROW_ITERS];
#pragma unroll
  for (int i = 0; i < MAX_ROW_ITERS; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int warp = tid / 32, lane = tid % 32;
  for (int k0 = k_beg; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile's K/V/P are consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int c = i / D, d = i - c * D;
      const int kp = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (kp < Sk) {  // the tail beyond Sk is zero, never garbage
        const size_t off = ((size_t)(b * Sk + kp) * K + kh) * D + d;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      Ks[c * ld + d] = kv;
      Vs[c * D + d] = vv;
    }
    __syncthreads();

    for (int i = tid; i < nrows * BK; i += THREADS) {
      const int r = i / BK, c = i - r * BK;
      const float4* qr = reinterpret_cast<const float4*>(Qs + r * ld);
      const float4* kr = reinterpret_cast<const float4*>(Ks + c * ld);
      float s = 0.f;
      for (int j = 0; j < D4; ++j) {
        const float4 a = qr[j], bb = kr[j];
        s = fmaf(a.x, bb.x, s);
        s = fmaf(a.y, bb.y, s);
        s = fmaf(a.z, bb.z, s);
        s = fmaf(a.w, bb.w, s);
      }
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      const int kp = k0 + c;
      const int qp = qoff + (row0 + r) / G;
      const bool ok = kp < klim && visible(mask, qp, kp, window, prefix);
      Ss[r * (BK + 1) + c] = ok ? s : NEG_INF;
    }
    __syncthreads();

    // online softmax: one warp per row, one lane per key of the tile
    for (int r = warp; r < nrows; r += THREADS / 32) {
      const float s = Ss[r * (BK + 1) + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float pr = expf(s - m_new);
      float sum = pr;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ss[r * (BK + 1) + lane] = pr;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    if (pv_thread) {
#pragma unroll
      for (int i = 0; i < MAX_ROW_ITERS; ++i) {
        const int r = r0 + i * rstride;
        if (r < nrows) {
          const float a = a_s[r];
          acc[i].x *= a; acc[i].y *= a; acc[i].z *= a; acc[i].w *= a;
        }
      }
      const float4* V4 = reinterpret_cast<const float4*>(Vs);
      for (int c = 0; c < BK; ++c) {
        const float4 vv = V4[c * D4 + cg];
#pragma unroll
        for (int i = 0; i < MAX_ROW_ITERS; ++i) {
          const int r = r0 + i * rstride;
          if (r < nrows) {
            const float pr = Ss[r * (BK + 1) + c];
            acc[i].x = fmaf(pr, vv.x, acc[i].x);
            acc[i].y = fmaf(pr, vv.y, acc[i].y);
            acc[i].z = fmaf(pr, vv.z, acc[i].z);
            acc[i].w = fmaf(pr, vv.w, acc[i].w);
          }
        }
      }
    }
  }
  __syncthreads();

  if (pv_thread) {
#pragma unroll
    for (int i = 0; i < MAX_ROW_ITERS; ++i) {
      const int r = r0 + i * rstride;
      if (r < nrows) {
        const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
        const int p = row0 + r;
        const int qi = p / G, h = kh * G + p % G;
        T* out = o + ((size_t)(b * Sq + qi) * H + h) * D + cg * 4;
        store(out + 0, acc[i].x * inv);
        store(out + 1, acc[i].y * inv);
        store(out + 2, acc[i].z * inv);
        store(out + 3, acc[i].w * inv);
      }
    }
  }
}

// ===========================================================================
// split: split-KV decode (flash-decoding) and its combine kernel
// ===========================================================================

namespace split {

constexpr int THREADS = 256;
constexpr int BKS = 32;         // keys per tile (= warp size: one lane per key in the softmax)
constexpr int MAX_ROWS = 64;    // packed rows Sq*G of one block
constexpr int MAX_ITERS = 16;   // accumulator rows per thread: 64 rows / (256 / (256 / 4))

// K rows in shared memory are padded by 16 bytes: the score loop reads one
// key row per lane, and the pad puts neighbouring rows in other banks.
__host__ __device__ constexpr int k_ld(int D, int elem) { return D + 16 / elem; }

// Shared memory of one block: fp32 pre-scaled Q (rows x D), a double buffer
// of K (padded rows) and V tiles in the input type, the tile's scores, and
// m, l, alpha.
size_t smem_bytes(int D, int rows, int elem) {
  return sizeof(float) * (size_t)rows * D + (size_t)2 * BKS * (k_ld(D, elem) + D) * elem +
         sizeof(float) * ((size_t)rows * (BKS + 1) + 3 * rows);
}

// The key share [lo, hi) of split s: whole tiles, as ref.split_ranges.
__device__ __forceinline__ void share(int beg, int end, int n_split, int s, int& lo, int& hi) {
  const int n = max(end - beg, 0);
  int chunk = (n + n_split - 1) / n_split;
  chunk = (chunk + BKS - 1) / BKS * BKS;
  lo = beg + s * chunk;
  hi = min(end, lo + chunk);
}

template <int CH>  // bytes per cp.async: 16, or 8 where a row is not a multiple of 16 bytes
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? CH : 0;  // 0 source bytes: the hardware writes zeros
  if constexpr (CH == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(c), __high2float(c));
}

// Partials: part[((s * B + b) * K + kh) * R + r] holds D accumulator
// values (unnormalised), then m, then l; R = Sq * G.
template <typename T, int CH>
__global__ void __launch_bounds__(THREADS, 1)
fa_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                float* __restrict__ part, Rows rows, int B, int Sq, int Sk, int H, int K, int D,
                int mask, int window, int prefix, float scale, float softcap, int n_split) {
  extern __shared__ float4 smem4[];
  const int G = H / K, R = Sq * G;
  const int s_idx = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int kld = k_ld(D, sizeof(T));
  float* Qs = reinterpret_cast<float*>(smem4);               // R x D
  T* Kt = reinterpret_cast<T*>(Qs + R * D);                  // 2 x BKS x kld
  T* Vt = Kt + 2 * BKS * kld;                                // 2 x BKS x D
  float* Ss = reinterpret_cast<float*>(Vt + 2 * BKS * D);    // R x (BKS + 1)
  float* m_s = Ss + R * (BKS + 1);
  float* l_s = m_s + R;
  float* a_s = l_s + R;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qoff = rows.qoff(b);
  const int klim = min(rows.klen(b), Sk);
  int beg, end, lo, hi;
  kv_range(mask, qoff, qoff + Sq - 1, klim, window, prefix, beg, end);
  share(beg, end, n_split, s_idx, lo, hi);
  const int ntiles = hi > lo ? (hi - lo + BKS - 1) / BKS : 0;

  constexpr int PER = CH / sizeof(T);  // elements per cp.async
  const int chunks = D / PER;          // per key row
  auto load_tile = [&](int t, int st) {
    const int k0 = lo + t * BKS;
    T* kd = Kt + st * BKS * kld;
    T* vd = Vt + st * BKS * D;
    for (int i = tid; i < BKS * chunks; i += THREADS) {
      const int c = i / chunks, e = (i - c * chunks) * PER;
      const int kp = k0 + c;
      const bool ok = kp < hi;
      const size_t off = ok ? ((size_t)(b * Sk + kp) * K + kh) * D + e : 0;
      cp_async<CH>(kd + c * kld + e, k + off, ok);
      cp_async<CH>(vd + c * D + e, v + off, ok);
    }
  };
  if (ntiles > 0) load_tile(0, 0);
  cp_async_commit();

  for (int i = tid; i < R * D / 4; i += THREADS) {  // Q, 4 elements a thread-step
    const int r = i / (D / 4), d = (i - r * (D / 4)) * 4;
    const int qi = r / G, h = kh * G + r % G;
    const float4 x = load4(q + ((size_t)(b * Sq + qi) * H + h) * D + d);
    *reinterpret_cast<float4*>(Qs + r * D + d) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }
  for (int r = tid; r < R; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }

  const int D4 = D / 4;
  const int rstride = THREADS / D4;
  const int cg = tid % D4, r0 = tid / D4;
  const bool pv_thread = r0 < rstride;
  float4 acc[MAX_ITERS];
#pragma unroll
  for (int i = 0; i < MAX_ITERS; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_tile(t + 1, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();
    const T* kt = Kt + (t & 1) * BKS * kld;
    const T* vt = Vt + (t & 1) * BKS * D;
    const int k0 = lo + t * BKS;

    // scores: one thread per (row, key), a lane per key: the warp reads
    // one Q row (a broadcast) and 32 padded K rows
    for (int i = tid; i < R * BKS; i += THREADS) {
      const int r = i / BKS, c = i % BKS;
      const int kp = k0 + c;
      const float* qr = Qs + r * D;
      const T* kr = kt + c * kld;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;  // four chains: the FMAs overlap
      auto dot4 = [&](int e, float& acc_e) {
        const float4 a = *reinterpret_cast<const float4*>(qr + e);
        const float4 kk = load4(kr + e);
        acc_e = fmaf(a.x, kk.x, fmaf(a.y, kk.y, fmaf(a.z, kk.z, fmaf(a.w, kk.w, acc_e))));
      };
      int e = 0;
#pragma unroll 4
      for (; e + 16 <= D; e += 16) {
        dot4(e, s0);
        dot4(e + 4, s1);
        dot4(e + 8, s2);
        dot4(e + 12, s3);
      }
      for (; e < D; e += 4) dot4(e, s0);
      float sv = (s0 + s1) + (s2 + s3);
      if (softcap > 0.f) sv = tanhf(sv / softcap) * softcap;
      const int qp = qoff + r / G;
      float val;
      if (kp >= hi) val = __int_as_float(0xff800000);  // -inf: outside this split
      else val = kp < klim && visible(mask, qp, kp, window, prefix) ? sv : NEG_INF;
      Ss[r * (BKS + 1) + c] = val;
    }
    __syncthreads();

    // online softmax: one warp per row, one lane per key
    for (int r = warp; r < R; r += THREADS / 32) {
      const float s = Ss[r * (BKS + 1) + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float pr = expf(s - m_new);
      float sum = pr;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ss[r * (BKS + 1) + lane] = pr;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    if (pv_thread) {
#pragma unroll
      for (int i = 0; i < MAX_ITERS; ++i) {
        const int r = r0 + i * rstride;
        if (r >= R) break;
        const float a = a_s[r];
        acc[i].x *= a; acc[i].y *= a; acc[i].z *= a; acc[i].w *= a;
      }
#pragma unroll 8
      for (int c = 0; c < BKS; ++c) {
        const float4 vv = load4(vt + c * D + cg * 4);
#pragma unroll
        for (int i = 0; i < MAX_ITERS; ++i) {
          const int r = r0 + i * rstride;
          if (r >= R) break;
          const float pr = Ss[r * (BKS + 1) + c];
          acc[i].x = fmaf(pr, vv.x, acc[i].x);
          acc[i].y = fmaf(pr, vv.y, acc[i].y);
          acc[i].z = fmaf(pr, vv.z, acc[i].z);
          acc[i].w = fmaf(pr, vv.w, acc[i].w);
        }
      }
    }
    __syncthreads();  // the buffer is free for the load two tiles on
  }
  cp_async_wait<0>();
  __syncthreads();

  // an empty share leaves acc = 0, m = -1e30, l = 0: it contributes nothing
  float* base = part + ((size_t)(s_idx * B + b) * K + kh) * R * (D + 2);
  if (pv_thread) {
#pragma unroll
    for (int i = 0; i < MAX_ITERS; ++i) {
      const int r = r0 + i * rstride;
      if (r >= R) break;
      float* dst = base + (size_t)r * (D + 2) + cg * 4;  // rows of D + 2: two float2 stores
      *reinterpret_cast<float2*>(dst) = make_float2(acc[i].x, acc[i].y);
      *reinterpret_cast<float2*>(dst + 2) = make_float2(acc[i].z, acc[i].w);
    }
  }
  for (int r = tid; r < R; r += THREADS) {
    base[(size_t)r * (D + 2) + D] = m_s[r];
    base[(size_t)r * (D + 2) + D + 1] = l_s[r];
  }
}

constexpr int MAX_SPLITS = 1024;

// O = sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M) l_i, one block per
// (packed row, kv head, batch row): the weights e^(m_i - M) go to shared
// memory first, then each thread sums one float2 of D over the splits.
template <typename T>
__global__ void __launch_bounds__(128)
fa_decode_combine(const float* __restrict__ part, T* __restrict__ o, int B, int Sq, int H, int K,
                  int D, int n_split) {
  __shared__ float w_s[MAX_SPLITS];
  __shared__ float red[2][4];
  const int G = H / K, R = Sq * G;
  const int r = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t split_stride = (size_t)B * K * R * (D + 2);
  const float* row = part + (((size_t)b * K + kh) * R + r) * (D + 2);
  float M = NEG_INF;
  for (int s = tid; s < n_split; s += 128) M = fmaxf(M, row[s * split_stride + D]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  if (lane == 0) red[0][warp] = M;
  __syncthreads();
  M = fmaxf(fmaxf(red[0][0], red[0][1]), fmaxf(red[0][2], red[0][3]));
  float den = 0.f;
  for (int s = tid; s < n_split; s += 128) {
    const float* p = row + s * split_stride;
    const float w = expf(p[D] - M);
    w_s[s] = w;
    den = fmaf(w, p[D + 1], den);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) den += __shfl_xor_sync(0xffffffffu, den, off);
  if (lane == 0) red[1][warp] = den;
  __syncthreads();
  den = (red[1][0] + red[1][1]) + (red[1][2] + red[1][3]);
  const float inv = 1.f / fmaxf(den, 1e-30f);
  const int qi = r / G, h = kh * G + r % G;
  T* out = o + ((size_t)(b * Sq + qi) * H + h) * D;
  for (int d = tid * 2; d < D; d += 256) {
    float n0 = 0.f, n1 = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) {
      const float2 a = *reinterpret_cast<const float2*>(row + s * split_stride + d);
      n0 = fmaf(w_s[s], a.x, n0);
      n1 = fmaf(w_s[s], a.y, n1);
    }
    store(out + d, n0 * inv);
    store(out + d + 1, n1 * inv);
  }
}

}  // namespace split

// ===========================================================================
// tc: bf16 prefill on the tensor cores (wgmma, TMA, warp specialisation)
// ===========================================================================

namespace tc {

constexpr int BK = 64;       // keys per K/V tile
constexpr int STAGES = 2;    // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Geo {
  static constexpr int SWE = D < 64 ? D : 64;         // elements of a swizzled row (a TMA box)
  static constexpr int SW = SWE * 2;                   // its bytes: 128, or 64 at D = 32
  static constexpr int NCB = D / SWE;                  // column blocks of a row
  static constexpr int LAYOUT = SW == 128 ? 1 : 2;     // wgmma descriptor swizzle: 128 B / 64 B
  static constexpr int SWZ = SW == 128 ? 7 : 3;        // address bits 7.. XORed into bits 4..
  static constexpr int TILE = BK * D * 2;              // bytes of one K (or V) tile
};

template <int D, int NWG>
constexpr size_t smem_bytes() {  // Q, the K/V ring, six mbarriers, 1 KB of alignment slack
  return (size_t)NWG * 64 * D * 2 + (size_t)2 * STAGES * Geo<D>::TILE + 64 + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
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
template <typename A>
__device__ __forceinline__ void fence_operand(A& x) { asm volatile("" : "+f"(x)::"memory"); }

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout.  Tiles are 1024-byte aligned, so
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

// ---- generated: one wrapper per wgmma shape the tc variant runs ----
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_m64n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// ---- end of generated wrappers ----

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 32) wgmma_rs_m64n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_m64n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_m64n128(d, a, db);
  else wgmma_rs_m64n256(d, a, db);
}

// Whether every key of tile [k0, k0 + BK) is visible to every query
// q_lo..q_hi (then the element-wise mask is skipped).
__device__ __forceinline__ bool interior(int mask, int k0, int q_lo, int q_hi, int klim, int window,
                                         int prefix) {
  const int k_last = k0 + BK - 1;
  if (k_last >= klim) return false;
  switch (mask) {
    case CAUSAL: return k_last <= q_lo;
    case LOCAL: return k_last <= q_lo && k0 > q_hi - window;
    case PREFIX: return k_last <= q_lo || k_last < prefix;
    default: return true;
  }
}

// Block: NWG warpgroups of 64 packed rows each, and no thread besides
// them: ptxas budgets registers for whole warpgroups, so any producer warp
// (or warpgroup, with setmaxnreg) brings the budget down to 168 a thread
// and the 128-float accumulator at D = 256 spills.  At NWG * 128 threads
// each may hold 255.  Thread 0 starts the TMA loads: the first STAGES
// tiles before the loop, then tile it + STAGES once every warp has
// released stage it % STAGES.  Grid: (row blocks, K, B), row blocks
// walked last to first.
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128, 1)
fa_tc_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
             const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o, Rows rows,
             int Sq, int Sk, int H, int K, int mask, int window, int prefix, float scale,
             float softcap) {
  using Gm = Geo<D>;
  constexpr int ROWS_B = NWG * 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_k = s_q + ROWS_B * D * 2;            // STAGES K tiles
  const uint32_t s_v = s_k + STAGES * Gm::TILE;          // STAGES V tiles
  const uint32_t s_bar = s_v + STAGES * Gm::TILE;        // full_k[2], full_v[2], empty[2]
  auto full_k = [&](int s) { return s_bar + 8 * s; };
  auto full_v = [&](int s) { return s_bar + 16 + 8 * s; };
  auto empty = [&](int s) { return s_bar + 32 + 8 * s; };

  const int G = H / K;
  const int R = Sq * G;
  const int b = blockIdx.z, kh = blockIdx.y;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * ROWS_B;  // heaviest first
  const int nrows = min(ROWS_B, R - row0);
  const int qoff = rows.qoff(b);
  const int klim = min(rows.klen(b), Sk);
  int k_beg, k_end;
  kv_range(mask, qoff + row0 / G, qoff + (row0 + nrows - 1) / G, klim, window, prefix, k_beg,
           k_end);
  k_beg = k_beg / BK * BK;
  const int ntiles = k_end > k_beg ? (k_end - k_beg + BK - 1) / BK : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), NWG * 4);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_tile = [&](int it) {  // thread 0: TMA loads of tile it into its stage
    const int s = it % STAGES;
    const int k0 = k_beg + it * BK;
    mbar_expect_tx(full_k(s), Gm::TILE);
    for (int cb = 0; cb < Gm::NCB; ++cb)
      tma_load(s_k + s * Gm::TILE + cb * BK * Gm::SW, &tm_k, cb * Gm::SWE, kh, k0, b, full_k(s));
    mbar_expect_tx(full_v(s), Gm::TILE);
    for (int cb = 0; cb < Gm::NCB; ++cb)
      tma_load(s_v + s * Gm::TILE + cb * BK * Gm::SW, &tm_v, cb * Gm::SWE, kh, k0, b, full_v(s));
  };
  if (tid == 0)
    for (int it = 0; it < min(STAGES, ntiles); ++it) load_tile(it);

  const int wg = tid / 128;
  {
    // ---- warpgroup wg: packed rows row0 + 64 wg .. + 63 ----
    const int t128 = tid % 128;
    // Q: 16-byte loads into the 128 B (64 B) swizzled layout wgmma reads
    for (int i = t128; i < 64 * D / 8; i += 128) {
      const int r = i / (D / 8), c = i % (D / 8);
      const int pr = wg * 64 + r;  // row in the block
      const int p = row0 + pr;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (p < R) {
        const int qi = p / G, h = kh * G + p % G;
        val = *reinterpret_cast<const uint4*>(q + ((size_t)(b * Sq + qi) * H + h) * D + c * 8);
      }
      const int cb = c / (Gm::SWE / 8), cc = c % (Gm::SWE / 8);
      uint32_t off = cb * ROWS_B * Gm::SW + pr * Gm::SW + cc * 16;
      off ^= ((off >> 7) & Gm::SWZ) << 4;
      *reinterpret_cast<uint4*>(smem + off) = val;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

    const int warp4 = t128 / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int ra = wg * 64 + warp4 * 16 + g;  // this thread's two rows: ra, ra + 8
    const int qp0 = qoff + (row0 + ra) / G;
    const int qp1 = qoff + (row0 + ra + 8) / G;
    const int wq_lo = qoff + (row0 + wg * 64) / G;
    const int wq_hi = qoff + (row0 + wg * 64 + 63) / G;
    const float sl2 = scale * LOG2E;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // log2 domain

    const uint32_t q_base = s_q + wg * 64 * Gm::SW;
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % STAGES, ph = (it / STAGES) & 1;
      const int k0 = k_beg + it * BK;
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      mbar_wait(full_k(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int cb = kk * 16 / Gm::SWE;
        const int off = (kk * 16 % Gm::SWE) * 2;
        const uint64_t da = desc(q_base + cb * ROWS_B * Gm::SW + off, 16, 8 * Gm::SW, Gm::LAYOUT);
        const uint64_t db =
            desc(s_k + s * Gm::TILE + cb * BK * Gm::SW + off, 16, 8 * Gm::SW, Gm::LAYOUT);
        wgmma_ss_m64n64(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(sc[i]);

      // scale (log2 domain), softcap, mask where the tile crosses an edge
      const bool inner = interior(mask, k0, wq_lo, wq_hi, klim, window, prefix);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = sc[i];
        x = softcap > 0.f ? tanhf(x * scale / softcap) * softcap * LOG2E : x * sl2;
        if (!inner) {
          const int kp = k0 + (i / 4) * 8 + 2 * t4 + (i & 1);
          const int qp = (i & 2) ? qp1 : qp0;
          if (!(kp < klim && visible(mask, qp, kp, window, prefix))) x = NEG_INF;
        }
        sc[i] = x;
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i & 2) mx1 = fmaxf(mx1, sc[i]);
        else mx0 = fmaxf(mx0, sc[i]);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float al0 = ex2(m0 - mx0), al1 = ex2(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float p = ex2(sc[i] - ((i & 2) ? m1 : m0));
        sc[i] = p;
        if (i & 2) s1 += p;
        else s0 += p;
      }
      l0 = l0 * al0 + s0;  // this thread's share; the quad is summed at the end
      l1 = l1 * al1 + s1;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? al1 : al0;

      uint32_t pa[BK / 16][4];  // P as bf16 A fragments, straight from the S layout
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      mbar_wait(full_v(s), ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // V tile, MN-major: 16 keys of SW bytes a step; LBO = next column block
        const uint64_t db = desc(s_v + s * Gm::TILE + kk * 16 * Gm::SW, BK * Gm::SW, 8 * Gm::SW,
                                 Gm::LAYOUT);
        wgmma_pv<D>(acc, pa[kk], db);
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) fence_operand(acc[i]);
      if (lane == 0) mbar_arrive(empty(s));
      if (tid == 0 && it + STAGES < ntiles) {
        mbar_wait(empty(s), ph);  // every warp is done with this stage
        load_tile(it + STAGES);
      }
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = row0 + ra + 8 * half;
      if (p < R) {
        const int qi = p / G, h = kh * G + p % G;
        __nv_bfloat16* out = o + ((size_t)(b * Sq + qi) * H + h) * D + 2 * t4;
        const float inv = half ? inv1 : inv0;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(out + 8 * j) =
              pack_bf16(acc[4 * j + 2 * half] * inv, acc[4 * j + 2 * half + 1] * inv);
      }
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

// K or V (B, Sk, K, D) bf16 as a 4-d map {D, K, Sk, B}; a box is one swizzled
// column block of BK keys of one kv head.  Keys past Sk read as zero.
template <int D>
bool make_map(CUtensorMap* map, const void* base, int B, int Sk, int K) {
  using Gm = Geo<D>;
  EncodeTiled enc = encode_fn();
  if (!enc) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)K, (cuuint64_t)Sk, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)K * D * 2,
                                 (cuuint64_t)Sk * K * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Gm::SWE, 1, (cuuint32_t)BK, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             Gm::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int NWG>
int launch(const void* q, const void* k, const void* v, void* o, Rows rows, int B, int Sq, int Sk,
           int H, int K, int mask, int window, int prefix, float scale, float softcap,
           cudaStream_t stream) {
  static bool smem_set = false;
  constexpr size_t smem = smem_bytes<D, NWG>();
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fa_tc_kernel<D, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  CUtensorMap tm_k, tm_v;
  if (!make_map<D>(&tm_k, k, B, Sk, K) || !make_map<D>(&tm_v, v, B, Sk, K))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq * (H / K) + NWG * 64 - 1) / (NWG * 64), K, B);
  fa_tc_kernel<D, NWG><<<grid, NWG * 128, smem, stream>>>(
      tm_k, tm_v, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o), rows, Sq,
      Sk, H, K, mask, window, prefix, scale, softcap);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int nwg, const void* q, const void* k, const void* v, void* o, Rows rows, int B,
             int Sq, int Sk, int H, int K, int mask, int window, int prefix, float scale,
             float softcap, cudaStream_t st) {
  return nwg == 2 ? launch<D, 2>(q, k, v, o, rows, B, Sq, Sk, H, K, mask, window, prefix, scale,
                                 softcap, st)
                  : launch<D, 1>(q, k, v, o, rows, B, Sq, Sk, H, K, mask, window, prefix, scale,
                                 softcap, st);
}

}  // namespace tc

// bf16 decode with up to 16 packed rows (every decode step of the served
// models: G = 8 or 16) runs the same split algorithm with its products on
// the tensor cores: mma.sync m16n8k16 (bf16 in, fp32 accumulate), operands
// from padded shared memory by ldmatrix.  The CUDA-core loops above take
// as long on a 32-key tile at 16 rows as at 1: instructions, not bytes,
// set their time.  Here a 64-key tile at D = 256 is 256 mma instructions.
namespace mma16 {

constexpr int THREADS = 128;  // 4 warps
constexpr int BK = 64;        // keys per tile: 16 a warp in Q K^T
constexpr int ROWS = 16;      // one m16 row tile; rows >= Sq*G are zero

template <int D>
struct Smem {
  static constexpr int LD = D + 8;        // bf16 rows: 16-byte aligned, ldmatrix conflict-free
  static constexpr int SLD = BK + 4;      // fp32 scores
  static constexpr int PLD = BK + 8;      // bf16 probabilities
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + (size_t)ROWS * LD * 2;
  static constexpr size_t V = K + (size_t)2 * BK * LD * 2;
  static constexpr size_t S = V + (size_t)2 * BK * LD * 2;
  static constexpr size_t P = S + (size_t)ROWS * SLD * 4;
  static constexpr size_t STAT = P + (size_t)ROWS * PLD * 2;  // m, l, alpha
  static constexpr size_t BYTES = STAT + 3 * ROWS * 4;
};

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
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
fa_split_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, float* __restrict__ part, Rows rows,
                    int B, int Sq, int Sk, int H, int K, int mask, int window, int prefix,
                    float scale, float softcap, int n_split) {
  using L = Smem<D>;
  extern __shared__ float4 smem4[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem4);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(sm + L::Q);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(sm + L::K);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(sm + L::V);
  float* Ss = reinterpret_cast<float*>(sm + L::S);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(sm + L::P);
  float* m_s = reinterpret_cast<float*>(sm + L::STAT);
  float* l_s = m_s + ROWS;
  float* a_s = l_s + ROWS;

  const int G = H / K, R = Sq * G;
  const int s_idx = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int qoff = rows.qoff(b);
  const int klim = min(rows.klen(b), Sk);
  int beg, end, lo, hi;
  kv_range(mask, qoff, qoff + Sq - 1, klim, window, prefix, beg, end);
  split::share(beg, end, n_split, s_idx, lo, hi);
  const int ntiles = hi > lo ? (hi - lo + BK - 1) / BK : 0;

  constexpr int CHUNKS = D / 8;  // 16-byte chunks of a row
  auto load_tile = [&](int t, int st) {
    const int k0 = lo + t * BK;
    __nv_bfloat16* kd = Ks + st * BK * L::LD;
    __nv_bfloat16* vd = Vs + st * BK * L::LD;
    for (int i = tid; i < BK * CHUNKS; i += THREADS) {
      const int c = i / CHUNKS, e = (i % CHUNKS) * 8;
      const int kp = k0 + c;
      const bool ok = kp < hi;
      const size_t off = ok ? ((size_t)(b * Sk + kp) * K + kh) * D + e : 0;
      split::cp_async<16>(kd + c * L::LD + e, k + off, ok);
      split::cp_async<16>(vd + c * L::LD + e, v + off, ok);
    }
  };
  if (ntiles > 0) load_tile(0, 0);
  split::cp_async_commit();

  for (int i = tid; i < ROWS * CHUNKS; i += THREADS) {  // Q rows, zero past R
    const int r = i / CHUNKS, e = (i % CHUNKS) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < R) {
      const int qi = r / G, h = kh * G + r % G;
      x = *reinterpret_cast<const uint4*>(q + ((size_t)(b * Sq + qi) * H + h) * D + e);
    }
    *reinterpret_cast<uint4*>(Qs + r * L::LD + e) = x;
  }
  if (tid < ROWS) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  constexpr int NT = D / 32;  // 8-column output tiles of a warp (D / 4 columns)
  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  const uint32_t q_base = tc::smem_u32(Qs), p_base = tc::smem_u32(Ps);
  // ldmatrix row addresses of this lane: A (16 x 16) and B (16 keys x 16)
  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  const int bq_key = (lane % 8) + (lane / 16) * 8, bq_col = ((lane / 8) % 2) * 8;
  const int bv_key = (lane % 8) + ((lane / 8) % 2) * 8, bv_col = (lane / 16) * 8;
  const int r0 = g, r1 = g + 8;
  const int qp0 = qoff + r0 / G, qp1 = qoff + r1 / G;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_tile(t + 1, (t + 1) & 1);
    split::cp_async_commit();
    split::cp_async_wait<1>();
    __syncthreads();
    const uint32_t k_base = tc::smem_u32(Ks + (t & 1) * BK * L::LD);
    const uint32_t v_base = tc::smem_u32(Vs + (t & 1) * BK * L::LD);
    const int k0 = lo + t * BK;

    // S = Q K^T for keys 16 warp .. + 15
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], bb[4];
      ldsm_x4(q_base + (a_row * L::LD + kk * 16 + a_col) * 2, a);
      ldsm_x4(k_base + ((warp * 16 + bq_key) * L::LD + kk * 16 + bq_col) * 2, bb);
      mma(sc[0], a, bb[0], bb[1]);
      mma(sc[1], a, bb[2], bb[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = warp * 16 + j * 8 + 2 * t4 + (e & 1);
        const int kp = k0 + c;
        float x = sc[j][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        if (kp >= hi) x = __int_as_float(0xff800000);  // -inf: outside this split
        else if (!(kp < klim && visible(mask, (e & 2) ? qp1 : qp0, kp, window, prefix)))
          x = NEG_INF;
        Ss[((e & 2) ? r1 : r0) * L::SLD + c] = x;
      }
    __syncthreads();

    // online softmax: a warp per 4 rows, two keys a lane; P to bf16
    for (int r = warp; r < ROWS; r += THREADS / 32) {
      const float s0 = Ss[r * L::SLD + lane], s1 = Ss[r * L::SLD + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ps[r * L::PLD + lane] = __float2bfloat16_rn(p0);
      Ps[r * L::PLD + lane + 32] = __float2bfloat16_rn(p1);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // O += P V for columns warp * D / 4 .. + D / 4
    const float al0 = a_s[r0], al1 = a_s[r1];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      o[j][0] *= al0; o[j][1] *= al0; o[j][2] *= al1; o[j][3] *= al1;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(p_base + (a_row * L::PLD + kk * 16 + a_col) * 2, a);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bb[4];
        ldsm_x4_t(v_base + ((kk * 16 + bv_key) * L::LD + warp * (D / 4) + j * 8 + bv_col) * 2, bb);
        mma(o[j], a, bb[0], bb[1]);
        mma(o[j + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // the buffers are free for the load two tiles on
  }
  split::cp_async_wait<0>();
  __syncthreads();

  float* base = part + ((size_t)(s_idx * B + b) * K + kh) * R * (D + 2);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = warp * (D / 4) + j * 8 + 2 * t4;
    if (r0 < R)
      *reinterpret_cast<float2*>(base + (size_t)r0 * (D + 2) + col) = make_float2(o[j][0], o[j][1]);
    if (r1 < R)
      *reinterpret_cast<float2*>(base + (size_t)r1 * (D + 2) + col) = make_float2(o[j][2], o[j][3]);
  }
  if (tid < R) {
    base[(size_t)tid * (D + 2) + D] = m_s[tid];
    base[(size_t)tid * (D + 2) + D + 1] = l_s[tid];
  }
}

}  // namespace mma16

template <typename T>
int launch_simt(const void* q, const void* k, const void* v, void* o, Rows rows, int B, int Sq,
                int Sk, int H, int K, int D, int mask, int window, int prefix, float scale,
                float softcap, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(MAX_D));
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid((Sq * (H / K) + ROWS - 1) / ROWS, K, B);
  fa_kernel<T><<<grid, THREADS, smem_bytes(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), rows, Sq, Sk, H, K, D, mask, window, prefix, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T, int CH>
int launch_split(const void* q, const void* k, const void* v, void* o, float* part, Rows rows,
                 int B, int Sq, int Sk, int H, int K, int D, int mask, int window, int prefix,
                 float scale, float softcap, int n_split, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        split::fa_split_kernel<T, CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)split::smem_bytes(MAX_D, split::MAX_ROWS, sizeof(T)));
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int R = Sq * (H / K);
  split::fa_split_kernel<T, CH><<<dim3(n_split, K, B), split::THREADS,
                                  split::smem_bytes(D, R, sizeof(T)), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), part, rows, B,
      Sq, Sk, H, K, D, mask, window, prefix, scale, softcap, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split::fa_decode_combine<T><<<dim3(R, K, B), 128, 0, stream>>>(part, static_cast<T*>(o), B, Sq,
                                                                  H, K, D, n_split);
  return (int)cudaGetLastError();
}

template <int D>
int launch_split_mma(const void* q, const void* k, const void* v, void* o, float* part, Rows rows,
                     int B, int Sq, int Sk, int H, int K, int mask, int window, int prefix,
                     float scale, float softcap, int n_split, cudaStream_t stream) {
  static bool smem_set = false;
  constexpr size_t smem = mma16::Smem<D>::BYTES;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(mma16::fa_split_mma_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  using bf = __nv_bfloat16;
  mma16::fa_split_mma_kernel<D><<<dim3(n_split, K, B), mma16::THREADS, smem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), part, rows,
      B, Sq, Sk, H, K, mask, window, prefix, scale, softcap, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split::fa_decode_combine<bf><<<dim3(Sq * (H / K), K, B), 128, 0, stream>>>(
      part, static_cast<bf*>(o), B, Sq, H, K, D, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_split_t(const void* q, const void* k, const void* v, void* o, float* part, Rows rows,
                   int B, int Sq, int Sk, int H, int K, int D, int mask, int window, int prefix,
                   float scale, float softcap, int n_split, cudaStream_t st) {
  // bf16 with at most 16 packed rows (decode of the served models): the
  // tensor-core form; fp32 (held to 2e-5) and wider row counts: CUDA cores
  if (sizeof(T) == 2 && Sq * (H / K) <= mma16::ROWS && (D == 64 || D == 128 || D == 256)) {
#define FA_SPLIT_MMA(DD)                                                                   \
  launch_split_mma<DD>(q, k, v, o, part, rows, B, Sq, Sk, H, K, mask, window, prefix, scale, \
                       softcap, n_split, st)
    return D == 64 ? FA_SPLIT_MMA(64) : D == 128 ? FA_SPLIT_MMA(128) : FA_SPLIT_MMA(256);
#undef FA_SPLIT_MMA
  }
  if ((D * sizeof(T)) % 16 == 0)
    return launch_split<T, 16>(q, k, v, o, part, rows, B, Sq, Sk, H, K, D, mask, window, prefix,
                               scale, softcap, n_split, st);
  return launch_split<T, 8>(q, k, v, o, part, rows, B, Sq, Sk, H, K, D, mask, window, prefix,
                            scale, softcap, n_split, st);
}

}  // namespace

// Dynamic shared memory one block of `variant` takes at head_dim D (rows:
// packed rows of a split block; nwg: warpgroups of a tc block).
extern "C" size_t fa_smem_bytes(int variant, int D, int rows, int is_bf16, int nwg) {
  if (variant == SPLIT) {
    if (is_bf16 && rows <= mma16::ROWS) {  // the tensor-core form, as launch_split_t picks it
      if (D == 64) return mma16::Smem<64>::BYTES;
      if (D == 128) return mma16::Smem<128>::BYTES;
      if (D == 256) return mma16::Smem<256>::BYTES;
    }
    return split::smem_bytes(D, rows, is_bf16 ? 2 : 4);
  }
  if (variant == TC) {
    switch (D * 4 + nwg) {
      case 32 * 4 + 1: return tc::smem_bytes<32, 1>();
      case 32 * 4 + 2: return tc::smem_bytes<32, 2>();
      case 64 * 4 + 1: return tc::smem_bytes<64, 1>();
      case 64 * 4 + 2: return tc::smem_bytes<64, 2>();
      case 128 * 4 + 1: return tc::smem_bytes<128, 1>();
      case 128 * 4 + 2: return tc::smem_bytes<128, 2>();
      case 256 * 4 + 1: return tc::smem_bytes<256, 1>();
      case 256 * 4 + 2: return tc::smem_bytes<256, 2>();
      default: return 0;
    }
  }
  return smem_bytes(D);
}

// q_offset_rows / kv_len_rows: int32 (B,) device pointers, or null for the
// scalars q_offset / kv_len.  variant: 0 tc, 1 split, 2 simt.  n_split and
// the fp32 scratch (n_split, B, K, Sq*G, D + 2) are the split variant's;
// nwg (1 or 2) the tc variant's warpgroups (64 rows each).
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o,
                          const int* q_offset_rows, const int* kv_len_rows, int q_offset,
                          int kv_len, int B, int Sq, int Sk, int H, int K, int D, int mask,
                          int window, int prefix, float scale, float softcap, int is_bf16,
                          int variant, int n_split, int nwg, void* scratch, void* stream) {
  if (D < 4 || D > MAX_D || D % 4 != 0 || K < 1 || H % K != 0 || mask < FULL || mask > PREFIX)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  const Rows rows{q_offset_rows, kv_len_rows, q_offset, kv_len};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case TC: {
      if (!is_bf16 || (nwg != 1 && nwg != 2)) return (int)cudaErrorInvalidValue;
#define FA_TC(DD)                                                                            \
  case DD:                                                                                   \
    return tc::launch_d<DD>(nwg, q, k, v, o, rows, B, Sq, Sk, H, K, mask, window, prefix, \
                            scale, softcap, st);
      switch (D) {
        FA_TC(32)
        FA_TC(64)
        FA_TC(128)
        FA_TC(256)
        default: return (int)cudaErrorInvalidValue;
      }
#undef FA_TC
    }
    case SPLIT: {
      if (Sq * (H / K) > split::MAX_ROWS || n_split < 1 || n_split > split::MAX_SPLITS ||
          scratch == nullptr)
        return (int)cudaErrorInvalidValue;
      float* part = static_cast<float*>(scratch);
      if (is_bf16)
        return launch_split_t<__nv_bfloat16>(q, k, v, o, part, rows, B, Sq, Sk, H, K, D, mask,
                                             window, prefix, scale, softcap, n_split, st);
      return launch_split_t<float>(q, k, v, o, part, rows, B, Sq, Sk, H, K, D, mask, window,
                                   prefix, scale, softcap, n_split, st);
    }
    case SIMT:
      if (is_bf16)
        return launch_simt<__nv_bfloat16>(q, k, v, o, rows, B, Sq, Sk, H, K, D, mask, window,
                                          prefix, scale, softcap, st);
      return launch_simt<float>(q, k, v, o, rows, B, Sq, Sk, H, K, D, mask, window, prefix, scale,
                                softcap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
