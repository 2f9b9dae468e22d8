// Flash attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `flash_attention_bh` (body `_fa_kernel`)
// in src/repro/kernels/flash_attention/kernel.py: softmax(scale * Q K^T,
// optional tanh softcap) V with an online softmax over kv tiles.  The
// running max, denominator and output accumulator are fp32; the kv tail is
// masked and kv tiles that no row of the block can see are skipped.
//
// Beyond the TPU kernel it does what the model path needs:
//   * GQA without a materialised repeat: the block of kv head `kh` reads
//     K/V once for all G = H / K query heads of its group;
//   * per-row (B,) int32 `q_offset` and `kv_len` (per-slot serve decode,
//     right-padded batched prefill);
//   * the `prefix` mask besides `full`, `causal` and `local`;
//   * head_dim up to 256 (a multiple of 4), bf16 or fp32 inputs.
//
// Layout: q/o (B, Sq, H, D), k/v (B, Sk, K, D), all contiguous.
//
// What bounds it on an H100.  Decode (Sq = 1 over a long cache) is bound by
// the bytes of the KV cache: every key and value is read once per kv head,
// and the work per byte is tiny.  Prefill is bound by bf16 tensor-core
// FLOPs.  This first design is a simple one that is right:
//   * rows of a block are packed (query position, head in group) pairs, so
//     a decode block holds the G heads of one kv head and reads the cache
//     once for all of them instead of G times;
//   * tiles are staged in shared memory as fp32 and the products run on
//     the CUDA cores (FMA), not the tensor cores.  Prefill therefore runs
//     well below the bf16 bound; wgmma, TMA and warp specialisation are
//     later work, as is splitting a long decode cache over several blocks.
//
// The launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 64;        // packed rows (query position x group head) per block
constexpr int BK = 32;          // keys per kv tile (= warp size: one lane per key)
constexpr int THREADS = 256;
constexpr int MAX_D = 256;
constexpr int MAX_ROW_ITERS = ROWS / (THREADS / (MAX_D / 4));  // 16
constexpr float NEG_INF = -1e30f;  // additive-mask convention of the reference

enum Mask { FULL = 0, CAUSAL = 1, LOCAL = 2, PREFIX = 3 };

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

size_t smem_bytes(int D) {
  const int ld = D + 4;
  return sizeof(float) * (size_t)(ROWS * ld + BK * ld + BK * D + ROWS * (BK + 1) + 3 * ROWS);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, const int* __restrict__ q_offset, const int* __restrict__ kv_len,
          int Sq, int Sk, int H, int K, int D, int mask, int window, int prefix,
          float scale, float softcap) {
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
  const int qoff = q_offset[b];
  const int klim = min(kv_len[b], Sk);
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
  const int q_lo = qoff + row0 / G;
  const int q_hi = qoff + (row0 + nrows - 1) / G;
  int k_end = klim;
  if (mask == CAUSAL || mask == LOCAL) k_end = min(k_end, q_hi + 1);
  if (mask == PREFIX) k_end = min(k_end, max(q_hi + 1, prefix));
  int k_beg = 0;
  if (mask == LOCAL) k_beg = max(0, q_lo - window + 1);
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

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, const int* q_offset,
           const int* kv_len, int B, int Sq, int Sk, int H, int K, int D, int mask, int window,
           int prefix, float scale, float softcap, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(fa_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem_bytes(MAX_D));
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const dim3 grid((Sq * (H / K) + ROWS - 1) / ROWS, K, B);
  fa_kernel<T><<<grid, THREADS, smem_bytes(D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), q_offset, kv_len, Sq, Sk, H, K, D, mask, window, prefix, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one block of the kernel takes at head_dim D.
extern "C" size_t fa_smem_bytes(int D) { return smem_bytes(D); }

extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o,
                          const int* q_offset, const int* kv_len, int B, int Sq, int Sk, int H,
                          int K, int D, int mask, int window, int prefix, float scale,
                          float softcap, int is_bf16, void* stream) {
  if (D < 4 || D > MAX_D || D % 4 != 0 || K < 1 || H % K != 0 || mask < FULL || mask > PREFIX)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, o, q_offset, kv_len, B, Sq, Sk, H, K, D, mask, window,
                                 prefix, scale, softcap, st);
  return launch<float>(q, k, v, o, q_offset, kv_len, B, Sq, Sk, H, K, D, mask, window, prefix,
                       scale, softcap, st);
}
