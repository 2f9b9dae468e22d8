// RG-LRU linear-recurrence scan for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `rglru_scan_kernel` (body `_rglru_kernel`)
// in src/repro/kernels/rglru/kernel.py, with the b = sqrt(1 - a^2) x of its
// wrapper (src/repro/kernels/rglru/ops.py).  Per batch row b and feature
// lane d:
//   h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) x_t,   h_{-1} = init or 0.
//
// The TPU kernel solves each 16-step time block as an (L x L) log-space
// decay-weighted sum per lane and carries the state over a sequential time
// grid, because the TPU has no cheap per-lane sequential loop.  A CUDA
// thread has one, so both variants here walk the steps with the same fmaf
// update: no log/exp and no L^2 work.  The TPU's sequential grid has no
// counterpart: blocks run in parallel, so the `chunked` variant parallelises
// over time as well as over lanes.
//
// What bounds it on an H100: the bytes.  a and x read and h written once in
// fp32, 12 bytes an element: 100.7 MB at recurrentgemma-9b prefill (B=1,
// S=2048, D=4096), 0.030 ms at 3.35 TB/s; its ~7 operations an element take
// a third of that at the fp32 peak.
//
// Variant `seq` (rglru_seq_kernel, the first design): one thread owns one
// (row, lane) and walks all S steps, the loads of U steps issued ahead of
// their updates.  At B=1, D=4096 that is 4,096 threads (32 blocks on 132
// SMs) each walking 2,048 dependent steps: latency-bound at ~110 ns a step,
// 0.226 ms, 13% of the bound.  It stays where the walk is short or its
// lanes alone keep the memory busy (kernels/rglru/kernel.py:plan).
//
// Variant `chunked` (rglru_chunked_kernel): a scan over time in chunks of
// CHUNK steps.  h_t = a_t h_{t-1} + b_t composes as pairs (A, H), chunk j
// then chunk k giving (A_j A_k, A_k H_j + H_k).  One block takes one (row,
// 128-lane tile, chunk); each thread, for its lane:
//   1. loads the chunk's a and x into registers (CHUNK of each), forms b
//      there, and scans from a zero state: the chunk's aggregate A = prod
//      a_t (a direct product: it may underflow to 0, which is right) and H
//      (the local end state);
//   2. publishes A and H, then looks back over earlier chunks of its lane
//      (decoupled look-back): it loads LOOKBACK predecessors' words at once
//      and folds their aggregates up to the nearest one that has published
//      its INCLUSIVE end state, or up to the start, where init_state is
//      the base: that gives the carry-in;
//   3. publishes its inclusive end state A * carry + H, then rescans the
//      chunk from the carry-in out of registers with the same fmaf step as
//      `seq`, writing h.
// So a and x are read once and h written once: 12 bytes an element, plus
// per (row, chunk, lane) 16 bytes of scratch that stay in the L2.  Each
// published scalar is one 64-bit word, its fp32 value with its state
// (st/ld.relaxed.gpu, single-copy atomic), so a reader that sees the state
// sees the value in the same load: one L2 round trip per LOOKBACK
// predecessors, where a flag followed by its values would take two, each
// of them time in which the thread holds its registers and moves no
// bytes.  Blocks take their (row, tile, chunk) from an
// atomic ticket in chunk-major order, not from blockIdx: a thread waits
// only on chunks with earlier tickets, which are running or done, so the
// look-back cannot deadlock, and the chunks of every lane advance together.
// The ticket and the words live in a scratch the wrapper allocates; the C
// entry zeroes it on the stream before the launch (one memset, no host
// synchronisation; a CUDA graph replays it).  CHUNK = 32 holds 64 floats
// a thread in registers (128 registers, no spills, four blocks an SM); 16
// would double the look-backs per byte, 64 halve the blocks an SM.
//
// Both variants do what the model path needs:
//   * b is formed in registers from a and x (the TPU wrapper does that in
//     XLA before the kernel).  1 - a*a is rounded as the plain version
//     rounds it (__fmul_rn: no fused multiply-add), since near a = 1 the
//     difference is a large share of 1 - a^2;
//   * an optional fp32 initial state (B, D) (null means zeros), which
//     serving needs to continue from a cache;
//   * any S and D: lanes past D idle, the last chunk may be ragged (its
//     missing steps are identity steps in registers), no padding;
//   * x and a read through row strides (B, S, D) with unit stride over D;
//     neighbouring threads take neighbouring lanes, so each step's loads
//     and stores are coalesced across a warp;
//   * B up to 65535.
// The final state is h[:, S-1]; steps past a row's valid length arrive as
// identity steps (a = 1, x = 0), so the kernels need no lengths.
// h (B, S, D) fp32 contiguous.
//
// The launch uses the caller's stream, allocates nothing, and returns
// cudaGetLastError() (0 on success).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;   // lanes per block
constexpr int U = 8;           // seq: steps whose loads are issued together
constexpr unsigned AGGREGATE = 1u, INCLUSIVE = 2u;   // chunked: states of a word
constexpr int CHUNK = 32;      // chunked: steps a chunk
constexpr int LOOKBACK = 8;    // chunked: predecessors whose words are loaded at once

__device__ __forceinline__ float gate(float at, float xt) {
  return __fmul_rn(sqrtf(fmaxf(1.0f - __fmul_rn(at, at), 1e-12f)), xt);
}

__device__ __forceinline__ float step(float state, float at, float xt) {
  return fmaf(at, state, gate(at, xt));
}

__global__ void __launch_bounds__(THREADS)
rglru_seq_kernel(const float* __restrict__ x, const float* __restrict__ a,
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

// A published scalar: its fp32 bits low, its state (0: not yet) high, in one
// 64-bit word, so a reader that sees the state sees the value with it.
__device__ __forceinline__ unsigned long long load_word(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ void store_word(unsigned long long* p, float v, unsigned state) {
  const unsigned long long w = ((unsigned long long)state << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" :: "l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned state_of(unsigned long long w) { return (unsigned)(w >> 32); }
__device__ __forceinline__ float value_of(unsigned long long w) {
  return __uint_as_float((unsigned)w);
}

// words[0] is the ticket counter; words[1 ..] hold word_a and then word_h,
// each (B, n_chunks, D): per (row, chunk, lane) the aggregate's A (state
// AGGREGATE) and either the aggregate's H (AGGREGATE) or the inclusive end
// state (INCLUSIVE).
__global__ void __launch_bounds__(THREADS)
rglru_chunked_kernel(const float* __restrict__ x, const float* __restrict__ a,
                     const float* __restrict__ init, float* __restrict__ h,
                     unsigned long long* words, int B, int S, int D, int n_chunks,
                     long long sxb, long long sxs, long long sab, long long sas) {
  __shared__ unsigned s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(reinterpret_cast<unsigned*>(words), 1u);
  __syncthreads();
  const int tiles = (D + THREADS - 1) / THREADS;
  const int per_chunk = B * tiles;
  const int c = (int)s_ticket / per_chunk;
  const int r = (int)s_ticket - c * per_chunk;
  const int b = r / tiles;
  const int d = (r - b * tiles) * THREADS + threadIdx.x;
  if (d >= D) return;             // every lane works alone from here on
  const int t0 = c * CHUNK;
  const int n = min(CHUNK, S - t0);

  float av[CHUNK], bv[CHUNK];
  {
    const float* ap = a + b * sab + t0 * sas + d;
    const float* xp = x + b * sxb + t0 * sxs + d;
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      av[u] = u < n ? __ldg(ap + u * sas) : 1.0f;   // identity steps past the end
      bv[u] = u < n ? __ldg(xp + u * sxs) : 0.0f;
    }
  }
  float A = 1.0f, H = 0.0f;
#pragma unroll
  for (int u = 0; u < CHUNK; ++u) {
    bv[u] = gate(av[u], bv[u]);
    H = fmaf(av[u], H, bv[u]);
    A *= av[u];
  }

  const size_t plane = (size_t)B * n_chunks * D;
  unsigned long long* word_a = words + 1 + (size_t)b * n_chunks * D + d;   // chunk 0
  unsigned long long* word_h = word_a + plane;
  const float h0 = init ? init[(size_t)b * D + d] : 0.0f;
  float carry = h0;
  if (c > 0) {
    store_word(word_a + (size_t)c * D, A, AGGREGATE);
    store_word(word_h + (size_t)c * D, H, AGGREGATE);
    // fold (Acc, Hacc) = the composite of chunks j+1 .. c-1, walking back K
    // predecessors a round, their words loaded together
    float Acc = 1.0f, Hacc = 0.0f;
    bool done = false;
    for (int j = c - 1; !done; j -= LOOKBACK) {
      unsigned long long wa[LOOKBACK], wh[LOOKBACK];
#pragma unroll
      for (int k = 0; k < LOOKBACK; ++k) {
        wa[k] = j - k >= 0 ? load_word(word_a + (size_t)(j - k) * D) : 0ull;
        wh[k] = j - k >= 0 ? load_word(word_h + (size_t)(j - k) * D) : 0ull;
      }
#pragma unroll
      for (int k = 0; k < LOOKBACK; ++k) {
        if (done) break;
        const int jk = j - k;
        if (jk < 0) {                     // past the start: the initial state
          carry = fmaf(Acc, h0, Hacc);
          done = true;
          break;
        }
        while (state_of(wh[k]) == 0u) wh[k] = load_word(word_h + (size_t)jk * D);
        if (state_of(wh[k]) == INCLUSIVE) {
          carry = fmaf(Acc, value_of(wh[k]), Hacc);
          done = true;
          break;
        }
        while (state_of(wa[k]) == 0u) wa[k] = load_word(word_a + (size_t)jk * D);
        Hacc = fmaf(Acc, value_of(wh[k]), Hacc);
        Acc *= value_of(wa[k]);
      }
    }
  }
  if (c + 1 < n_chunks)           // the chunk's end state for its successors
    store_word(word_h + (size_t)c * D, fmaf(A, carry, H), INCLUSIVE);

  float* hp = h + ((size_t)b * S + t0) * D + d;
  float st = carry;
#pragma unroll
  for (int u = 0; u < CHUNK; ++u) {
    st = fmaf(av[u], st, bv[u]);
    if (u < n) hp[(size_t)u * D] = st;
  }
}

int launch_chunked(const float* x, const float* a, const float* init, float* h,
                   unsigned long long* words, int B, int S, int D, long long sxb,
                   long long sxs, long long sab, long long sas, cudaStream_t stream) {
  const int n_chunks = (S + CHUNK - 1) / CHUNK;
  const int tiles = (D + THREADS - 1) / THREADS;
  const long long blocks = (long long)n_chunks * B * tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t n_words = 1 + 2 * (size_t)B * n_chunks * D;
  cudaError_t err = cudaMemsetAsync(words, 0, n_words * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return (int)err;
  rglru_chunked_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      x, a, init, h, words, B, S, D, n_chunks, sxb, sxs, sab, sas);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rglru_chunk() { return CHUNK; }

// variant 0: `seq` (words unused, may be null); variant 1: `chunked`, with
// words holding 1 + 2 * B * ceil(S / CHUNK) * D 64-bit words, which the call
// zeroes on the stream before the launch.
extern "C" int rglru_forward(const float* x, const float* a, const float* init, float* h,
                             unsigned long long* words, int B, int S, int D, long long sxb,
                             long long sxs, long long sab, long long sas, int variant,
                             void* stream) {
  if (B < 0 || S < 1 || D < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 1)
    return launch_chunked(x, a, init, h, words, B, S, D, sxb, sxs, sab, sas, st);
  if (variant != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  rglru_seq_kernel<<<grid, THREADS, 0, st>>>(x, a, init, h, S, D, sxb, sxs, sab, sas);
  return (int)cudaGetLastError();
}
