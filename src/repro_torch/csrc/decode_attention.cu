// Decode attention for Hopper (sm_90a): one new query token per sequence
// against its KV cache, grouped-query (G query heads share one KV head).
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention/kernel.py:decode_attention_bkv
// (Pallas, grid (B*KV, Sk/blk_k) with VMEM m/l/acc scratch carried across
// the sequential k axis and the position by scalar prefetch).  Computes,
// for each (b, kv head) and each of its G query rows:
//
//     s_j = (q . k_j) * scale          for keys max(0, pos-window+1) <= j <= pos
//     o   = sum_j softmax(s)_j v_j     (f32 statistics, probabilities and
//                                       accumulator)
//
// in the model's layouts: q and out [B, 1, H, hd], caches [B, S, KV, hd].
//
// Bound on this card: bytes.  Each call streams the valid part of the K and
// V caches once (2 * B * KV * (keys) * hd * elt bytes) for ~4 flops per
// cached element, so the least time is those bytes / 3.35 TB/s.
//
// Design (flash-decoding): the grid is (B*KV, n_split).  n_split is chosen
// by the wrapper from S_max, B*KV and the SM count (never from pos), so
// that a long cache puts blocks on every SM in one wave, while a short
// serving cache keeps n_split 1.  Each block reads pos from device memory
// (a decode step never waits on the host) and walks the valid keys
// [max(0, pos - window + 1), pos] of its slice of the cache (n_split
// slices of whole 32-key tiles, sized from S_max) only: nothing past pos
// or before the window is read, which is how the TPU kernel's block
// skipping translates; a slice wholly outside that range is empty.
// Tiles of K and V stream into a ring of shared-memory stages by 16-byte
// cp.async (48 KB a block at bf16, hd 128, so four blocks share an SM; 96
// KB at hd 256, two; the wrapper's plan_splits sizes the split to the
// blocks an SM holds).  Per
// tile each warp computes the G scores of its keys (each lane reads one
// contiguous 4- to 16-byte slice of a key row; all of a warp's partial
// dots are formed before their shuffle reductions, so those overlap),
// one warp per query row updates the online-softmax m / l, and each
// thread keeps the accumulators of one output dimension for half of the
// G rows (all of them at hd 256, where every thread owns a dimension).  With n_split 1 the block writes the output itself (no
// scratch, one launch); otherwise it writes its m, l and unnormalised f32
// accumulator to scratch the wrapper allocates, and a second launch from
// the same entry point merges the slices.  An empty slice writes
// m = -inf, l = 0.
//
// Partials mode (decode_attention_partials_launch), for a cache split by
// sequence across ranks: the caches are one rank's block of keys and the
// pos the kernel reads is the global position minus the block's first key
// (the wrapper subtracts it on the device), so the same cut to
// [max(0, pos - window + 1), min(pos, S - 1)] keeps the block's valid
// keys, across block boundaries too, and a block wholly past pos is
// empty.  Every slice writes its partials, at n_split 1 too, and no merge
// runs: the ranks all-gather their partials, and
// decode_attention_merge_launch runs the same merge kernel over the
// n_ranks x n_split slices.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileKeys = 32;

// K+V ring: 3 stages of bf16 (or 2 of f32) tiles, 48 KB (64 KB) at hd 128,
// 96 KB (128 KB) at hd 256
template <typename T>
__host__ __device__ constexpr int stages() { return sizeof(T) == 2 ? 3 : 2; }

template <typename T, int HD>
__host__ __device__ constexpr int smem_bytes() {
  return stages<T>() * 2 * kTileKeys * HD * (int)sizeof(T);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// CPL consecutive elements of a shared-memory row as floats, in loads of
// 4, 8 or 16 bytes (no type-punned pointer: the words come from ld.shared)
template <typename T, int CPL>
__device__ __forceinline__ void load_slice(const T* p, float (&x)[CPL]) {
  constexpr int W = CPL * (int)sizeof(T) / 4;  // 32-bit words
  static_assert(W == 1 || W == 2 || W % 4 == 0, "4, 8 or a multiple of 16 bytes");
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  uint32_t w[W];
  if constexpr (W == 1) {
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(w[0]) : "r"(a) : "memory");
  } else if constexpr (W == 2) {
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(w[0]), "=r"(w[1]) : "r"(a)
                 : "memory");
  } else {
#pragma unroll
    for (int i = 0; i < W; i += 4)
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(w[i]), "=r"(w[i + 1]), "=r"(w[i + 2]), "=r"(w[i + 3])
                   : "r"(a + 4 * i)
                   : "memory");
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (sizeof(T) == 2) {  // a bf16 is the high half of an f32
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      x[i] = __uint_as_float(w[i]);
    }
  }
}

// An opaque copy of x: the compiler cannot re-derive it through the
// min / max chain that computes it.  Without it nvcc 12.9's optimiser
// does not finish on the slice bounds below.
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Scratch of one launch with n_split > 1, f32: m [BKV, n_split, G],
// l [BKV, n_split, G], acc [BKV, n_split, G, HD].
struct Partials {
  float* m;
  float* l;
  float* acc;
  __host__ __device__ Partials(float* base, int bkv, int n_split, int G)
      : m(base), l(base + (size_t)bkv * n_split * G),
        acc(base + 2 * (size_t)bkv * n_split * G) {}
};

template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ pos_ptr, T* __restrict__ out,
    float* __restrict__ scratch, int S, int KV, int G, float scale, int window,
    int n_split, int per) {
  constexpr int TK = kTileKeys;
  constexpr int NS = stages<T>();
  constexpr int EPV = 16 / (int)sizeof(T);       // elements per 16-byte vector
  constexpr int VPR = HD / EPV;                  // 16-byte vectors per key row
  constexpr int CPL = HD >= 192 ? 8 : HD >= 96 ? 4 : 2;  // contiguous dims per lane (scores)
  constexpr int LANES = HD / CPL;                // lanes that hold a slice of a row
  // threads per output dimension in P @ V (two up to hd 128, one at hd 256),
  // each keeping the accumulators of every RS-th query row
  constexpr int RS = HD <= kThreads / 2 ? 2 : 1;
  constexpr int GPT = GMAX / RS;                 // query rows per thread in P @ V
  static_assert(HD % EPV == 0, "rows must split into 16-byte vectors");
  static_assert(HD <= kThreads && LANES <= 32, "a thread per output dimension, a lane per slice");
  static_assert(TK % kWarps == 0 && TK <= 32, "whole keys per warp, a key per lane");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);      // [NS][2][TK][HD]
  __shared__ float p_s[GMAX][TK];
  __shared__ float m_s[GMAX], l_s[GMAX], alpha_s[GMAX];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bkv = blockIdx.x, split = blockIdx.y;
  const int b = bkv / KV, h = bkv % KV;
  const int H = KV * G;
  const int pos = *pos_ptr;
  // this block's slice: cache keys [split * per, split * per + per), the
  // valid ones only
  const int s_lo = opaque(max(window > 0 ? max(0, pos - window + 1) : 0, split * per));
  const int s_hi = opaque(min(min(pos, S - 1), split * per + per - 1));
  const int n_tiles = s_hi >= s_lo ? (s_hi - s_lo + TK) / TK : 0;

  const size_t key_stride = (size_t)KV * HD;  // elements between consecutive keys
  const T* kb = k + ((size_t)b * S * KV + h) * HD;
  const T* vb = v + ((size_t)b * S * KV + h) * HD;

  // cp.async one tile's K and V rows into its ring stage
  auto issue = [&](int tile) {
    T* ks = ring + (size_t)(tile % NS) * 2 * TK * HD;
    T* vs = ks + TK * HD;
    const int t0 = s_lo + tile * TK;
    const int n = min(TK, s_hi - t0 + 1);
    for (int i = tid; i < n * VPR; i += kThreads) {
      const int j = i / VPR, c = (i % VPR) * EPV;
      const size_t off = (size_t)(t0 + j) * key_stride + c;
      cp_async16(ks + j * HD + c, kb + off);
      cp_async16(vs + j * HD + c, vb + off);
    }
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < n_tiles) issue(s);
    cp_async_commit();  // empty groups keep the group count uniform
  }

  // this lane's slice of every query row of the group
  const T* qb = q + ((size_t)b * H + (size_t)h * G) * HD;
  float qr[GMAX][CPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      qr[g][c] = (g < G && lane < LANES) ? to_f(qb[g * HD + lane * CPL + c]) : 0.f;
  }
  // P @ V ownership: output dimension d, rows g0, g0 + RS, ...
  const int d = tid % (kThreads / RS), g0 = tid / (kThreads / RS);
  float acc[GPT];
#pragma unroll
  for (int i = 0; i < GPT; ++i) acc[i] = 0.f;
  if (tid < GMAX) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + NS - 1 < n_tiles) issue(tile + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();  // this tile's group has landed (for this thread)
    __syncthreads();          // ... and for every thread

    const T* ks = ring + (size_t)(tile % NS) * 2 * TK * HD;
    const T* vs = ks + TK * HD;
    const int n = min(TK, s_hi - (s_lo + tile * TK) + 1);  // every key is valid

    // scores: warp w takes keys w, w + 8, ...; lane l holds dims
    // l*CPL .. l*CPL + CPL-1 of a row (one 4- to 16-byte load).  All of a
    // warp's partial dots are formed first, so their shuffle reductions are
    // independent and overlap instead of running one after another.
    constexpr int KPW = TK / kWarps;  // keys per warp
    float part[KPW][GMAX];
#pragma unroll
    for (int r = 0; r < KPW; ++r) {
      const int j = warp + r * kWarps;
#pragma unroll
      for (int g = 0; g < GMAX; ++g) part[r][g] = 0.f;
      if (j < n && lane < LANES) {
        float kv[CPL];
        load_slice<T, CPL>(ks + j * HD + lane * CPL, kv);
#pragma unroll
        for (int c = 0; c < CPL; ++c)
#pragma unroll
          for (int g = 0; g < GMAX; ++g) part[r][g] = fmaf(qr[g][c], kv[c], part[r][g]);
      }
    }
#pragma unroll
    for (int r = 0; r < KPW; ++r) {
      const int j = warp + r * kWarps;
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g < G) {
          const float sum = warp_sum(part[r][g]);
          if (lane == 0 && j < n) p_s[g][j] = sum * scale;
        }
      }
    }
    __syncthreads();

    // online softmax: warp w updates rows w, w + 8, ...
    for (int g = warp; g < G; g += kWarps) {
      const float s = lane < n ? p_s[g][lane] : -INFINITY;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = lane < n ? expf(s - m_new) : 0.f;
      if (lane < n) p_s[g][lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float a = expf(m_old - m_new);  // 0 on the first tile (m_old = -inf)
        alpha_s[g] = a;
        l_s[g] = l_s[g] * a + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // P @ V
    if (d < HD) {
#pragma unroll
      for (int i = 0; i < GPT; ++i)
        if (g0 + RS * i < G) acc[i] *= alpha_s[g0 + RS * i];
#pragma unroll 8
      for (int j = 0; j < TK; ++j) {
        if (j < n) {
          const float vv = to_f(vs[j * HD + d]);
#pragma unroll
          for (int i = 0; i < GPT; ++i)
            if (g0 + RS * i < G) acc[i] += p_s[g0 + RS * i][j] * vv;
        }
      }
    }
    __syncthreads();  // the stage and p_s are reused by later tiles
  }
  cp_async_wait<0>();

  if (scratch == nullptr) {  // n_split 1 outside the partials mode
    if (d < HD) {
      T* ob = out + ((size_t)b * H + (size_t)h * G) * HD;
#pragma unroll
      for (int i = 0; i < GPT; ++i) {
        const int g = g0 + RS * i;
        if (g < G) ob[g * HD + d] = from_f<T>(acc[i] / fmaxf(l_s[g], 1e-30f));
      }
    }
  } else {
    const Partials part(scratch, gridDim.x, n_split, G);
    const size_t row0 = ((size_t)bkv * n_split + split) * G;
    if (tid < G) {
      part.m[row0 + tid] = m_s[tid];
      part.l[row0 + tid] = l_s[tid];
    }
    if (d < HD) {
#pragma unroll
      for (int i = 0; i < GPT; ++i) {
        const int g = g0 + RS * i;
        if (g < G) part.acc[(row0 + g) * HD + d] = acc[i];
      }
    }
  }
}

// One block per (b, kv head): combines the n_split slices' (m, l, acc) of
// each query row of the group, o = sum_s acc_s e^(m_s - M) / sum_s l_s
// e^(m_s - M) with M the largest m_s; empty slices (m = -inf) weigh 0.
// Over n_ranks buffers of partials rank_stride floats apart (the ranks'
// blocks of keys, in the blocks' order, as the all-gather lays them out),
// the slices are each rank's n_split in turn; one buffer at the split-K
// merge.
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attention_merge_kernel(
    const float* __restrict__ scratch, T* __restrict__ out, int bkv_total,
    int n_split, int G, int HD, int n_ranks, size_t rank_stride) {
  const int bkv = blockIdx.x;
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    float M = -INFINITY;
    for (int r = 0; r < n_ranks; ++r) {
      const Partials part(const_cast<float*>(scratch) + r * rank_stride, bkv_total, n_split, G);
      for (int s = 0; s < n_split; ++s)
        M = fmaxf(M, part.m[((size_t)bkv * n_split + s) * G + g]);
    }
    float L = 0.f, o = 0.f;
    for (int r = 0; r < n_ranks; ++r) {
      const Partials part(const_cast<float*>(scratch) + r * rank_stride, bkv_total, n_split, G);
      for (int s = 0; s < n_split; ++s) {
        const size_t row = ((size_t)bkv * n_split + s) * G + g;
        const float ms = part.m[row];
        if (ms == -INFINITY) continue;
        const float w = expf(ms - M);
        L = fmaf(part.l[row], w, L);
        o = fmaf(part.acc[row * HD + d], w, o);
      }
    }
    out[((size_t)bkv * G + g) * HD + d] = from_f<T>(o / fmaxf(L, 1e-30f));
  }
}

template <typename T, int HD, int GMAX>
int launch_g(const void* q, const void* k, const void* v, const void* pos,
             void* out, void* scratch, int B, int S, int KV, int G,
             float scale, int window, int n_split, bool merge, cudaStream_t stream) {
  const dim3 grid((unsigned)(B * KV), (unsigned)n_split);
  constexpr int smem = smem_bytes<T, HD>();
  // keys per slice: whole tiles, from the cache length (never from pos)
  const int per = ((S + n_split - 1) / n_split + kTileKeys - 1) / kTileKeys * kTileKeys;
  float* sp = static_cast<float*>(scratch);
  T* op = static_cast<T*>(out);
  // above 48 KB of dynamic shared memory an instance must opt in, once,
  // before its first launch (a CUDA graph's warm-up reaches it before the
  // capture)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(decode_attention_kernel<T, HD, GMAX>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  decode_attention_kernel<T, HD, GMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(pos), op, sp, S, KV, G, scale, window, n_split, per);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1 || !merge) return (int)e;
  decode_attention_merge_kernel<T><<<B * KV, kThreads, 0, stream>>>(
      sp, op, B * KV, n_split, G, HD, 1, 0);
  return (int)cudaGetLastError();
}

// The GQA groups each head dim is built for: up to 16 query rows a block
// at hd <= 128, up to 4 at hd 256 (gemma3's G 4), where a lane holds 8
// dims of every row and 16 rows would not fit in registers.
template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* pos,
              void* out, void* scratch, int B, int S, int KV, int G,
              float scale, int window, int n_split, bool merge, cudaStream_t stream) {
  if (G <= 2)
    return launch_g<T, HD, 2>(q, k, v, pos, out, scratch, B, S, KV, G, scale, window, n_split,
                              merge, stream);
  if (G <= 4)
    return launch_g<T, HD, 4>(q, k, v, pos, out, scratch, B, S, KV, G, scale, window, n_split,
                              merge, stream);
  if constexpr (HD <= 128) {
    if (G <= 16)
      return launch_g<T, HD, 16>(q, k, v, pos, out, scratch, B, S, KV, G, scale, window,
                                 n_split, merge, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* out, void* scratch, int B, int S, int KV, int G, int hd,
           float scale, int window, int n_split, bool merge, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch_hd<T, 64>(q, k, v, pos, out, scratch, B, S, KV, G, scale, window, n_split, merge, stream);
    case 112: return launch_hd<T, 112>(q, k, v, pos, out, scratch, B, S, KV, G, scale, window, n_split, merge, stream);
    case 128: return launch_hd<T, 128>(q, k, v, pos, out, scratch, B, S, KV, G, scale, window, n_split, merge, stream);
    case 256: return launch_hd<T, 256>(q, k, v, pos, out, scratch, B, S, KV, G, scale, window, n_split, merge, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
// pos points at one int32 in device memory.  n_split >= 1 slices of the
// key range; above 1, scratch holds B*KV*n_split*G*(hd + 2) floats and a
// merge launch follows (scratch is ignored at n_split 1).  Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for an
// unsupported hd, G, dtype or split).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* pos, void* out, void* scratch,
                                       int B, int S, int KV, int G, int hd,
                                       float scale, int window, int n_split,
                                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || KV <= 0 || G <= 0 || n_split < 1 || n_split > 65535 ||
      (n_split > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_split == 1) scratch = nullptr;  // the block writes the output itself
  if (dtype == 0)
    return launch<float>(q, k, v, pos, out, scratch, B, S, KV, G, hd, scale, window, n_split,
                         true, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, pos, out, scratch, B, S, KV, G, hd, scale, window,
                                 n_split, true, s);
  return (int)cudaErrorInvalidValue;
}

// The partials mode: the same kernel over a block of keys, pos already the
// position relative to the block's first key (it may be negative, or past
// the block).  scratch receives B*KV*n_split*G*(hd + 2) floats: m
// [B*KV, n_split, G], l [B*KV, n_split, G], acc [B*KV, n_split, G, hd];
// no output and no merge.
extern "C" int decode_attention_partials_launch(const void* q, const void* k, const void* v,
                                                const void* pos, void* scratch, int B, int S,
                                                int KV, int G, int hd, float scale, int window,
                                                int n_split, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || KV <= 0 || G <= 0 || n_split < 1 || n_split > 65535 ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, pos, nullptr, scratch, B, S, KV, G, hd, scale, window,
                         n_split, false, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, pos, nullptr, scratch, B, S, KV, G, hd, scale,
                                 window, n_split, false, s);
  return (int)cudaErrorInvalidValue;
}

// The merge of n_ranks buffers of partials, each as the partials mode
// writes it (n_split slices per (b, kv head)) and rank_stride floats after
// the one before (the all-gathered [n_ranks, rank_stride] buffer, read in
// place), into out [B, 1, KV*G, hd].
extern "C" int decode_attention_merge_launch(const void* scratch, void* out, int bkv,
                                             int n_ranks, long long rank_stride, int n_split,
                                             int G, int hd, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bkv <= 0 || n_ranks < 1 || n_split < 1 || G <= 0 || hd <= 0 || scratch == nullptr ||
      rank_stride < (long long)bkv * n_split * G * (hd + 2))
    return (int)cudaErrorInvalidValue;
  const float* sp = static_cast<const float*>(scratch);
  const size_t stride = (size_t)rank_stride;
  if (dtype == 0)
    decode_attention_merge_kernel<float><<<bkv, kThreads, 0, s>>>(
        sp, static_cast<float*>(out), bkv, n_split, G, hd, n_ranks, stride);
  else if (dtype == 1)
    decode_attention_merge_kernel<__nv_bfloat16><<<bkv, kThreads, 0, s>>>(
        sp, static_cast<__nv_bfloat16*>(out), bkv, n_split, G, hd, n_ranks, stride);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
