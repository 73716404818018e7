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
//     o   = sum_j softmax(s)_j v_j     (f32 statistics and accumulator)
//
// in the model's layouts: q and out [B, 1, H, hd], caches [B, S, KV, hd].
//
// Bound on this card: bytes.  Each call streams the valid part of the K and
// V caches once (2 * B * KV * (keys) * hd * elt bytes) for ~4 flops per
// cached element, so the least time is those bytes / 3.35 TB/s.
//
// Design: one 256-thread block per (b, kv head) walks the valid key range
// only (no padding, nothing past pos or before the window is read, which is
// how the TPU kernel's block skipping translates).  Tiles of TK = 32 keys of
// K and V stream into a ring of shared-memory stages with cp.async, several
// tiles ahead of the one being used (128 KB in flight per block), so the
// loads of later tiles overlap the math of the current one.  Per tile each
// warp computes the G scores of its keys (lanes split hd, warp-shuffle
// sum), one warp per query row updates the online-softmax m/l, and each
// thread keeps the accumulators of one output dimension for half of the G
// rows in registers.  pos is read from device memory, so a decode step
// never waits on the host.  At B*KV = 32 (qwen3 at batch 4) this fills 32 of
// the 132 SMs: splitting the key range across blocks (flash-decoding), TMA
// and wgmma are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileKeys = 32;

// K+V ring: 8 stages of bf16 (or 4 of f32) tiles at hd 128 = 128 KB
template <typename T>
__host__ __device__ constexpr int stages() { return sizeof(T) == 2 ? 8 : 4; }

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

template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ pos_ptr, T* __restrict__ out, int S, int KV, int G,
    float scale, int window) {
  constexpr int TK = kTileKeys;
  constexpr int NS = stages<T>();
  constexpr int EPV = 16 / (int)sizeof(T);       // elements per 16-byte vector
  constexpr int VPR = HD / EPV;                  // 16-byte vectors per key row
  constexpr int DPL = (HD + 31) / 32;            // dims per lane in the score phase
  constexpr int GPT = GMAX / 2;                  // query rows per thread in P @ V
  static_assert(HD % EPV == 0, "rows must split into 16-byte vectors");
  static_assert(HD <= kThreads / 2, "two threads per output dimension");
  static_assert(TK % kWarps == 0 && TK <= 32, "whole keys per warp, a key per lane");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);      // [NS][2][TK][HD]
  __shared__ float p_s[GMAX][TK];
  __shared__ float m_s[GMAX], l_s[GMAX], alpha_s[GMAX];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / KV, h = blockIdx.x % KV;
  const int H = KV * G;
  const int pos = *pos_ptr;
  const int hi = min(pos, S - 1);
  const int lo = window > 0 ? max(0, pos - window + 1) : 0;
  const int n_tiles = hi >= lo ? (hi - lo + TK) / TK : 0;

  const size_t key_stride = (size_t)KV * HD;  // elements between consecutive keys
  const T* kb = k + ((size_t)b * S * KV + h) * HD;
  const T* vb = v + ((size_t)b * S * KV + h) * HD;

  // cp.async one tile's K and V rows into its ring stage
  auto issue = [&](int tile) {
    T* ks = ring + (size_t)(tile % NS) * 2 * TK * HD;
    T* vs = ks + TK * HD;
    const int t0 = lo + tile * TK;
    const int n = min(TK, hi - t0 + 1);
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
  float qr[GMAX][DPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      qr[g][i] = (g < G && d < HD) ? to_f(qb[g * HD + d]) : 0.f;
    }
  }
  // P @ V ownership: output dimension d, rows g0, g0 + 2, ...
  const int d = tid % (kThreads / 2), g0 = tid / (kThreads / 2);
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
    const int n = min(TK, hi - (lo + tile * TK) + 1);  // every key is valid

    // scores: warp w takes keys w, w + 8, ...; lanes split hd.  All of a
    // warp's partial dots are formed first, so their shuffle reductions are
    // independent and overlap instead of running one after another.
    constexpr int KPW = TK / kWarps;  // keys per warp
    float part[KPW][GMAX];
#pragma unroll
    for (int r = 0; r < KPW; ++r) {
      const int j = warp + r * kWarps;
#pragma unroll
      for (int g = 0; g < GMAX; ++g) part[r][g] = 0.f;
      if (j < n) {
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int dd = lane + 32 * i;
          if (dd < HD) {
            const float kv = to_f(ks[j * HD + dd]);
#pragma unroll
            for (int g = 0; g < GMAX; ++g) part[r][g] += qr[g][i] * kv;
          }
        }
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
        if (g0 + 2 * i < G) acc[i] *= alpha_s[g0 + 2 * i];
#pragma unroll 8
      for (int j = 0; j < TK; ++j) {
        if (j < n) {
          const float vv = to_f(vs[j * HD + d]);
#pragma unroll
          for (int i = 0; i < GPT; ++i)
            if (g0 + 2 * i < G) acc[i] += p_s[g0 + 2 * i][j] * vv;
        }
      }
    }
    __syncthreads();  // the stage and p_s are reused by later tiles
  }
  cp_async_wait<0>();

  if (d < HD) {
    T* ob = out + ((size_t)b * H + (size_t)h * G) * HD;
#pragma unroll
    for (int i = 0; i < GPT; ++i) {
      const int g = g0 + 2 * i;
      if (g < G) ob[g * HD + d] = from_f<T>(acc[i] / fmaxf(l_s[g], 1e-30f));
    }
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, const void* pos,
              void* out, int B, int S, int KV, int G, float scale, int window,
              cudaStream_t stream) {
  const dim3 grid((unsigned)(B * KV));
  constexpr int smem = smem_bytes<T, HD>();
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const int* pp = static_cast<const int*>(pos);
  T* op = static_cast<T*>(out);
  // above 48 KB of dynamic shared memory a kernel must opt in, once
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(decode_attention_kernel<T, HD, 4>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(decode_attention_kernel<T, HD, 16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  if (G <= 4) {
    decode_attention_kernel<T, HD, 4><<<grid, kThreads, smem, stream>>>(
        qp, kp, vp, pp, op, S, KV, G, scale, window);
  } else if (G <= 16) {
    decode_attention_kernel<T, HD, 16><<<grid, kThreads, smem, stream>>>(
        qp, kp, vp, pp, op, S, KV, G, scale, window);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* out, int B, int S, int KV, int G, int hd, float scale,
           int window, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch_hd<T, 64>(q, k, v, pos, out, B, S, KV, G, scale, window, stream);
    case 112: return launch_hd<T, 112>(q, k, v, pos, out, B, S, KV, G, scale, window, stream);
    case 128: return launch_hd<T, 128>(q, k, v, pos, out, B, S, KV, G, scale, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
// pos points at one int32 in device memory.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for an unsupported hd, G or dtype).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* pos, void* out, int B, int S,
                                       int KV, int G, int hd, float scale,
                                       int window, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || KV <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(q, k, v, pos, out, B, S, KV, G, hd, scale, window, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, pos, out, B, S, KV, G, hd, scale, window, s);
  return (int)cudaErrorInvalidValue;
}
