// Full-sequence attention for Hopper (sm_90a): forward online-softmax
// attention with causal and sliding-window masks and grouped-query heads.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention_bhsd
// (Pallas, grid (B*H, Sq/blk_q, Sk/blk_k) with the k axis sequential and
// m/l/acc carried in VMEM scratch across it).  Computes, for every
// (b, query head h, query i), with keys j of kv head h / G:
//
//     s_j = (q_i . k_j) * scale        for j < Sk, j <= i (causal),
//                                      j > i - window (window > 0)
//     o_i = sum_j softmax(s)_j v_j     (f32 statistics and accumulator;
//                                       a row with no visible key gives 0)
//
// in the model's layouts: q and out [B, Sq, H, hd], k and v [B, Sk, KV, hd].
//
// Bound on this card: operations.  The causal score and PV products are
// 2 * B * H * Sq * Sk * hd flops for (B*H*Sq + 2*B*KV*Sk) * hd elements
// read, several hundred flops per byte at the model's lengths, so the least
// time is the flops over the bf16 tensor-core peak.
//
// Design: one 256-thread block per (b * H + h, 64-query tile), the tiles
// with the most keys launched first.  The block walks its reachable 64-key
// tiles in a loop (which is how the TPU kernel's sequential k axis
// translates: Hopper blocks run in no order), with the online-softmax
// m / l and the output accumulator in registers.  Tiles wholly above the
// diagonal or wholly left of the window are never loaded, and a ragged Sk
// is masked here, not padded: key rows past Sk are zero-filled in shared
// memory.  K and V tiles are staged in the input dtype through a two-stage
// cp.async ring (the next tile loads while this one is used), in rows
// padded by one 32-bit word so that the 16 threads reading 16 keys hit 16
// banks.  Thread (ty, tx) owns query rows 4*ty .. 4*ty+3: their scores for
// keys tx + 16j, and their outputs for dims tx + 16j, so each row's
// statistics live in the registers of the 16 threads of one half-warp and
// reduce by shuffles.  The products are scalar f32 FMAs: wgmma with TMA and
// warp specialisation are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;   // queries per block
constexpr int kBK = 64;   // keys per tile
constexpr int kRows = 4;  // query rows per thread (kBQ / 16)
constexpr int kCols = 4;  // keys per thread per tile (kBK / 16)

template <typename T, int HD>
struct Layout {
  static constexpr int W = HD * (int)sizeof(T) / 4;  // 32-bit words per row
  static constexpr int RS = W + 1;                   // padded row stride
  static constexpr int q_words = kBQ * RS;
  static constexpr int kv_words = kBK * RS;          // one K or V tile
  static constexpr int p_stride = kBK + 1;
  static constexpr int bytes =
      (q_words + 4 * kv_words + kBQ * p_stride) * 4;  // Q, 2 x (K, V), P
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// q . k over one row pair, both in padded 32-bit-word rows of T
template <typename T, int W>
__device__ __forceinline__ void dot_rows(const uint32_t* __restrict__ q_rows,
                                         const uint32_t* __restrict__ k_rows,
                                         int RS, float (&s)[kRows][kCols]) {
#pragma unroll 4
  for (int w = 0; w < W; ++w) {
    if constexpr (sizeof(T) == 2) {
      float2 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const uint32_t u = q_rows[i * RS + w];
        qv[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const uint32_t u = k_rows[j * 16 * RS + w];
        kv[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          s[i][j] = fmaf(qv[i].x, kv[j].x, fmaf(qv[i].y, kv[j].y, s[i][j]));
    } else {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = __uint_as_float(q_rows[i * RS + w]);
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = __uint_as_float(k_rows[j * 16 * RS + w]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int Sq, int Sk, int H, int KV, float scale,
    int causal, int window) {
  using L = Layout<T, HD>;
  constexpr int W = L::W, RS = L::RS;
  constexpr int DJ = HD / 16;  // output dims per thread
  static_assert(HD % 16 == 0, "16 threads split hd");

  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* q_s = smem;                          // [kBQ][RS]
  uint32_t* kv_s = q_s + L::q_words;             // [2][K, V][kBK][RS]
  float* p_s = reinterpret_cast<float*>(kv_s + 4 * L::kv_words);  // [kBQ][kBK+1]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int qt = gridDim.x - 1 - blockIdx.x;     // heaviest tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const int q_last = min(q0 + kBQ, Sq) - 1;

  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int t_end = k_end > k_begin ? (k_end + kBK - 1) / kBK : t_begin;

  const size_t kv_row = (size_t)KV * HD;         // elements between keys
  const T* kb = k + ((size_t)b * Sk * KV + kvh) * HD;
  const T* vb = v + ((size_t)b * Sk * KV + kvh) * HD;

  // Q tile: rows past Sq are zero (their outputs are never written)
  {
    const T* qb = q + ((size_t)b * Sq * H + h) * HD;
    for (int i = tid; i < kBQ * W; i += kThreads) {
      const int r = i / W, w = i % W;
      if (q0 + r < Sq)
        cp_async4(q_s + r * RS + w,
                  reinterpret_cast<const uint32_t*>(qb + (size_t)(q0 + r) * H * HD) + w);
      else
        q_s[r * RS + w] = 0u;
    }
  }
  // one K and V tile into a ring stage; key rows past Sk are zero-filled
  auto load_tile = [&](int t, int stage) {
    uint32_t* ks = kv_s + stage * 2 * L::kv_words;
    uint32_t* vs = ks + L::kv_words;
    const int k0 = t * kBK;
    for (int i = tid; i < kBK * W; i += kThreads) {
      const int r = i / W, w = i % W;
      if (k0 + r < Sk) {
        const size_t off = (size_t)(k0 + r) * kv_row;
        cp_async4(ks + r * RS + w, reinterpret_cast<const uint32_t*>(kb + off) + w);
        cp_async4(vs + r * RS + w, reinterpret_cast<const uint32_t*>(vb + off) + w);
      } else {
        ks[r * RS + w] = 0u;
        vs[r * RS + w] = 0u;
      }
    }
  };
  if (t_begin < t_end) load_tile(t_begin, 0);
  cp_async_commit();

  float acc[kRows][DJ];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) load_tile(t + 1, stage ^ 1);
    cp_async_commit();  // empty groups keep the count uniform
    cp_async_wait<1>();
    __syncthreads();

    const uint32_t* ks = kv_s + stage * 2 * L::kv_words;
    const T* vs = reinterpret_cast<const T*>(ks + L::kv_words);
    const int k0 = t * kBK;

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    dot_rows<T, W>(q_s + (ty * kRows) * RS, ks + tx * RS, RS, s);

    // mask, online softmax over this tile; a row's 16 owners share a half-warp
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty * kRows + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + 16 * j;
        bool ok = kj < Sk;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && kj > qi - window;
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      // no visible key yet: keep everything at 0 rather than exp(-inf + inf)
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = m_new == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        p_s[(ty * kRows + i) * L::p_stride + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // P @ V: rows 4*ty.., dims tx + 16j
    constexpr int VS = RS * 4 / (int)sizeof(T);  // V row stride in elements
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(ty * kRows + i) * L::p_stride + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = to_f(vs[c * VS + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
    __syncthreads();  // the stage and p_s are reused by later tiles
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty * kRows + i;
    if (qi < Sq) {
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
      T* ob = out + (((size_t)b * Sq + qi) * H + h) * HD;
#pragma unroll
      for (int j = 0; j < DJ; ++j) ob[tx + 16 * j] = from_f<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int H, int KV, float scale, int causal,
              int window, cudaStream_t stream) {
  constexpr int smem = Layout<T, HD>::bytes;
  // above 48 KB of dynamic shared memory a kernel must opt in, once
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)(B * H));
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, H, KV, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KV, int hd, float scale, int causal,
           int window, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch_hd<T, 64>(q, k, v, out, B, Sq, Sk, H, KV, scale, causal, window, stream);
    case 112: return launch_hd<T, 112>(q, k, v, out, B, Sq, Sk, H, KV, scale, causal, window, stream);
    case 128: return launch_hd<T, 128>(q, k, v, out, B, Sq, Sk, H, KV, scale, causal, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  causal is 0 or 1; window <= 0
// means no window.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported hd, dtype or shape).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int Sq, int Sk, int H,
                                      int KV, int hd, float scale, int causal,
                                      int window, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(q, k, v, out, B, Sq, Sk, H, KV, hd, scale, causal, window, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KV, hd, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
