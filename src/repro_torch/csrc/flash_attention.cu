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
// bf16: a tensor-core kernel (namespace tc).  One block per (b * H + h,
// 128-query tile), the tiles with the most keys launched first, walks its
// reachable key tiles (128 keys; 64 at hd 256) in a loop (how the TPU kernel's sequential k
// axis translates: Hopper blocks run in no order); tiles wholly above the
// diagonal or wholly left of the window are never loaded.  A producer
// warpgroup (one lane of it) issues TMA loads (cp.async.bulk.tensor) of the Q tile and of a
// two-stage ring of K and V tiles, each stage guarded by a full and an
// empty mbarrier, and hands most of its registers to the consumers
// (setmaxnreg).  The tensor maps are 4-D over the model's layout
// (hd, heads, S, B) with a (64, 1, rows, 1) box and the 128-byte swizzle,
// so a tile is one or two 64-column halves.  Rows past Sq or Sk and
// columns past hd arrive zero-filled from TMA's out-of-bounds fill: hd 112
// is computed at 128 (columns 112-127 of Q and V are zero) and those
// output columns are never stored, and a ragged Sq or Sk needs no separate
// path (keys past Sk are masked in the scores).  Two consumer warpgroups
// own 64 query rows each: S = Q K^T by wgmma (m64n128k16, both operands in
// shared memory), the online softmax on the f32 accumulator fragments in
// registers (four lanes share a row; exp2 with the scale folded in), P
// rounded to bf16 in registers and O += P V by wgmma with A from registers
// and V read N-major through the transpose flag (no transposing copy).
// hd 256 halves the key tile so that Q (64 KB) and two stages of K and V
// (2 x 64 KB) fit in 227 KB: S is then m64n64, and P V two m64n128 per
// 16 keys, one per 128 output columns (an f32 accumulator of 128 registers
// a thread, inside the consumers' 232).
// Rounding P to bf16 before P V is the one numeric change from the TPU
// kernel, which keeps it f32; the reference model's own XLA path rounds it
// too.
//
// The compute-probability mode (the model's attn_probs_dtype="compute",
// the reference's _sdpa(..., probs_dtype="compute")) is the same kernel
// with kCompute set: each score is rounded to bf16, multiplied by the
// bf16-rounded scale and rounded again, as the reference rounds q.k and
// then * scale, before the online max and the exp; and the row sum l adds
// the bf16-rounded P that P V reads, where the float32 mode sums the f32
// P.  Both modes keep a running max with rescaling and normalise o in f32
// before its one rounding (the reference subtracts the row's final max
// and rounds P V before it multiplies by the rounded 1 / l).
//
// f32: wgmma takes no f32 inputs, only TF32, whose 10-bit mantissa would
// break the 2e-5 tolerance the f32 checks rest on, so f32 keeps a scalar
// kernel (namespace scalar): one 256-thread block per (b * H + h, 64-query
// tile), K and V staged through a two-stage 4-byte cp.async ring of 64-key
// tiles (32 at hd 256, so that the ring fits in shared memory) in rows
// padded by one word, thread (ty, tx) owning query rows 4ty .. 4ty+3, f32
// FMAs, each row's statistics in the registers of one half-warp.  Serving
// and prefill run bf16.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace scalar {

constexpr int kThreads = 256;
constexpr int kBQ = 64;   // queries per block
constexpr int kRows = 4;  // query rows per thread (kBQ / 16)

template <typename T, int HD>
struct Layout {
  static constexpr int BK = HD > 128 ? 32 : 64;      // keys per tile
  static constexpr int COLS = BK / 16;               // keys per thread per tile
  static constexpr int W = HD * (int)sizeof(T) / 4;  // 32-bit words per row
  static constexpr int RS = W + 1;                   // padded row stride
  static constexpr int q_words = kBQ * RS;
  static constexpr int kv_words = BK * RS;           // one K or V tile
  static constexpr int p_stride = BK + 1;
  static constexpr int bytes =
      (q_words + 4 * kv_words + kBQ * p_stride) * 4;  // Q, 2 x (K, V), P
  static_assert(bytes <= 232448, "the block's shared memory must fit an SM");
};

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// q . k over one row pair, both in padded rows of 32-bit floats
template <typename T, int W, int COLS>
__device__ __forceinline__ void dot_rows(const uint32_t* __restrict__ q_rows,
                                         const uint32_t* __restrict__ k_rows,
                                         int RS, float (&s)[kRows][COLS]) {
#pragma unroll 4
  for (int w = 0; w < W; ++w) {
    float qv[kRows], kv[COLS];
#pragma unroll
    for (int i = 0; i < kRows; ++i) qv[i] = __uint_as_float(q_rows[i * RS + w]);
#pragma unroll
    for (int j = 0; j < COLS; ++j) kv[j] = __uint_as_float(k_rows[j * 16 * RS + w]);
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int Sq, int Sk, int H, int KV, float scale,
    int causal, int window) {
  using L = Layout<T, HD>;
  constexpr int W = L::W, RS = L::RS, kBK = L::BK, kCols = L::COLS;
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
    dot_rows<T, W, kCols>(q_s + (ty * kRows) * RS, ks + tx * RS, RS, s);

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

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int H, int KV, float scale, int causal,
              int window, cudaStream_t stream) {
  constexpr int smem = Layout<float, HD>::bytes;
  // above 48 KB of dynamic shared memory a kernel must opt in, once
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<float, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)(B * H));
  flash_attention_kernel<float, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H, KV,
      scale, causal, window);
  return (int)cudaGetLastError();
}

int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KV, int hd, float scale, int causal,
           int window, cudaStream_t stream) {
  switch (hd) {
    case 64: return launch_hd<64>(q, k, v, out, B, Sq, Sk, H, KV, scale, causal, window, stream);
    case 112: return launch_hd<112>(q, k, v, out, B, Sq, Sk, H, KV, scale, causal, window, stream);
    case 128: return launch_hd<128>(q, k, v, out, B, Sq, Sk, H, KV, scale, causal, window, stream);
    case 256: return launch_hd<256>(q, k, v, out, B, Sq, Sk, H, KV, scale, causal, window, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace scalar

namespace tc {

constexpr int kBQ = 128;                   // query rows per block
constexpr int kStages = 2;                 // depth of the K / V ring
constexpr int kConsumers = 256;             // two warpgroups of 64 query rows
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
// registers per thread after the producer hands its surplus to the
// consumers (setmaxnreg): 128 * 40 + 256 * 232 = 384 * 168, the budget
// of 384 threads on one SM
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kRowBytes = 128;             // a 64-column bf16 half-row: the swizzle width
constexpr float kLog2e = 1.4426950408889634f;
// returned for a tensor map that cannot be encoded, plus the driver's CUresult
constexpr int kEncodeError = 20000;

// Shared memory of one block: the Q tile, then kStages (K, V) tile pairs,
// each tile HDP / 64 halves of [rows][64] bf16 in the 128-byte swizzle,
// then the mbarriers; 1024 bytes of slack align the tiles to the swizzle
// atom.  Keys per tile: 128, or 64 at hd 256 (Q 64 KB + 2 x 128 KB of
// 128-key stages would not fit in 227 KB; 64-key stages take 2 x 64 KB).
template <int HDP>
struct Smem {
  static constexpr int BK = HDP > 128 ? 64 : 128;
  static constexpr int halves = HDP / 64;
  static constexpr int q_bytes = halves * kBQ * kRowBytes;
  static constexpr int kv_bytes = halves * BK * kRowBytes;  // one K or V tile
  static constexpr int stage_bytes = 2 * kv_bytes;
  static constexpr int bar_off = q_bytes + kStages * stage_bytes;
  static constexpr int bytes = bar_off + 8 * (1 + 2 * kStages) + 1024;
  static_assert(bytes <= 232448, "the block's shared memory must fit an SM");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spin until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one TMA box of a 4-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor in the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout type 1
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers an asynchronous wgmma reads or writes: keep every access on
// its side of the wait (volatile asm statements keep their order).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// lo and hi rounded to the nearest bf16, kept as floats: one packed
// conversion (conversions issue at a fraction of the FMA rate) and two
// integer ops to widen the halves back
__device__ __forceinline__ void round_bf16x2(float& lo, float& hi) {
  const uint32_t u = pack_bf16(lo, hi);
  lo = __uint_as_float(u << 16);
  hi = __uint_as_float(u & 0xffff0000u);
}

// D (+)= A B, m64n128k16, A and B from shared memory (both K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (+)= A B, m64n64k16, A and B from shared memory (both K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D += A B, m64n128k16, A (bf16 pairs) from registers, B from shared
// memory N-major (the transpose flag)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A B, m64n64k16, A (bf16 pairs) from registers, B from shared
// memory N-major (the transpose flag)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// scale: the softmax scale times log2(e) (float32 mode), or the scale
// already rounded to bf16 (kCompute)
template <int HDP, bool kCompute>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out, int Sq,
    int Sk, int H, int KV, int hd, float scale, int causal, int window) {
  using L = Smem<HDP>;
  constexpr int kBK = L::BK;   // keys per tile
  constexpr int NO = HDP / 2;  // output accumulator floats per thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, kv_s = base + L::q_bytes;
  const uint32_t q_bar = base + L::bar_off;
  const uint32_t full_bar = q_bar + 8, empty_bar = full_bar + 8 * kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / kBK;
  const int t_end = k_end > k_begin ? (k_end + kBK - 1) / kBK : t_begin;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {  // the producer warpgroup: one lane issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumers / 32 && lane == 0) {
      mbar_expect_tx(q_bar, L::q_bytes);
      for (int hf = 0; hf < L::halves; ++hf)
        tma_load(q_s + hf * kBQ * kRowBytes, &tq, q_bar, hf * 64, h, q0, b);
      for (int t = t_begin; t < t_end; ++t) {
        const int i = t - t_begin, s = i % kStages;
        if (i >= kStages) mbar_wait(empty_bar + 8 * s, (i / kStages - 1) & 1);
        const uint32_t ks = kv_s + s * L::stage_bytes, vs = ks + L::kv_bytes;
        mbar_expect_tx(full_bar + 8 * s, L::stage_bytes);
        for (int hf = 0; hf < L::halves; ++hf) {
          tma_load(ks + hf * kBK * kRowBytes, &tk, full_bar + 8 * s, hf * 64, kvh, t * kBK, b);
          tma_load(vs + hf * kBK * kRowBytes, &tv, full_bar + 8 * s, hf * 64, kvh, t * kBK, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // consumers: warpgroup wg owns query rows q0 + 64 wg .. q0 + 64 wg + 63.
  // In wgmma's accumulator layout this thread holds rows `row` and
  // `row + 8`, columns col, col + 1 of every 8-column group: element
  // [n8 * 4 + 2 r + c] is (row + 8 r, 8 n8 + col + c).
  const int wg = warp / 4;
  const int row = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col = 2 * (lane % 4);
  const int wq_first = q0 + wg * 64, wq_last = wq_first + 63;
  const uint32_t q_wg = q_s + wg * 64 * kRowBytes;
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // l: this thread's columns
  mbar_wait(q_bar, 0);

  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin, s = i % kStages;
    mbar_wait(full_bar + 8 * s, (i / kStages) & 1);
    const uint32_t ks = kv_s + s * L::stage_bytes, vs = ks + L::kv_bytes;

    // S = Q K^T: both K-major in shared memory, 16 columns of hd a step
    float sc[kBK / 2];
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int hf = 0; hf < L::halves; ++hf)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = desc(q_wg + hf * kBQ * kRowBytes + kk * 32, 16, 1024);
        const uint64_t db = desc(ks + hf * kBK * kRowBytes + kk * 32, 16, 1024);
        if constexpr (kBK == 128)
          wgmma_ss_n128(sc, da, db, hf + kk > 0);
        else
          wgmma_ss_n64(sc, da, db, hf + kk > 0);
      }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // mask (only tiles that cross an edge), online softmax in base 2
    const int k0 = t * kBK;
    const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > wq_first) ||
                      (window > 0 && k0 <= wq_last - window);
    if constexpr (kCompute) {
      // bf16(bf16(q.k) * scale), then to base 2 in f32; elements 2i and
      // 2i + 1 are neighbouring columns of one row
#pragma unroll
      for (int i = 0; i < kBK / 2; i += 2) {
        float a = sc[i], b = sc[i + 1];
        round_bf16x2(a, b);
        a *= scale;
        b *= scale;
        round_bf16x2(a, b);
        sc[i] = a * kLog2e;
        sc[i + 1] = b * kLog2e;
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row + 8 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int n8 = 0; n8 < kBK / 8; ++n8)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = sc[n8 * 4 + 2 * r + c];
          if constexpr (!kCompute) x *= scale;  // kCompute: scaled above
          if (edge) {
            const int kj = k0 + n8 * 8 + col + c;
            const bool ok = kj < Sk && (!causal || kj <= qi) && (window <= 0 || kj > qi - window);
            x = ok ? x : -INFINITY;
          }
          sc[n8 * 4 + 2 * r + c] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      // no visible key yet: p = 0 (not exp(-inf + inf)); o and l stay 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m[r] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int n8 = 0; n8 < kBK / 8; ++n8) {
        const int i = n8 * 4 + 2 * r;
        float p0 = exp2f(sc[i] - m_use), p1 = exp2f(sc[i + 1] - m_use);
        if constexpr (kCompute) round_bf16x2(p0, p1);  // l sums the P that P V reads
        sc[i] = p0;
        sc[i + 1] = p1;
        sum += p0;
        sum += p1;
      }
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }
#pragma unroll
    for (int n8 = 0; n8 < HDP / 8; ++n8) {
      o[n8 * 4 + 0] *= alpha[0];
      o[n8 * 4 + 1] *= alpha[0];
      o[n8 * 4 + 2] *= alpha[1];
      o[n8 * 4 + 3] *= alpha[1];
    }

    // P in bf16 as wgmma A fragments: keys 16 kb .. 16 kb + 15 are the
    // accumulator's 8-column groups 2 kb and 2 kb + 1
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kb = 0; kb < kBK / 16; ++kb) {
      pa[kb][0] = pack_bf16(sc[8 * kb + 0], sc[8 * kb + 1]);
      pa[kb][1] = pack_bf16(sc[8 * kb + 2], sc[8 * kb + 3]);
      pa[kb][2] = pack_bf16(sc[8 * kb + 4], sc[8 * kb + 5]);
      pa[kb][3] = pack_bf16(sc[8 * kb + 6], sc[8 * kb + 7]);
    }

    // O += P V: V N-major in shared memory (8-key groups 1024 bytes apart,
    // the 64-column halves a whole tile apart); at hd 256 one n128 product
    // per pair of halves, into the accumulator's two 64-float halves
    fence_regs(pa);  // P and O are final before the wgmma stage starts
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < kBK / 16; ++kb) {
      const uint32_t vk = vs + kb * 16 * kRowBytes;
      if constexpr (HDP == 256) {
        wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o[0]), pa[kb],
                      desc(vk, kBK * kRowBytes, 1024));
        wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&o[64]), pa[kb],
                      desc(vk + 2 * kBK * kRowBytes, kBK * kRowBytes, 1024));
      } else if constexpr (HDP == 128) {
        wgmma_rs_n128(o, pa[kb], desc(vk, kBK * kRowBytes, 1024));
      } else {
        wgmma_rs_n64(o, pa[kb], desc(vk, kBK * kRowBytes, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(empty_bar + 8 * s);  // this warp is done with the stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = lt > 0.f ? 1.f / lt : 0.f;
    const int qi = row + 8 * r;
    if (qi < Sq) {
      __nv_bfloat16* ob = out + (((size_t)b * Sq + qi) * H + h) * hd;
#pragma unroll
      for (int n8 = 0; n8 < HDP / 8; ++n8) {
        const int c = n8 * 8 + col;
        if (c < hd)  // hd 112 computes at 128 and stores 112 columns
          *reinterpret_cast<__nv_bfloat162*>(ob + c) =
              __floats2bfloat162_rn(o[n8 * 4 + 2 * r] * inv, o[n8 * 4 + 2 * r + 1] * inv);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, taken from the driver through the runtime's
// cudaGetDriverEntryPoint, so the library needs no link against libcuda
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess && p)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of a bf16 [B, S, heads, hd] array as the 4-D (hd, heads,
// S, B), boxes of (64, 1, rows, 1) in the 128-byte swizzle, zero fill out
// of bounds.  Returns 0, or kEncodeError + the driver's CUresult.
int encode(CUtensorMap* map, const void* base, int hd, int heads, int S, int B, int rows) {
  const EncodeTiled fn = encoder();
  if (!fn) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

template <int HDP, bool kCompute>
int launch_hdp(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
               int H, int KV, int hd, float scale, int causal, int window,
               cudaStream_t stream) {
  constexpr int smem = Smem<HDP>::bytes;
  // above 48 KB of dynamic shared memory a kernel must opt in, once
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(flash_attention_wgmma_kernel<HDP, kCompute>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  CUtensorMap tq, tk, tv;
  int e = encode(&tq, q, hd, H, Sq, B, kBQ);
  if (!e) e = encode(&tk, k, hd, KV, Sk, B, Smem<HDP>::BK);
  if (!e) e = encode(&tv, v, hd, KV, Sk, B, Smem<HDP>::BK);
  if (e) return e;
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)(B * H));
  flash_attention_wgmma_kernel<HDP, kCompute><<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KV, hd,
      kCompute ? scale : scale * kLog2e, causal, window);
  return (int)cudaGetLastError();
}

template <bool kCompute>
int launch_mode(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
                int H, int KV, int hd, float scale, int causal, int window,
                cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_hdp<64, kCompute>(q, k, v, out, B, Sq, Sk, H, KV, hd, scale, causal, window,
                                      stream);
    case 112:
    case 128:
      return launch_hdp<128, kCompute>(q, k, v, out, B, Sq, Sk, H, KV, hd, scale, causal, window,
                                       stream);
    case 256:
      return launch_hdp<256, kCompute>(q, k, v, out, B, Sq, Sk, H, KV, hd, scale, causal, window,
                                       stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
           int H, int KV, int hd, float scale, int causal, int window, int compute,
           cudaStream_t stream) {
  return compute ? launch_mode<true>(q, k, v, out, B, Sq, Sk, H, KV, hd, scale, causal, window,
                                     stream)
                 : launch_mode<false>(q, k, v, out, B, Sq, Sk, H, KV, hd, scale, causal, window,
                                      stream);
}

}  // namespace tc

// dtype codes: 0 = float32 (the scalar kernel), 1 = bfloat16 (the
// tensor-core kernel).  causal is 0 or 1; window <= 0 means no window.
// compute = 1 takes the bf16 kernel's compute-probability instances, with
// scale already rounded to bf16 by the caller; at float32 the two modes
// are one function and compute is ignored.
// Returns 0; a tensor map that cannot be encoded gives 20000 + the
// driver's CUresult; otherwise cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported hd, dtype or shape).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int Sq, int Sk, int H,
                                      int KV, int hd, float scale, int causal,
                                      int window, int compute, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return scalar::launch(q, k, v, out, B, Sq, Sk, H, KV, hd, scale, causal, window, s);
  if (dtype == 1)
    return tc::launch(q, k, v, out, B, Sq, Sk, H, KV, hd, scale, causal, window, compute, s);
  return (int)cudaErrorInvalidValue;
}
