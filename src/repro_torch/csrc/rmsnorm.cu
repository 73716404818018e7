// RMSNorm with an optional fused residual, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py:rmsnorm_rows
// (Pallas, row-blocked in VMEM).  Computes, per row of x [rows, d]:
//
//     xf = x (+ residual)        in f32
//     y  = xf * rsqrt(mean(xf^2) + eps) * scale      -> x's dtype
//
// and returns y only, like the TPU kernel (the summed residual is not
// written back).
//
// Bound on this card: bytes.  It reads x (and the residual) once and writes
// y once, with 3-4 flops per element, far below the ~295 flop/byte at which
// an H100 stops being memory-bound.  The least time is
// (bytes of x + residual + y + scale) / 3.35 TB/s.  So each byte crosses
// device memory once, with enough 16-byte loads in flight per SM to cover
// its latency (3.35 TB/s x ~0.7 us is ~2.3 MB over 132 SMs: 16-24 KB).
//
// Three paths; the host plan (kernels/rmsnorm/ops.py:plan_rows) picks one,
// with its lanes per row (LPR), 16-byte vectors per lane (VPL) and grid:
//
// * rows (rmsnorm_rows_kernel): each byte of a row crosses device memory
//   once, by TMA.  Warps are persistent: the grid fills the SMs once
//   (MIN_BLOCKS per SM) and each warp strides over steps of RPW rows.
//   Lane 0 keeps STAGES steps in flight in the warp's own ring in shared
//   memory, each a 1-D bulk copy (cp.async.bulk; the residual's a second
//   one) completing on the stage's mbarrier: up to 3 x 4 warps x 8 KB per
//   block in flight, which no register budget allows.  LPR lanes share a
//   row (the largest power of two <= 32 that divides the row's vector
//   count), so a 128-wide bf16 row takes 16 lanes and a warp holds two rows
//   side by side; where a lane holds fewer than four vectors of a row, a
//   step is RPI = 4 / VPL rows a lane.  Each lane copies its VPL vectors (a
//   compile-time count) of the stage into registers, raw, and lane 0
//   refills the stage with a later step.  The lane then forms its partial
//   sum of squares, reduces it with xor shuffles over the LPR lanes of its
//   row, scales the values it still holds and stores: one read of the
//   stage, no block barrier.
//   The lane's columns of the scale are loaded once per warp, into
//   registers, and reused for every row the warp handles.  Instantiated
//   where a lane's x, residual and scale fit in 128 registers (the widths
//   64-7168 the models and the JAX tests use); the plan sends any other
//   width to:
// * loop (rmsnorm_loop_kernel): the same lanes and persistent warps with
//   runtime LPR / VPL; a second pass re-reads the row (from L1/L2).
// * scalar (rmsnorm_scalar_kernel): rows that allow no 16-byte access (d
//   not a multiple of 16 bytes, or a misaligned pointer): one warp per row,
//   element by element, two passes.
//
// Stores are plain write-back: the next GEMM reads y at once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;               // threads per block, every path
constexpr int WARPS = BLOCK / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int REG_WORDS = 128;           // registers a lane may hold row data in
constexpr int REG_OTHER = 72;            // and those planned beside them
constexpr int STAGES = 3;                // stages of each warp's ring (rows path)
constexpr int SMEM_PER_SM = 227 * 1024;  // shared memory the rows path plans on
constexpr int SMEM_RESERVED = 2048;      // per block: the runtime's, the barriers

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to() does
}

// elements of x in one 16-byte vector
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

// N values of type S, raw (packed), as loaded: 16 bytes of x, or the scale
// of those 16 bytes' columns (8, 16 or 32 bytes)
template <typename S, int N>
struct alignas(sizeof(S) * N >= 16 ? 16 : sizeof(S) * N) Raw {
  S e[N];
};

template <typename S, int N>
__device__ __forceinline__ Raw<S, N> load_raw(const S* p) {
  constexpr int BYTES = sizeof(S) * N;
  Raw<S, N> r;
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      reinterpret_cast<uint4*>(&r)[i] = reinterpret_cast<const uint4*>(p)[i];
  } else {
    static_assert(BYTES == 8, "scale vector of 8, 16 or 32 bytes");
    *reinterpret_cast<uint2*>(&r) = *reinterpret_cast<const uint2*>(p);
  }
  return r;
}

// Hides r's words from the compiler once s (the row's sum of squares) is
// known, so that the values are converted from the raw words again for the
// store instead of being kept live as f32 from the sum: VPL * N registers
// fewer a lane, and more warps on an SM.
template <typename S, int N>
__device__ __forceinline__ void reload_after(Raw<S, N>& r, float s) {
  static_assert(sizeof(Raw<S, N>) % 4 == 0, "whole 32-bit words");
#pragma unroll
  for (int j = 0; j < (int)(sizeof(Raw<S, N>) / 4); ++j)
    asm volatile("" : "+r"(reinterpret_cast<uint32_t*>(&r)[j]) : "f"(s));
}

template <typename T, int N>
__device__ __forceinline__ void store_raw(T* p, const Raw<T, N>& r) {
  static_assert(sizeof(T) * N == 16, "x vectors are 16 bytes");
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&r);
}

// Shape of one rows-path instance; plan_rows mirrors these numbers.
template <typename T, typename S, int LPR, int VPL, bool RES>
struct RowsShape {
  static constexpr int N = Vec<T>::N;
  static constexpr int RPI = VPL >= 4 ? 1 : 4 / VPL;   // rows a lane holds at once
  static constexpr int GROUPS = 32 / LPR;               // rows side by side in a warp
  static constexpr int RPW = GROUPS * RPI;              // rows per warp and step
  static constexpr int WORDS = RPI * VPL * 4 * (RES ? 2 : 1)
                               + VPL * N * (int)sizeof(S) / 4;
  static constexpr bool FITS = WORDS <= REG_WORDS;
  // one stage of a warp's ring: its step's rows of x (and of the residual)
  static constexpr int STAGE_BYTES = RPW * LPR * VPL * 16;
  static constexpr int SMEM = WARPS * STAGES * STAGE_BYTES * (RES ? 2 : 1);
  // blocks per SM the grid is planned for: by registers (the raw words and
  // 72 for addresses, counters and values in flight to the store: at 48,
  // ptxas spilled the d 2048 bf16 instance), held by __launch_bounds__, and
  // by shared memory
  static constexpr int BY_REGS = 65536 / (BLOCK * (WORDS + REG_OTHER));
  static constexpr int BY_SMEM = SMEM_PER_SM / (SMEM + SMEM_RESERVED);
  static constexpr int MIN_RAW = BY_REGS < BY_SMEM ? BY_REGS : BY_SMEM;
  static constexpr int MIN_BLOCKS = MIN_RAW < 1 ? 1 : (MIN_RAW > 8 ? 8 : MIN_RAW);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT_%=;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}

// A TMA bulk copy of bytes from src (device memory) to dst (this block's
// shared memory), completing on the mbarrier bar, which the caller has
// armed with the bytes to expect.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

template <typename T, typename S, int LPR, int VPL, bool RES>
__global__ void __launch_bounds__(BLOCK, (RowsShape<T, S, LPR, VPL, RES>::MIN_BLOCKS))
rmsnorm_rows_kernel(const T* __restrict__ x, const T* __restrict__ res,
                    const S* __restrict__ scale, T* __restrict__ out,
                    int64_t rows, int d, float eps) {
  using P = RowsShape<T, S, LPR, VPL, RES>;
  constexpr int N = P::N;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[WARPS][STAGES];
  const int wid = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane % LPR;                 // lane within its row
  const int grp = lane / LPR;                 // which of the warp's rows
  const int64_t warp = (int64_t)blockIdx.x * WARPS + wid;
  const int64_t n_warps = (int64_t)gridDim.x * WARPS;
  // this warp's ring: STAGES stages of x, then STAGES of the residual
  unsigned char* ring = smem + (size_t)wid * STAGES * P::STAGE_BYTES * (RES ? 2 : 1);

  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&bars[wid][s])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  // lane 0 asks for step gg's rows (the ragged last step's only) in stage s
  auto fetch = [&](int64_t gg, int s) {
    const int64_t r0 = gg * P::RPW;
    const int64_t n = rows - r0 < P::RPW ? rows - r0 : P::RPW;
    const uint32_t bytes = (uint32_t)(n * d * (int64_t)sizeof(T));
    const uint32_t bar = smem_addr(&bars[wid][s]);
    // the warp's reads of this stage (generic proxy) come before the copy
    // (async proxy) that overwrites it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes * (RES ? 2 : 1)) : "memory");
    bulk_load(ring + s * P::STAGE_BYTES, x + r0 * d, bytes, bar);
    if constexpr (RES)
      bulk_load(ring + (STAGES + s) * P::STAGE_BYTES, res + r0 * d, bytes, bar);
  };

  Raw<S, N> sc[VPL];                          // this lane's columns of scale
#pragma unroll
  for (int k = 0; k < VPL; ++k) sc[k] = load_raw<S, N>(scale + (k * LPR + sub) * N);
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s)
      if ((warp + s * n_warps) * P::RPW < rows) fetch(warp + s * n_warps, s);
  }

  int step = 0;
  for (int64_t g = warp; g * P::RPW < rows; g += n_warps, ++step) {
    const int s = step % STAGES;
    wait_parity(smem_addr(&bars[wid][s]), (step / STAGES) & 1);
    const unsigned char* xs = ring + s * P::STAGE_BYTES;
    const unsigned char* rs = ring + (STAGES + s) * P::STAGE_BYTES;
    Raw<T, N> xv[P::RPI][VPL];
    Raw<T, N> rv[RES ? P::RPI : 1][RES ? VPL : 1];
#pragma unroll
    for (int i = 0; i < P::RPI; ++i) {
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        // row i * GROUPS + grp of the step, vector k * LPR + sub
        const int off = ((i * P::GROUPS + grp) * LPR * VPL + k * LPR + sub) * 16;
        xv[i][k] = *reinterpret_cast<const Raw<T, N>*>(xs + off);
        if constexpr (RES) rv[i][k] = *reinterpret_cast<const Raw<T, N>*>(rs + off);
      }
    }
    __syncwarp();
    if (lane == 0 && (g + STAGES * n_warps) * P::RPW < rows) fetch(g + STAGES * n_warps, s);

    float ss[P::RPI];
#pragma unroll
    for (int i = 0; i < P::RPI; ++i) {
      ss[i] = 0.f;
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
#pragma unroll
        for (int e = 0; e < N; ++e) {
          float v = to_f(xv[i][k].e[e]);
          if constexpr (RES) v += to_f(rv[i][k].e[e]);
          ss[i] += v * v;
        }
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) ss[i] += __shfl_xor_sync(FULL, ss[i], o);
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        reload_after(xv[i][k], ss[i]);
        if constexpr (RES) reload_after(rv[i][k], ss[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < P::RPI; ++i) {
      const int64_t row = g * P::RPW + i * P::GROUPS + grp;
      if (row >= rows) continue;              // the ragged last step
      const float inv = rsqrtf(ss[i] / (float)d + eps);
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        Raw<T, N> y;
#pragma unroll
        for (int e = 0; e < N; ++e) {
          float v = to_f(xv[i][k].e[e]);
          if constexpr (RES) v += to_f(rv[i][k].e[e]);
          y.e[e] = from_f<T>(v * inv * to_f(sc[k].e[e]));
        }
        store_raw(out + row * d + (k * LPR + sub) * N, y);
      }
    }
  }
}

// Any width that is a whole number of 16-byte vectors: runtime lanes per
// row (a power of two) and vectors per lane; the row is read twice.
template <typename T, typename S>
__global__ void __launch_bounds__(BLOCK, 8)
rmsnorm_loop_kernel(const T* __restrict__ x, const T* __restrict__ res,
                    const S* __restrict__ scale, T* __restrict__ out,
                    int64_t rows, int d, float eps, int lpr, int vpl) {
  constexpr int N = Vec<T>::N;
  const int lane = threadIdx.x % 32;
  const int sub = lane % lpr;
  const int groups = 32 / lpr;
  const int64_t warp = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  const int64_t n_warps = (int64_t)gridDim.x * WARPS;

  for (int64_t g = warp; g * groups < rows; g += n_warps) {
    const int64_t row = g * groups + lane / lpr;
    const bool live = row < rows;
    float ss = 0.f;
    if (live) {
      for (int k = 0; k < vpl; ++k) {
        const int64_t off = row * d + (k * lpr + sub) * N;
        const Raw<T, N> xv = load_raw<T, N>(x + off);
        Raw<T, N> rv{};
        if (res != nullptr) rv = load_raw<T, N>(res + off);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float v = to_f(xv.e[e]) + (res != nullptr ? to_f(rv.e[e]) : 0.f);
          ss += v * v;
        }
      }
    }
    for (int o = lpr / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(FULL, ss, o);
    if (!live) continue;
    const float inv = rsqrtf(ss / (float)d + eps);
    for (int k = 0; k < vpl; ++k) {
      const int c = (k * lpr + sub) * N;
      const Raw<T, N> xv = load_raw<T, N>(x + row * d + c);
      Raw<T, N> rv{};
      if (res != nullptr) rv = load_raw<T, N>(res + row * d + c);
      const Raw<S, N> sv = load_raw<S, N>(scale + c);
      Raw<T, N> y;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float v = to_f(xv.e[e]) + (res != nullptr ? to_f(rv.e[e]) : 0.f);
        y.e[e] = from_f<T>(v * inv * to_f(sv.e[e]));
      }
      store_raw(out + row * d + c, y);
    }
  }
}

// Rows that allow no 16-byte access: one warp per row, element by element.
template <typename T, typename S>
__global__ void __launch_bounds__(BLOCK, 8)
rmsnorm_scalar_kernel(const T* __restrict__ x, const T* __restrict__ res,
                      const S* __restrict__ scale, T* __restrict__ out,
                      int64_t rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int64_t warp = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  const int64_t n_warps = (int64_t)gridDim.x * WARPS;
  for (int64_t row = warp; row < rows; row += n_warps) {
    const T* xr = x + row * d;
    const T* rr = res != nullptr ? res + row * d : nullptr;
    float ss = 0.f;
    for (int c = lane; c < d; c += 32) {
      float v = to_f(xr[c]);
      if (rr != nullptr) v += to_f(rr[c]);
      ss += v * v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(FULL, ss, o);
    const float inv = rsqrtf(ss / (float)d + eps);
    for (int c = lane; c < d; c += 32) {
      float v = to_f(xr[c]);
      if (rr != nullptr) v += to_f(rr[c]);
      out[row * d + c] = from_f<T>(v * inv * to_f(scale[c]));
    }
  }
}

struct Args {
  const void* x;
  const void* res;
  const void* scale;
  void* out;
  int64_t rows;
  int d;
  float eps;
  unsigned grid;
  cudaStream_t stream;
};

template <typename T, typename S, int LPR, int VPL, bool RES>
bool try_rows(const Args& a, int lpr, int vpl) {
  if constexpr (RowsShape<T, S, LPR, VPL, RES>::FITS) {
    if (lpr != LPR || vpl != VPL) return false;
    constexpr int smem = RowsShape<T, S, LPR, VPL, RES>::SMEM;
    // set once per process, on the current device: the port drives one card
    static const cudaError_t attr = cudaFuncSetAttribute(
        rmsnorm_rows_kernel<T, S, LPR, VPL, RES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return false;
    rmsnorm_rows_kernel<T, S, LPR, VPL, RES><<<a.grid, BLOCK, smem, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.res),
        static_cast<const S*>(a.scale), static_cast<T*>(a.out), a.rows, a.d,
        a.eps);
    return true;
  } else {
    return false;
  }
}

// The rows path's instances: (LPR, VPL) of the widths 64-7168 that the
// models and the JAX tests use (ops.py:ROW_INSTANCES), each where it fits;
// (16, 9) and (32, 9) are gemma3's d 1152 at bf16 and f32.
template <typename T, typename S, bool RES>
bool launch_rows(const Args& a, int lpr, int vpl) {
  return try_rows<T, S, 16, 1, RES>(a, lpr, vpl) ||
         try_rows<T, S, 32, 1, RES>(a, lpr, vpl) ||
         try_rows<T, S, 32, 2, RES>(a, lpr, vpl) ||
         try_rows<T, S, 32, 4, RES>(a, lpr, vpl) ||
         try_rows<T, S, 32, 8, RES>(a, lpr, vpl) ||
         try_rows<T, S, 16, 9, RES>(a, lpr, vpl) ||
         try_rows<T, S, 32, 9, RES>(a, lpr, vpl) ||
         try_rows<T, S, 32, 14, RES>(a, lpr, vpl) ||
         try_rows<T, S, 32, 16, RES>(a, lpr, vpl) ||
         try_rows<T, S, 32, 28, RES>(a, lpr, vpl);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// path: 0 scalar, 1 loop, 2 rows.  False when the plan names no instance.
template <typename T, typename S>
bool launch(const Args& a, int path, int lpr, int vpl) {
  if (path == 0) {
    rmsnorm_scalar_kernel<T, S><<<a.grid, BLOCK, 0, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.res),
        static_cast<const S*>(a.scale), static_cast<T*>(a.out), a.rows, a.d,
        a.eps);
    return true;
  }
  // the vector paths: the plan's lanes must tile the row exactly, and every
  // pointer take 16-byte (the scale's 8-byte) access
  if (lpr < 1 || lpr > 32 || (lpr & (lpr - 1)) != 0 || vpl < 1 ||
      (int64_t)lpr * vpl * Vec<T>::N != a.d || !aligned16(a.x) ||
      !aligned16(a.out) || (a.res != nullptr && !aligned16(a.res)) ||
      (uintptr_t)a.scale % (sizeof(S) * Vec<T>::N >= 16 ? 16 : 8) != 0)
    return false;
  if (path == 1) {
    rmsnorm_loop_kernel<T, S><<<a.grid, BLOCK, 0, a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const T*>(a.res),
        static_cast<const S*>(a.scale), static_cast<T*>(a.out), a.rows, a.d,
        a.eps, lpr, vpl);
    return true;
  }
  if (path == 2) {
    return a.res != nullptr ? launch_rows<T, S, true>(a, lpr, vpl)
                            : launch_rows<T, S, false>(a, lpr, vpl);
  }
  return false;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  path, lpr, vpl and grid come
// from plan_rows.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for an unsupported dtype pair or a plan that names
// no instance or does not tile the row.
extern "C" int rmsnorm_launch(const void* x, const void* res, const void* scale,
                              void* out, int64_t rows, int d, float eps,
                              int x_dtype, int scale_dtype, int path, int lpr,
                              int vpl, int grid, void* stream) {
  if (rows <= 0 || d <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  const Args a{x, res, scale, out, rows, d, eps, (unsigned)grid,
               static_cast<cudaStream_t>(stream)};
  bool ok = false;
  if (x_dtype == 0 && scale_dtype == 0) {
    ok = launch<float, float>(a, path, lpr, vpl);
  } else if (x_dtype == 0 && scale_dtype == 1) {
    ok = launch<float, __nv_bfloat16>(a, path, lpr, vpl);
  } else if (x_dtype == 1 && scale_dtype == 0) {
    ok = launch<__nv_bfloat16, float>(a, path, lpr, vpl);
  } else if (x_dtype == 1 && scale_dtype == 1) {
    ok = launch<__nv_bfloat16, __nv_bfloat16>(a, path, lpr, vpl);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
