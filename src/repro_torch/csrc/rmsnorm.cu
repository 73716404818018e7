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
// (bytes of x + residual + y + scale) / 3.35 TB/s.
//
// Design: one warp per row for d <= 1024 (four rows per 128-thread block),
// one 256-thread block per row above that.  Each thread streams its part of
// the row with 16-byte vector loads (8 bf16 or 4 f32), accumulates the sum
// of squares in f32, reduces with warp shuffles and, for block rows, one
// shared-memory step; the second pass re-reads the row (now in L1/L2), so
// device memory sees each byte once.  A scalar loop covers rows whose width
// or pointers do not allow 16-byte access.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to() does
}

template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) out[i] = to_f(e[i]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i) e[i] = from_f<T>(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

template <typename T, typename S, int ROW_THREADS, int BLOCK, bool VEC>
__global__ void __launch_bounds__(BLOCK) rmsnorm_kernel(
    const T* __restrict__ x, const T* __restrict__ res,
    const S* __restrict__ scale, T* __restrict__ out, int64_t rows, int d,
    float eps) {
  constexpr int ROWS_PER_BLOCK = BLOCK / ROW_THREADS;
  constexpr int N = Vec<T>::N;
  const int t = threadIdx.x % ROW_THREADS;
  const int64_t row = (int64_t)blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / ROW_THREADS;
  const bool active = row < rows;
  const T* xr = x + row * d;
  const T* rr = res != nullptr ? res + row * d : nullptr;
  T* yr = out + row * d;

  float ss = 0.f;
  if (active) {
    if (VEC) {
      for (int c = t * N; c < d; c += ROW_THREADS * N) {
        float v[N];
        load_vec(xr + c, v);
        if (rr != nullptr) {
          float r[N];
          load_vec(rr + c, r);
#pragma unroll
          for (int i = 0; i < N; ++i) v[i] += r[i];
        }
#pragma unroll
        for (int i = 0; i < N; ++i) ss += v[i] * v[i];
      }
    } else {
      for (int c = t; c < d; c += ROW_THREADS) {
        float v = to_f(xr[c]);
        if (rr != nullptr) v += to_f(rr[c]);
        ss += v * v;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if constexpr (ROW_THREADS > 32) {
    __shared__ float part[ROW_THREADS / 32];
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < ROW_THREADS / 32; ++w) ss += part[w];
  }
  if (!active) return;
  const float inv = rsqrtf(ss / (float)d + eps);

  if (VEC) {
    for (int c = t * N; c < d; c += ROW_THREADS * N) {
      float v[N];
      load_vec(xr + c, v);
      if (rr != nullptr) {
        float r[N];
        load_vec(rr + c, r);
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] += r[i];
      }
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = v[i] * inv * to_f(scale[c + i]);
      store_vec(yr + c, v);
    }
  } else {
    for (int c = t; c < d; c += ROW_THREADS) {
      float v = to_f(xr[c]);
      if (rr != nullptr) v += to_f(rr[c]);
      yr[c] = from_f<T>(v * inv * to_f(scale[c]));
    }
  }
}

template <typename T, typename S, int ROW_THREADS, int BLOCK>
void launch_rows(const void* x, const void* res, const void* scale, void* out,
                 int64_t rows, int d, float eps, bool vec, cudaStream_t stream) {
  constexpr int ROWS_PER_BLOCK = BLOCK / ROW_THREADS;
  const unsigned grid = (unsigned)((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(res);
  const S* sp = static_cast<const S*>(scale);
  T* op = static_cast<T*>(out);
  if (vec) {
    rmsnorm_kernel<T, S, ROW_THREADS, BLOCK, true><<<grid, BLOCK, 0, stream>>>(
        xp, rp, sp, op, rows, d, eps);
  } else {
    rmsnorm_kernel<T, S, ROW_THREADS, BLOCK, false><<<grid, BLOCK, 0, stream>>>(
        xp, rp, sp, op, rows, d, eps);
  }
}

template <typename T, typename S>
void launch(const void* x, const void* res, const void* scale, void* out,
            int64_t rows, int d, float eps, cudaStream_t stream) {
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0) &&
                       (res == nullptr || (uintptr_t)res % 16 == 0);
  const bool vec = aligned && d % Vec<T>::N == 0;
  if (d <= 1024) {
    launch_rows<T, S, 32, 128>(x, res, scale, out, rows, d, eps, vec, stream);
  } else {
    launch_rows<T, S, 256, 256>(x, res, scale, out, rows, d, eps, vec, stream);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for an unsupported dtype pair).
extern "C" int rmsnorm_launch(const void* x, const void* res, const void* scale,
                              void* out, int64_t rows, int d, float eps,
                              int x_dtype, int scale_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (x_dtype == 0 && scale_dtype == 0) {
    launch<float, float>(x, res, scale, out, rows, d, eps, s);
  } else if (x_dtype == 0 && scale_dtype == 1) {
    launch<float, __nv_bfloat16>(x, res, scale, out, rows, d, eps, s);
  } else if (x_dtype == 1 && scale_dtype == 0) {
    launch<__nv_bfloat16, float>(x, res, scale, out, rows, d, eps, s);
  } else if (x_dtype == 1 && scale_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, res, scale, out, rows, d, eps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
