// Chunked SSD (Mamba2) forward scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/kernel.py:ssm_scan_bh
// (Pallas, grid (B, S/Q) with the chunk axis sequential and the f32 state
// [Hb, P, N] carried in VMEM scratch across it; one call per head block).
// Computes, for every (b, SSD head h), the recurrence
//
//     h_t = exp(dt_t * A_h) h_{t-1} + dt_t x_t B_t^T ,   y_t = h_t C_t
//
// from h = 0 in the chunked form, per chunk of Q steps with cum the
// in-chunk cumulative sum of dt * A:
//
//     y     = (C B^T o L) (dt x) + exp(cum) o (C h^T)   L_qk = exp(cum_q - cum_k), k <= q
//     h_out = exp(cum_Q) h_in + (dt x o exp(cum_Q - cum))^T B
//
// Layouts: x and y [B, S, H, P] (x bf16 or f32; y in x's dtype or f32),
// dt [B, S, H] f32, A [H] f32, B and C [B, S, N] in x's dtype.
//
// Bound on this card: bytes.  Each call reads x, dt, B, C once and writes y
// once, for ~Q * (P + N) flops per element of x; the least time is those
// bytes over 3.35 TB/s, where the products run at the bf16 tensor-core
// rate.  This kernel's products are scalar f32 FMAs (~(Q + 2N) FMAs per
// element of x), so it is bound by the FMA rate well before the bytes.
//
// Design: one 256-thread block per (b, h), h fastest so that the blocks of
// one batch row read the same B and C from L2.  The block walks the chunks
// in order (the TPU kernel's sequential grid axis becomes this loop; Hopper
// blocks run in no order) and keeps the f32 state h [P, N] in shared memory
// for the whole sequence.  Per chunk it stages B, C and dt * x as f32 in
// shared memory (rows padded by one word against bank conflicts), forms
// cum with a warp scan, then the masked decay-weighted scores
// W = (C B^T) o L [Q, Q] (exp(cum_q - cum_k) is taken only for k <= q, where
// it is <= 1: above the diagonal it would overflow), y = W (dt x) +
// exp(cum) o (C h^T), and last the state update.  Thread (ty, tx) owns rows
// ty + 16a and columns tx + 16b of each product in registers.  A ragged S
// is exact: steps past S load as dt = 0, x = B = C = 0 (the state is left
// unchanged) and their y is not written.  At B = 1 the 112 SSD heads of
// zamba2-7b fill 112 of the 132 SMs; one block per SM fits (~184 KB of
// shared memory at Q = 128, P = N = 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxP = 64, kMaxN = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ constexpr int smem_floats(int Q, int P, int N) {
  return 2 * Q * (N + 1)   // B, C
         + Q * (P + 1)     // dt * x
         + Q * (Q + 1)     // W
         + P * (N + 1)     // state h
         + 3 * Q + 1;      // cum, exp(cum), exp(total - cum), total
}

template <typename TX, typename TY, int Q>
__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(
    const TX* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const TX* __restrict__ Bm,
    const TX* __restrict__ Cm, TY* __restrict__ y, int S, int H, int P,
    int N) {
  constexpr int QI = Q / 16;   // rows (or keys) per thread in the Q x Q products
  constexpr int PJ = kMaxP / 16, NJ = kMaxN / 16;
  static_assert(Q % 32 == 0 && Q <= 128, "chunk of 32, 64 or 128");

  extern __shared__ __align__(16) float sm[];
  const int NS = N + 1, PS = P + 1, QS = Q + 1;
  float* b_s = sm;                  // [Q][N+1]
  float* c_s = b_s + Q * NS;        // [Q][N+1]
  float* x_s = c_s + Q * NS;        // [Q][P+1]  dt * x
  float* w_s = x_s + Q * PS;        // [Q][Q+1]
  float* h_s = w_s + Q * QS;        // [P][N+1]
  float* cum_s = h_s + P * NS;      // [Q]
  float* ecum_s = cum_s + Q;        // [Q] exp(cum)
  float* dec_s = ecum_s + Q;        // [Q] exp(total - cum)
  float* total_s = dec_s + Q;       // [1]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float a_h = A[h];
  const int pj = P / 16, nj = N / 16;

  for (int i = tid; i < P * NS; i += kThreads) h_s[i] = 0.f;

  const int n_chunks = (S + Q - 1) / Q;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * Q;
    // ---- stage B, C, dt * x and dt * A (zero past S)
    for (int i = tid; i < Q * N; i += kThreads) {
      const int r = i / N, n = i % N, t = t0 + r;
      const size_t g = ((size_t)b * S + t) * N + n;
      b_s[r * NS + n] = t < S ? to_f(Bm[g]) : 0.f;
      c_s[r * NS + n] = t < S ? to_f(Cm[g]) : 0.f;
    }
    for (int i = tid; i < Q * P; i += kThreads) {
      const int r = i / P, p = i % P, t = t0 + r;
      float v = 0.f;
      if (t < S) {
        const size_t row = ((size_t)b * S + t) * H + h;
        v = to_f(x[row * P + p]) * dt[row];
      }
      x_s[r * PS + p] = v;
    }
    if (tid < Q) {
      const int t = t0 + tid;
      cum_s[tid] = t < S ? dt[((size_t)b * S + t) * H + h] * a_h : 0.f;
    }
    __syncthreads();

    // ---- cum = inclusive cumsum of dt * A over the chunk (one warp)
    if (warp == 0) {
      constexpr int PER = Q / 32;
      float run = 0.f, part[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        run += cum_s[lane * PER + i];
        part[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      const float excl = incl - run;
      const float total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const float c = part[i] + excl;
        cum_s[lane * PER + i] = c;
        ecum_s[lane * PER + i] = expf(c);
        dec_s[lane * PER + i] = expf(total - c);
      }
      if (lane == 0) *total_s = total;
    }
    __syncthreads();

    // ---- W[q][k] = (C_q . B_k) * exp(cum_q - cum_k) for k <= q, else 0
    {
      float acc[QI][QI];
#pragma unroll
      for (int a = 0; a < QI; ++a)
#pragma unroll
        for (int c = 0; c < QI; ++c) acc[a][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[QI], bv[QI];
#pragma unroll
        for (int a = 0; a < QI; ++a) cv[a] = c_s[(ty + 16 * a) * NS + n];
#pragma unroll
        for (int c = 0; c < QI; ++c) bv[c] = b_s[(tx + 16 * c) * NS + n];
#pragma unroll
        for (int a = 0; a < QI; ++a)
#pragma unroll
          for (int c = 0; c < QI; ++c) acc[a][c] = fmaf(cv[a], bv[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < QI; ++a) {
        const int qr = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < QI; ++c) {
          const int kc = tx + 16 * c;
          w_s[qr * QS + kc] = kc <= qr ? acc[a][c] * expf(cum_s[qr] - cum_s[kc]) : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y = exp(cum) o (C h^T) + W (dt x): rows ty + 16a, cols tx + 16j
    {
      float acc[QI][PJ];
#pragma unroll
      for (int a = 0; a < QI; ++a)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[a][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[QI], hv[PJ];
#pragma unroll
        for (int a = 0; a < QI; ++a) cv[a] = c_s[(ty + 16 * a) * NS + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) hv[j] = j < pj ? h_s[(tx + 16 * j) * NS + n] : 0.f;
#pragma unroll
        for (int a = 0; a < QI; ++a)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[a][j] = fmaf(cv[a], hv[j], acc[a][j]);
      }
#pragma unroll
      for (int a = 0; a < QI; ++a) {
        const float e = ecum_s[ty + 16 * a];
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[a][j] *= e;
      }
      for (int kc = 0; kc < Q; ++kc) {
        float wv[QI], xv[PJ];
#pragma unroll
        for (int a = 0; a < QI; ++a) wv[a] = w_s[(ty + 16 * a) * QS + kc];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = j < pj ? x_s[kc * PS + tx + 16 * j] : 0.f;
#pragma unroll
        for (int a = 0; a < QI; ++a)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[a][j] = fmaf(wv[a], xv[j], acc[a][j]);
      }
#pragma unroll
      for (int a = 0; a < QI; ++a) {
        const int t = t0 + ty + 16 * a;
        if (t < S) {
          TY* yr = y + (((size_t)b * S + t) * H + h) * P;
#pragma unroll
          for (int j = 0; j < PJ; ++j)
            if (j < pj) yr[tx + 16 * j] = from_f<TY>(acc[a][j]);
        }
      }
    }
    __syncthreads();  // h_s is read above and rewritten below

    // ---- h = exp(total) h + (dt x o exp(total - cum))^T B: rows p, cols n
    {
      const float et = expf(*total_s);
      float acc[PJ][NJ];
#pragma unroll
      for (int a = 0; a < PJ; ++a)
#pragma unroll
        for (int c = 0; c < NJ; ++c)
          acc[a][c] = (a < pj && c < nj) ? h_s[(ty + 16 * a) * NS + tx + 16 * c] * et : 0.f;
      for (int kc = 0; kc < Q; ++kc) {
        const float d = dec_s[kc];
        float xv[PJ], bv[NJ];
#pragma unroll
        for (int a = 0; a < PJ; ++a) xv[a] = a < pj ? x_s[kc * PS + ty + 16 * a] * d : 0.f;
#pragma unroll
        for (int c = 0; c < NJ; ++c) bv[c] = c < nj ? b_s[kc * NS + tx + 16 * c] : 0.f;
#pragma unroll
        for (int a = 0; a < PJ; ++a)
#pragma unroll
          for (int c = 0; c < NJ; ++c) acc[a][c] = fmaf(xv[a], bv[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < PJ; ++a)
#pragma unroll
        for (int c = 0; c < NJ; ++c)
          if (a < pj && c < nj) h_s[(ty + 16 * a) * NS + tx + 16 * c] = acc[a][c];
    }
    __syncthreads();  // the next chunk restages B, C, dt * x and reads h
  }
}

template <typename TX, typename TY, int Q>
int launch_q(const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, void* y, int B, int S, int H, int P, int N,
             cudaStream_t stream) {
  // opt in once for the largest tiles this instance can be given
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssm_scan_kernel<TX, TY, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_floats(Q, kMaxP, kMaxN) * 4);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int smem = smem_floats(Q, P, N) * 4;
  ssm_scan_kernel<TX, TY, Q><<<(unsigned)(B * H), kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const TX*>(Bm),
      static_cast<const TX*>(Cm), static_cast<TY*>(y), S, H, P, N);
  return (int)cudaGetLastError();
}

template <typename TX, typename TY>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, int B, int S, int H, int P, int N, int chunk,
           cudaStream_t stream) {
  switch (chunk) {
    case 32: return launch_q<TX, TY, 32>(x, dt, A, Bm, Cm, y, B, S, H, P, N, stream);
    case 64: return launch_q<TX, TY, 64>(x, dt, A, Bm, Cm, y, B, S, H, P, N, stream);
    case 128: return launch_q<TX, TY, 128>(x, dt, A, Bm, Cm, y, B, S, H, P, N, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for x (and B, C) and for y; the
// (x, y) pairs are (f32, f32), (bf16, bf16) and (bf16, f32).
// P and N are multiples of 16 up to 64; chunk is 32, 64 or 128.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for anything
// else).
extern "C" int ssm_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y, int B,
                               int S, int H, int P, int N, int chunk,
                               int x_dtype, int y_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || P % 16 || P < 16 || P > kMaxP || N % 16 ||
      N < 16 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  if (x_dtype == 0 && y_dtype == 0)
    return launch<float, float>(x, dt, A, Bm, Cm, y, B, S, H, P, N, chunk, s);
  if (x_dtype == 1 && y_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, dt, A, Bm, Cm, y, B, S, H, P, N, chunk, s);
  if (x_dtype == 1 && y_dtype == 0)
    return launch<__nv_bfloat16, float>(x, dt, A, Bm, Cm, y, B, S, H, P, N, chunk, s);
  return (int)cudaErrorInvalidValue;
}
