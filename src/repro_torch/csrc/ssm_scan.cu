// Chunked SSD (Mamba2) forward scan for Hopper (sm_90a), chunk-parallel.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/kernel.py:ssm_scan_bh
// (Pallas, grid (B, S/Q) with the chunk axis sequential and the f32 state
// [Hb, P, N] carried in VMEM scratch across it; one call per head block).
// Computes, for every (b, SSD head h), the recurrence
//
//     h_t = exp(dt_t * A_h) h_{t-1} + dt_t x_t B_t^T ,   y_t = h_t C_t
//
// from h = 0 in the chunked form, per chunk of Q steps with cum the
// in-chunk cumulative sum of dt * A and total = cum_Q:
//
//     y     = W x + exp(cum) o (C h_in^T)     W_qk = (C_q . B_k) exp(cum_q - cum_k) dt_k, k <= q
//     h_out = exp(total) h_in + (x o dt exp(total - cum))^T B
//
// Layouts: x and y [B, S, H, P] (x bf16 or f32; y in x's dtype or f32),
// dt [B, S, H] f32, A [H] f32, B and C [B, S, N] in x's dtype.  A ragged S
// is exact: steps past S load as dt = 0, x = B = C = 0 (the state is left
// unchanged) and their y is not written.
//
// Bound on this card: bytes.  A call reads x, dt, B, C once and writes y
// once; the products are ~Q (P + N) flops per element of x, a fifth of the
// byte time even at the bf16 tensor-core peak.
//
// Design: the chunks are split into groups of G consecutive chunks
// (plan_groups in kernels/ssm_scan/ops.py picks G from the shape and the
// SM count), and one call runs up to three launches, all on the caller's
// stream, with the f32 state scratch [B, n_groups - 1, H, P, N] plus the
// group totals [B, n_groups - 1, H] allocated by the wrapper:
//
//   1. ssm_scan_state_kernel, one block per (b, group but the last, head):
//      walks its group's chunks from h = 0 with the state update only and
//      writes the group's end state and total (sum of dt * A).
//   2. ssm_scan_pass_kernel, one thread per (b, head, 4 state elements):
//      in order over the groups, h = exp(total_g) h + s_g, and overwrites
//      slot g with h, the state entering group g + 1 (f32, elementwise).
//   3. ssm_scan_output_kernel, one block per (b, group, head): starts from
//      the state entering its group (0 for the first) and walks the group's
//      chunks, writing y and carrying the state on chip between them.
//
// With one group (short sequences, or few heads and chunks) only launch 3
// runs.  Blocks index (b, group, head) with the head fastest, so the blocks
// of one group read the same B and C from L2.  The state traffic is the
// scratch written, read and rewritten, read again: 4 * B * (n_groups - 1)
// * H * P * N * 4 bytes, 1/G of what one state per chunk would cost.
//
// bf16 x (namespace tc): tensor cores through mma.sync.m16n8k16 (bf16 in,
// f32 accumulate), operands from shared memory by ldmatrix; 256 threads, 8
// warps.  Each chunk's x, B and dt are staged by cp.async (16-byte copies,
// zero-filled past S) into a double buffer, so the next chunk loads while
// this one computes; C has one buffer (each warp holds its rows of C in
// registers from the start of a chunk, and the next chunk's C loads after
// that), so two output blocks fit on an SM.  Rows are padded by 8 bf16 so
// that ldmatrix is free of bank conflicts.  y: warp w owns a 16-row tile of
// the chunk (and a share of the P columns when Q < 128), the row tiles
// spread so that the four schedulers get equal work below the diagonal:
// C h_in^T first (scaled by exp(cum) per row), then, for every 16-key tile
// at or below the diagonal, the scores C B^T by mma, W formed in registers
// from the accumulators (tiles above the diagonal are never computed) and
// W x by mma with x read through ldmatrix.trans.  State: each warp owns two
// 16 x 16 tiles of h [P, N] that share their rows, in f32 accumulators for
// the whole group; the update reads x transposed (ldmatrix.trans), scales
// it by dt exp(total - cum) in registers and multiplies by B.  The kernel
// is bound by latency (a warp issues in order, and a product waits ~30
// cycles on the one before it into the same accumulator), so the hi
// products of all accumulators issue before the lo ones, and P = N = 64
// is an instance of its own (FULL) whose tile loops unroll without
// branches.  One head per block: C B^T (about 1/7 of the products) is
// computed per head rather than shared across a block of heads, which
// would need several heads' states on chip at once.
//
// Rounding points of the bf16 path.  x, B and C are bf16 already and enter
// the products exactly.  Three operands are f32 values that a bf16 mma
// would round: W (as flash rounds P), h_in in C h_in^T, and x dt
// exp(total - cum) in the update (its error would be carried forward by
// the state).  Each is split into a bf16 pair hi + lo (lo = the rounded
// remainder), and each product runs twice, so every operand keeps ~16
// mantissa bits (relative error ~2^-17) and y stays within the f32-output
// tolerance (2e-4) of the all-f32 plain version.  The flops allow it: the
// doubled products are still under the byte time at the tensor-core rate.
//
// f32 x (namespace scalar): the same three launches with f32 FMAs (mma has
// no f32 inputs, and TF32 would break the f32 tolerance); per (b, group,
// head) a scalar chunk body: B, C, dt * x staged as f32 in shared memory,
// thread (ty, tx) owning rows ty + 16a and columns tx + 16b of each
// product, the state [P, N] in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 64, kMaxN = 64;

// The block's work item (b, group, head), head fastest.
struct Item {
  int b, g, h;
};
__device__ __forceinline__ Item item_of(int H, int n_groups) {
  const int i = blockIdx.x;
  return {i / (H * n_groups), (i / H) % n_groups, i % H};
}

// Where the state of (b, slot, h) lies in the scratch, in floats.
__device__ __forceinline__ size_t state_row(int b, int slot, int h, int H, int slots) {
  return ((size_t)b * slots + slot) * H + h;
}

// ---------------------------------------------------------------- scalar (f32)
namespace scalar {

__host__ __device__ constexpr int smem_floats(int Q, int P, int N) {
  return 2 * Q * (N + 1)   // B, C
         + Q * (P + 1)     // dt * x
         + Q * (Q + 1)     // W
         + P * (N + 1)     // state h
         + 3 * Q + 1;      // cum, exp(cum), exp(total - cum), total
}

template <int Q, bool EMIT_Y>
__device__ __forceinline__ void body(float* sm, const float* __restrict__ x,
                                     const float* __restrict__ dt,
                                     const float* __restrict__ A,
                                     const float* __restrict__ Bm,
                                     const float* __restrict__ Cm, float* __restrict__ y,
                                     float* __restrict__ state, float* __restrict__ totals,
                                     int S, int H, int P, int N, int G, int n_groups,
                                     int slots) {
  constexpr int QI = Q / 16;   // rows (or keys) per thread in the Q x Q products
  constexpr int PJ = kMaxP / 16, NJ = kMaxN / 16;
  static_assert(Q % 32 == 0 && Q <= 128, "chunk of 32, 64 or 128");

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
  const Item it = item_of(H, n_groups);
  const int b = it.b, h = it.h;
  const float a_h = A[h];
  const int pj = P / 16, nj = N / 16;
  const int n_chunks = (S + Q - 1) / Q;
  const int c0 = it.g * G, c1 = min(c0 + G, n_chunks);
  const size_t PN = (size_t)P * N;

  const float* h_in =
      EMIT_Y && it.g > 0 ? state + state_row(b, it.g - 1, h, H, slots) * PN : nullptr;
  for (int i = tid; i < P * N; i += kThreads) h_s[(i / N) * NS + i % N] = h_in ? h_in[i] : 0.f;
  float total_run = 0.f;

  for (int ch = c0; ch < c1; ++ch) {
    const int t0 = ch * Q;
    // ---- stage B, C, dt * x and dt * A (zero past S)
    for (int i = tid; i < Q * N; i += kThreads) {
      const int r = i / N, n = i % N, t = t0 + r;
      const size_t g = ((size_t)b * S + t) * N + n;
      b_s[r * NS + n] = t < S ? Bm[g] : 0.f;
      if (EMIT_Y) c_s[r * NS + n] = t < S ? Cm[g] : 0.f;
    }
    for (int i = tid; i < Q * P; i += kThreads) {
      const int r = i / P, p = i % P, t = t0 + r;
      float v = 0.f;
      if (t < S) {
        const size_t row = ((size_t)b * S + t) * H + h;
        v = x[row * P + p] * dt[row];
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
    total_run += *total_s;
    const bool last = ch + 1 == c1;

    if constexpr (EMIT_Y) {
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
          float* yr = y + (((size_t)b * S + t) * H + h) * P;
#pragma unroll
          for (int j = 0; j < PJ; ++j)
            if (j < pj) yr[tx + 16 * j] = acc[a][j];
        }
      }
    }

    // ---- h = exp(total) h + (dt x o exp(total - cum))^T B: rows p, cols n
    if (!EMIT_Y || !last) {
      if (EMIT_Y) __syncthreads();  // h_s was read above
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

  if constexpr (!EMIT_Y) {
    float* out = state + state_row(b, it.g, h, H, slots) * PN;
    for (int i = tid; i < P * N; i += kThreads) out[i] = h_s[(i / N) * NS + i % N];
    if (tid == 0) totals[state_row(b, it.g, h, H, slots)] = total_run;
  }
}

}  // namespace scalar

// ---------------------------------------------------------------- tc (bf16)
namespace tc {

constexpr int kPad = 8;  // bf16 of padding per shared row: ldmatrix without bank conflicts

// Byte offsets in dynamic shared memory.  Per stage (two stages): x [Q][P+8],
// B [Q][N+8] (bf16), dt [Q] (f32).  Then C [Q][N+8] (one buffer: each warp
// holds its rows of C in registers from the start of a chunk, so the next
// chunk's C loads over this one's products), h_in as bf16 hi and lo
// [P][N+8] each, and cum, exp(cum), dt exp(total - cum) [Q] and total (f32).
// The state launch needs neither C nor h_in.  At Q = 128, P = N = 64 the
// output launch takes 113,680 bytes, so two of its blocks fit on an SM.
struct Layout {
  int xs, ns;                          // row strides of x and of B / C, in bf16
  int b, dt, stage;                    // offsets in a stage; the stage's size
  int c, hh, hl, cum, ecum, dec, total, bytes;
};

__host__ __device__ inline Layout layout(int Q, int P, int N, bool full) {
  Layout L;
  L.xs = P + kPad;
  L.ns = N + kPad;
  L.b = Q * L.xs * 2;
  L.dt = L.b + Q * L.ns * 2;
  L.stage = L.dt + Q * 4;
  L.c = 2 * L.stage;
  L.hh = L.c + (full ? Q * L.ns * 2 : 0);
  L.hl = L.hh + (full ? P * L.ns * 2 : 0);
  L.cum = L.hl + (full ? P * L.ns * 2 : 0);
  L.ecum = L.cum + Q * 4;
  L.dec = L.ecum + Q * 4;
  L.total = L.dec + Q * 4;
  L.bytes = L.total + 16;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b: a 16 x 16 (row), b 16 x 8 (col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}
// (a, b) as the bf16 pairs hi and lo with a ~= hi.x + lo.x, b ~= hi.y + lo.y
__device__ __forceinline__ void split(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(a - __low2float(h), b - __high2float(h)));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// FULL: P = N = 64 (zamba2's heads) as compile-time constants, so that every
// loop over the state and column tiles unrolls without a branch.
template <typename TY, int Q, bool EMIT_Y, bool FULL>
__device__ __forceinline__ void body(unsigned char* sm, const __nv_bfloat16* __restrict__ x,
                                     const float* __restrict__ dt,
                                     const float* __restrict__ A,
                                     const __nv_bfloat16* __restrict__ Bm,
                                     const __nv_bfloat16* __restrict__ Cm,
                                     TY* __restrict__ y, float* __restrict__ state,
                                     float* __restrict__ totals, int S, int H, int P, int N,
                                     int G, int n_groups, int slots) {
  static_assert(Q % 32 == 0 && Q <= 128, "chunk of 32, 64 or 128");
  constexpr int NRT = Q / 16;                 // 16-row tiles of a chunk
  constexpr int NCG = kWarps / NRT;           // warps sharing one row tile of y
  constexpr int kMaxPP = kMaxP / 16;          // 16-column pairs of y per warp, at most
  constexpr int kMaxKN = kMaxN / 16;          // 16-deep steps over N
  constexpr int kMaxST = (kMaxP / 16) * (kMaxN / 16) / kWarps;  // state tiles per warp
  static_assert(NRT * NCG == kWarps, "warps tile the chunk");
  if (FULL) {
    P = kMaxP;
    N = kMaxN;
  }

  const Layout L = layout(Q, P, N, EMIT_Y);
  const uint32_t base = smem_u32(sm);
  float* cum_s = reinterpret_cast<float*>(sm + L.cum);
  float* ecum_s = reinterpret_cast<float*>(sm + L.ecum);
  float* dec_s = reinterpret_cast<float*>(sm + L.dec);
  float* total_s = reinterpret_cast<float*>(sm + L.total);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row, column pair
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: row in matrix, matrix
  const Item it = item_of(H, n_groups);
  const float a_h = A[it.h];
  const int n_chunks = (S + Q - 1) / Q;
  const int c0 = it.g * G, c1 = min(c0 + G, n_chunks);
  const size_t PN = (size_t)P * N;
  const int np = P / 16, nn = N / 16;
  const int n_st = np * nn;

  const int nv = N / 8;  // 16-byte pieces per row of B and C
  // one cp.async group: x, B and dt of chunk ch into a stage
  auto load = [&](int stage, int ch) {
    const int t0 = ch * Q;
    const uint32_t s0 = base + stage * L.stage;
    const int xv = P / 8;
    for (int i = tid; i < Q * xv; i += kThreads) {
      const int r = i / xv, v = i % xv, t = t0 + r;
      const bool ok = t < S;
      const __nv_bfloat16* src = x + (((size_t)it.b * S + (ok ? t : 0)) * H + it.h) * P + v * 8;
      cp_async16(s0 + (r * L.xs + v * 8) * 2, src, ok);
    }
    for (int i = tid; i < Q * nv; i += kThreads) {
      const int r = i / nv, v = i % nv, t = t0 + r;
      const bool ok = t < S;
      cp_async16(s0 + L.b + (r * L.ns + v * 8) * 2,
                 Bm + ((size_t)it.b * S + (ok ? t : 0)) * N + v * 8, ok);
    }
    for (int i = tid; i < Q; i += kThreads) {
      const int t = t0 + i;
      const bool ok = t < S;
      cp_async4(s0 + L.dt + i * 4, dt + ((size_t)it.b * S + (ok ? t : 0)) * H + it.h, ok);
    }
    cp_async_commit();
  };
  // one cp.async group: C of chunk ch
  auto load_c = [&](int ch) {
    const int t0 = ch * Q;
    for (int i = tid; i < Q * nv; i += kThreads) {
      const int r = i / nv, v = i % nv, t = t0 + r;
      const bool ok = t < S;
      cp_async16(base + L.c + (r * L.ns + v * 8) * 2,
                 Cm + ((size_t)it.b * S + (ok ? t : 0)) * N + v * 8, ok);
    }
    cp_async_commit();
  };

  // the state [P, N] in f32 accumulators: tile i = kMaxST * warp + j of the
  // (P / 16) x (N / 16) grid, two 16 x 8 fragments each.  When N / 16 is
  // even a warp's tiles share their 16 rows of P, and with them the scaled
  // x of the update.
  float hacc[kMaxST][2][4];
#pragma unroll
  for (int j = 0; j < kMaxST; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int c = 0; c < 4; ++c) hacc[j][e][c] = 0.f;

  // h as bf16 hi + lo into shared memory, the B operand of C h^T
  auto write_h = [&]() {
#pragma unroll
    for (int j = 0; j < kMaxST; ++j) {
      const int i = kMaxST * warp + j;
      if (i < n_st) {
        const int p0 = 16 * (i / nn) + gq, nb = 16 * (i % nn) + 2 * tq;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = nb + 8 * e;
          uint32_t hi, lo;
          split(hacc[j][e][0], hacc[j][e][1], hi, lo);
          *reinterpret_cast<uint32_t*>(sm + L.hh + (p0 * L.ns + n) * 2) = hi;
          *reinterpret_cast<uint32_t*>(sm + L.hl + (p0 * L.ns + n) * 2) = lo;
          split(hacc[j][e][2], hacc[j][e][3], hi, lo);
          *reinterpret_cast<uint32_t*>(sm + L.hh + ((p0 + 8) * L.ns + n) * 2) = hi;
          *reinterpret_cast<uint32_t*>(sm + L.hl + ((p0 + 8) * L.ns + n) * 2) = lo;
        }
      }
    }
  };

  // the first chunk's loads go out before the entering state is read
  load(0, c0);
  if (EMIT_Y) load_c(c0);
  bool have_h = false;
  if (EMIT_Y && it.g > 0) {
    const float* hin = state + state_row(it.b, it.g - 1, it.h, H, slots) * PN;
#pragma unroll
    for (int j = 0; j < kMaxST; ++j) {
      const int i = kMaxST * warp + j;
      if (i < n_st) {
        const int p0 = 16 * (i / nn) + gq, nb = 16 * (i % nn) + 2 * tq;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 v0 = *reinterpret_cast<const float2*>(hin + p0 * N + nb + 8 * e);
          const float2 v1 = *reinterpret_cast<const float2*>(hin + (p0 + 8) * N + nb + 8 * e);
          hacc[j][e][0] = v0.x;
          hacc[j][e][1] = v0.y;
          hacc[j][e][2] = v1.x;
          hacc[j][e][3] = v1.y;
        }
      }
    }
    write_h();  // read after the first barrier below
    have_h = true;
  }

  // y: warp w owns 16-row tile rt of the chunk (and column group cg when
  // Q < 128).  The warps w and w + 4 share a scheduler, so the upper four
  // take the row tiles in reverse: each scheduler then has the same number
  // of key tiles below the diagonal (9 at Q = 128).
  const int sp = warp & 3, hi_half = warp >> 2;
  const int rt = (hi_half ? NRT - 1 - sp % NRT : sp % NRT);
  const int cg = NCG == 1 ? 0 : 2 * (sp / NRT) + hi_half;
  uint32_t cfr[kMaxKN][4];  // this warp's 16 rows of C, the A operand

  // cp.async groups in issue order: [x B dt of c0] [C of c0], then per
  // chunk [x B dt of the next] [C of the next] (the C group once every
  // warp holds this chunk's C), so "all but the newest group" is always
  // this chunk's data
  float total_run = 0.f;
  for (int ch = c0, i = 0; ch < c1; ++ch, ++i) {
    const int st = i & 1;
    if (ch + 1 < c1)
      load(st ^ 1, ch + 1);  // the next chunk loads while this one computes
    else
      cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t sx = base + st * L.stage, sb = sx + L.b;
    const float* dt_s = reinterpret_cast<const float*>(sm + st * L.stage + L.dt);
    if (EMIT_Y) {
#pragma unroll
      for (int kk = 0; kk < kMaxKN; ++kk)
        if (kk < nn)
          ldsm(cfr[kk], base + L.c + ((16 * rt + (lane & 15)) * L.ns + 16 * kk + 8 * (lane >> 4)) * 2);
    }

    // ---- cum = inclusive cumsum of dt * A over the chunk (one warp)
    if (warp == 0) {
      constexpr int PER = Q / 32;
      float run = 0.f, part[PER];
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        run += dt_s[lane * PER + k] * a_h;
        part[k] = run;
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
      for (int k = 0; k < PER; ++k) {
        const int q = lane * PER + k;
        const float c = part[k] + excl;
        cum_s[q] = c;
        ecum_s[q] = expf(c);
        dec_s[q] = dt_s[q] * expf(total - c);
      }
      if (lane == 0) *total_s = total;
    }
    __syncthreads();
    total_run += *total_s;
    const bool last = ch + 1 == c1;
    if (EMIT_Y) {  // every warp holds its C: the next chunk's C may land
      if (!last)
        load_c(ch + 1);
      else
        cp_async_commit();
    }

    if constexpr (EMIT_Y) {
      const int ppg = (np + NCG - 1) / NCG, p_lo = cg * ppg;
      const int n_pp = FULL ? ppg : max(0, min(np - p_lo, ppg));  // column pairs here
      const int q0 = 16 * rt + gq, q1 = q0 + 8;
      float acc[kMaxPP][2][4];
#pragma unroll
      for (int j = 0; j < kMaxPP; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[j][e][c] = 0.f;

      // ---- exp(cum) o (C h_in^T), h_in as hi + lo.  The products of one
      // accumulator are issued apart (all hi, then all lo), so that none
      // waits on the one before it.
      if (have_h) {
#pragma unroll
        for (int kk = 0; kk < kMaxKN; ++kk) {
          if (kk >= nn) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int jj = 0; jj < kMaxPP; ++jj) {
              if (jj >= n_pp) continue;
              const int off =
                  ((16 * (p_lo + jj) + lr + 8 * (lm >> 1)) * L.ns + 16 * kk + 8 * (lm & 1)) * 2;
              uint32_t r[4];
              ldsm(r, base + (half ? L.hl : L.hh) + off);
              mma(acc[jj][0], cfr[kk], r[0], r[1]);
              mma(acc[jj][1], cfr[kk], r[2], r[3]);
            }
          }
        }
        const float e0 = ecum_s[q0], e1 = ecum_s[q1];
#pragma unroll
        for (int jj = 0; jj < kMaxPP; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            acc[jj][e][0] *= e0;
            acc[jj][e][1] *= e0;
            acc[jj][e][2] *= e1;
            acc[jj][e][3] *= e1;
          }
      }

      // ---- W x over the key tiles at or below the diagonal, W as hi + lo
      const float cq0 = cum_s[q0], cq1 = cum_s[q1];
      for (int kt = 0; kt <= rt; ++kt) {
        // scores C B^T
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < kMaxKN; ++kk) {
          if (kk >= nn) continue;
          uint32_t r[4];
          ldsm(r, sb + ((16 * kt + lr + 8 * (lm >> 1)) * L.ns + 16 * kk + 8 * (lm & 1)) * 2);
          mma(s[0], cfr[kk], r[0], r[1]);
          mma(s[1], cfr[kk], r[2], r[3]);
        }
        uint32_t whi[4], wlo[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 16 * kt + 8 * e + 2 * tq;
          const float ck0 = cum_s[k], ck1 = cum_s[k + 1];
          const float d0 = dt_s[k], d1 = dt_s[k + 1];
          const float* sv = s[e];
          // exp(cum_q - cum_k) <= 1 for k <= q; above the diagonal it is not taken
          const float w00 = k <= q0 ? sv[0] * __expf(fminf(cq0 - ck0, 0.f)) * d0 : 0.f;
          const float w01 = k + 1 <= q0 ? sv[1] * __expf(fminf(cq0 - ck1, 0.f)) * d1 : 0.f;
          const float w10 = k <= q1 ? sv[2] * __expf(fminf(cq1 - ck0, 0.f)) * d0 : 0.f;
          const float w11 = k + 1 <= q1 ? sv[3] * __expf(fminf(cq1 - ck1, 0.f)) * d1 : 0.f;
          split(w00, w01, whi[2 * e], wlo[2 * e]);
          split(w10, w11, whi[2 * e + 1], wlo[2 * e + 1]);
        }
        // x's B fragments, read once for the hi and once for the lo products
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int jj = 0; jj < kMaxPP; ++jj) {
            if (jj >= n_pp) continue;
            uint32_t r[4];
            ldsm_t(r, sx + ((16 * kt + lr + 8 * (lm & 1)) * L.xs + 16 * (p_lo + jj) + 8 * (lm >> 1)) * 2);
            mma(acc[jj][0], half ? wlo : whi, r[0], r[1]);
            mma(acc[jj][1], half ? wlo : whi, r[2], r[3]);
          }
        }
      }

      // ---- y rows q0 and q1 of this chunk
      const int t_0 = ch * Q + q0, t_1 = t_0 + 8;
      TY* y0 = y + (((size_t)it.b * S + t_0) * H + it.h) * P;
      TY* y1 = y + (((size_t)it.b * S + t_1) * H + it.h) * P;
#pragma unroll
      for (int jj = 0; jj < kMaxPP; ++jj) {
        if (jj >= n_pp) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 16 * (p_lo + jj) + 8 * e + 2 * tq;
          if (t_0 < S) store2(y0 + col, acc[jj][e][0], acc[jj][e][1]);
          if (t_1 < S) store2(y1 + col, acc[jj][e][2], acc[jj][e][3]);
        }
      }
    }

    // ---- h = exp(total) h + (x o dt exp(total - cum))^T B, the scaled x as
    // hi + lo; per 16-step slice, all tiles' hi products, then all lo ones
    if (!EMIT_Y || !last) {
      const float et = expf(*total_s);
#pragma unroll
      for (int j = 0; j < kMaxST; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int c = 0; c < 4; ++c) hacc[j][e][c] *= et;
#pragma unroll
      for (int kt = 0; kt < NRT; ++kt) {
        const int k = 16 * kt + 2 * tq;
        const float d0 = dec_s[k], d1 = dec_s[k + 1], d2 = dec_s[k + 8], d3 = dec_s[k + 9];
        uint32_t ahi[kMaxST][4], alo[kMaxST][4], rb[kMaxST][4];
#pragma unroll
        for (int j = 0; j < kMaxST; ++j) {
          const int ti = kMaxST * warp + j;
          if (ti >= n_st) continue;
          const int pr = ti / nn, nq = ti % nn;
          ldsm_t(rb[j], sb + ((16 * kt + lr + 8 * (lm & 1)) * L.ns + 16 * nq + 8 * (lm >> 1)) * 2);
          if (j > 0 && nn % kMaxST == 0) {  // same rows as tile 0: same scaled x
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              ahi[j][c] = ahi[0][c];
              alo[j][c] = alo[0][c];
            }
            continue;
          }
          uint32_t a[4];
          ldsm_t(a, sx + ((16 * kt + lr + 8 * (lm >> 1)) * L.xs + 16 * pr + 8 * (lm & 1)) * 2);
          float2 v = unpack(a[0]);
          split(v.x * d0, v.y * d1, ahi[j][0], alo[j][0]);
          v = unpack(a[1]);
          split(v.x * d0, v.y * d1, ahi[j][1], alo[j][1]);
          v = unpack(a[2]);
          split(v.x * d2, v.y * d3, ahi[j][2], alo[j][2]);
          v = unpack(a[3]);
          split(v.x * d2, v.y * d3, ahi[j][3], alo[j][3]);
        }
#pragma unroll
        for (int j = 0; j < kMaxST; ++j) {
          if (kMaxST * warp + j >= n_st) continue;
          mma(hacc[j][0], ahi[j], rb[j][0], rb[j][1]);
          mma(hacc[j][1], ahi[j], rb[j][2], rb[j][3]);
        }
#pragma unroll
        for (int j = 0; j < kMaxST; ++j) {
          if (kMaxST * warp + j >= n_st) continue;
          mma(hacc[j][0], alo[j], rb[j][0], rb[j][1]);
          mma(hacc[j][1], alo[j], rb[j][2], rb[j][3]);
        }
      }
      if (EMIT_Y) {
        __syncthreads();  // every warp is done reading h_in
        write_h();
        have_h = true;
      }
    }
    __syncthreads();  // the next iteration reloads this stage
  }

  if constexpr (!EMIT_Y) {
    const size_t row = state_row(it.b, it.g, it.h, H, slots);
    float* out = state + row * PN;
#pragma unroll
    for (int j = 0; j < kMaxST; ++j) {
      const int i = kMaxST * warp + j;
      if (i < n_st) {
        const int p0 = 16 * (i / nn) + gq, nb = 16 * (i % nn) + 2 * tq;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          *reinterpret_cast<float2*>(out + p0 * N + nb + 8 * e) =
              make_float2(hacc[j][e][0], hacc[j][e][1]);
          *reinterpret_cast<float2*>(out + (p0 + 8) * N + nb + 8 * e) =
              make_float2(hacc[j][e][2], hacc[j][e][3]);
        }
      }
    }
    if (tid == 0) totals[row] = total_run;
  }
}

}  // namespace tc

template <typename TX>
constexpr bool kTensorCores = std::is_same<TX, __nv_bfloat16>::value;

template <typename TX, int Q>
int smem_bytes(int P, int N, bool full) {
  if constexpr (kTensorCores<TX>)
    return tc::layout(Q, P, N, full).bytes;
  else
    return scalar::smem_floats(Q, P, N) * 4;
}

// Phase 1: the end state (from zero) and the total of every group but the last.
template <typename TX, int Q, bool FULL>
__global__ void __launch_bounds__(kThreads, 1)
    ssm_scan_state_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                          const float* __restrict__ A, const TX* __restrict__ Bm,
                          float* __restrict__ state, float* __restrict__ totals, int S,
                          int H, int P, int N, int G, int slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (kTensorCores<TX>)
    tc::body<float, Q, false, FULL>(smem, x, dt, A, Bm, nullptr, nullptr, state, totals, S,
                                    H, P, N, G, slots, slots);
  else
    scalar::body<Q, false>(reinterpret_cast<float*>(smem), x, dt, A, Bm, nullptr,
                                  nullptr, state, totals, S, H, P, N, G, slots, slots);
}

// Phase 2: the state entering each group, in place of the group-end states.
__global__ void __launch_bounds__(256)
    ssm_scan_pass_kernel(float* __restrict__ state, const float* __restrict__ totals, int H,
                         int PN4, int slots, int n4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const int e = i % PN4, bh = i / PN4, h = bh % H, b = bh / H;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < slots; ++j) {
    const size_t row = state_row(b, j, h, H, slots);
    float4* p = reinterpret_cast<float4*>(state) + row * PN4 + e;
    const float et = expf(totals[row]);
    const float4 s = *p;
    acc = make_float4(fmaf(et, acc.x, s.x), fmaf(et, acc.y, s.y), fmaf(et, acc.z, s.z),
                      fmaf(et, acc.w, s.w));
    *p = acc;
  }
}

// Phase 3: y of every group from the state entering it.  Two bf16 blocks
// share an SM (at most 128 registers and 113 KB of shared memory each).
template <typename TX, typename TY, int Q, bool FULL>
__global__ void __launch_bounds__(kThreads, kTensorCores<TX> ? 2 : 1)
    ssm_scan_output_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ A, const TX* __restrict__ Bm,
                           const TX* __restrict__ Cm, TY* __restrict__ y,
                           float* __restrict__ state, int S, int H, int P, int N, int G,
                           int n_groups, int slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (kTensorCores<TX>)
    tc::body<TY, Q, true, FULL>(smem, x, dt, A, Bm, Cm, y, state, nullptr, S, H, P, N, G,
                                n_groups, slots);
  else
    scalar::body<Q, true>(reinterpret_cast<float*>(smem), x, dt, A, Bm, Cm, y, state,
                              nullptr, S, H, P, N, G, n_groups, slots);
}

template <typename TX, typename TY, int Q, bool FULL>
int launch_q(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
             void* y, void* scratch, int B, int S, int H, int P, int N, int G,
             cudaStream_t stream) {
  // opt in once for the largest tiles this instance can be given
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(ssm_scan_state_kernel<TX, Q, FULL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<TX, Q>(kMaxP, kMaxN, false));
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(ssm_scan_output_kernel<TX, TY, Q, FULL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<TX, Q>(kMaxP, kMaxN, true));
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int n_chunks = (S + Q - 1) / Q;
  const int n_groups = (n_chunks + G - 1) / G, slots = n_groups - 1;
  const TX* xt = static_cast<const TX*>(x);
  const TX* bt = static_cast<const TX*>(Bm);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  float* state = static_cast<float*>(scratch);
  if (slots > 0) {
    if (state == nullptr) return (int)cudaErrorInvalidValue;
    float* totals = state + (size_t)B * slots * H * P * N;
    ssm_scan_state_kernel<TX, Q, FULL><<<(unsigned)(B * slots * H), kThreads,
                                         smem_bytes<TX, Q>(P, N, false), stream>>>(
        xt, dtf, af, bt, state, totals, S, H, P, N, G, slots);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int n4 = B * H * P * N / 4;
    ssm_scan_pass_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
        state, totals, H, P * N / 4, slots, n4);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  ssm_scan_output_kernel<TX, TY, Q, FULL><<<(unsigned)(B * n_groups * H), kThreads,
                                            smem_bytes<TX, Q>(P, N, true), stream>>>(
      xt, dtf, af, bt, static_cast<const TX*>(Cm), static_cast<TY*>(y), state, S, H, P, N,
      G, n_groups, slots);
  return (int)cudaGetLastError();
}

template <typename TX, typename TY, int Q>
int launch_p(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
             void* y, void* scratch, int B, int S, int H, int P, int N, int G,
             cudaStream_t stream) {
  if constexpr (kTensorCores<TX>)
    if (P == kMaxP && N == kMaxN)
      return launch_q<TX, TY, Q, true>(x, dt, A, Bm, Cm, y, scratch, B, S, H, P, N, G, stream);
  return launch_q<TX, TY, Q, false>(x, dt, A, Bm, Cm, y, scratch, B, S, H, P, N, G, stream);
}

template <typename TX, typename TY>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           void* y, void* scratch, int B, int S, int H, int P, int N, int chunk, int G,
           cudaStream_t stream) {
  switch (chunk) {
    case 32: return launch_p<TX, TY, 32>(x, dt, A, Bm, Cm, y, scratch, B, S, H, P, N, G, stream);
    case 64: return launch_p<TX, TY, 64>(x, dt, A, Bm, Cm, y, scratch, B, S, H, P, N, G, stream);
    case 128: return launch_p<TX, TY, 128>(x, dt, A, Bm, Cm, y, scratch, B, S, H, P, N, G, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for x (and B, C) and for y; the
// (x, y) pairs are (f32, f32), (bf16, bf16) and (bf16, f32).  P and N are
// multiples of 16 up to 64; chunk is 32, 64 or 128; groups (G) >= 1 chunks
// per group.  scratch holds B * (n_groups - 1) * H * (P * N + 1) floats
// (null when there is one group).  x, B and C are 16-byte aligned.  Returns
// the first launch error (cudaErrorInvalidValue for anything else).
extern "C" int ssm_scan_launch(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, void* y, void* scratch, int B, int S, int H,
                               int P, int N, int chunk, int groups, int x_dtype, int y_dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || H <= 0 || groups <= 0 || P % 16 || P < 16 || P > kMaxP ||
      N % 16 || N < 16 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  if (x_dtype == 0 && y_dtype == 0)
    return launch<float, float>(x, dt, A, Bm, Cm, y, scratch, B, S, H, P, N, chunk, groups, s);
  if (x_dtype == 1 && y_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, dt, A, Bm, Cm, y, scratch, B, S, H, P, N,
                                                chunk, groups, s);
  if (x_dtype == 1 && y_dtype == 0)
    return launch<__nv_bfloat16, float>(x, dt, A, Bm, Cm, y, scratch, B, S, H, P, N, chunk,
                                        groups, s);
  return (int)cudaErrorInvalidValue;
}
