// K5, K5v4 and K6: decode GEMVs over quantized weights, for Hopper (sm_90a).
//
// out[rows, N] = h[rows, K] @ W for rows <= 8 decode rows, h bf16. W8A8 (K6): W int8
// [K, N] with a bf16 scale per column. int4 (K5, K5v4): W packed two values a byte,
// uint8 [K/2, N] (packed row p holds logical rows 2p in the low nibble and 2p+1 in the
// high one), with a bf16 scale per (group of gs logical rows, column).
//
// K5 (w4a16_cluster_kernel), K5v4 (w4a8_cluster_kernel) and K6 (w8a8_cluster_kernel)
// share one design, in `namespace gemv` below; one decode row over a short contraction
// takes the one-row kernels first.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace {

// ---- K5, K5v4 and K6 at one decode row: one block of 256 threads owns 32 columns and
// the whole contraction, on the CUDA cores ----
//
// w4a16_kernel, w4a8_kernel and w8a8_kernel serve K5, K5v4 and K6 at one row when the
// launch plan asks for them (tile 0: ops/int8_matmul.py::gemv_plan, for short
// contractions, where they take less device time in a decode step than the cluster
// kernels below, whose barriers and split sums are a fixed cost a call; PERF.md, Findings on K5 and K6).
// Bound by bytes: the weight, K*N or K*N/2. Each thread reads 4-byte words (4 neighbouring
// columns of one weight row), so the 8 threads of a column group cover the tile's 32
// bytes of a row and a warp reads 4 rows at once. The 32 k-groups of a block split the
// contraction; their partial sums meet through warp shuffles and one shared-memory
// pass. Activations are staged in shared memory one K-chunk at a time; a thread starts
// its weight loads for the chunk before the staging. The activations are quantized
// inside the launch, as rowquant_int8 does, the even and the odd columns apart:
// s = max|a| / 127 (1 for an all-zero row), q = rintf(a / s) with IEEE division (this
// file is built without fast math). A thread transposes 4 rows x 4 columns of bytes
// with __byte_perm and feeds __dp4a; int4 nibbles are biased to 0..15 (n ^ 8), the bias
// taken back as 8 * sum(a). Scales compose after the dots in fp32 as
// (pe * s_even + po * s_odd) * gscale, per 16 packed rows of one group. W8A8 quantizes
// the whole row with one scale and rescales as acc * a_scale * w_scale; W4A16 converts
// each nibble to fp32 exactly (2^23 + u as float bits, minus 2^23 + 8) and accumulates
// h * w in fp32 per group, scaling after the group's dot. The grid is N / 32 blocks.

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TN = 32;            // output columns per block
constexpr int CG = TN / 4;        // column groups: one 4-byte word of a weight row each
constexpr int KG = THREADS / CG;  // k-groups per block
constexpr int MAX_ROWS = 8;
constexpr unsigned FULL = 0xffffffffu;

constexpr int KC8 = 1024;              // W8A8: logical rows per chunk
constexpr int QPT8 = KC8 / 4 / KG;     // 4-row quads per thread per chunk
constexpr int PC4 = 512;               // int4: packed rows per chunk (1024 logical)
constexpr int PPT4 = PC4 / KG;         // packed rows per thread per chunk (16, one group)
constexpr int PC4_PAD = PC4 + PC4 / 32;

__device__ __forceinline__ int skew(int p) { return p + (p >> 5); }  // no bank conflicts

// Columns of a 4x4 byte block: w_i holds row i's bytes for columns 0..3; c[j] gets
// column j's bytes for rows 0..3.
__device__ __forceinline__ void transpose4(const unsigned* w, unsigned* c) {
  const unsigned t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[0], w[1], 0x7362);
  const unsigned t2 = __byte_perm(w[2], w[3], 0x5140), t3 = __byte_perm(w[2], w[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ int quant8(float a, float s) { return (int)rintf(a / s); }

__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) | ((unsigned)(d & 0xff) << 24);
}

// Byte j of a word of biased nibbles (0..15) as the signed value u - 8, in fp32.
__device__ __forceinline__ float nibble_f(unsigned u, int j) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) - 8388616.0f;
}

__device__ __forceinline__ unsigned lo_biased(unsigned w) { return (w & 0x0F0F0F0Fu) ^ 0x08080808u; }
__device__ __forceinline__ unsigned hi_biased(unsigned w) { return ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u; }

__device__ __forceinline__ unsigned load_word(const uint8_t* __restrict__ w, size_t row, int N, int n,
                                              bool ok) {
  return ok ? __ldg(reinterpret_cast<const unsigned*>(w + row * N + n)) : 0u;
}

// Per-row activation scales max|a| / 127 (1 for a zero max), over the even and the
// odd columns apart (split) or over all of them. Ends with a barrier.
template <int R>
__device__ void row_scales(const __nv_bfloat16* __restrict__ h, int K, bool split,
                           float* s_even, float* s_odd, float* red) {
  float me[R], mo[R];
#pragma unroll
  for (int r = 0; r < R; ++r) me[r] = mo[r] = 0.f;
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(h);
  const int K2 = K / 2;
  for (int i = threadIdx.x; i < K2; i += THREADS) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 v = __bfloat1622float2(h2[(size_t)r * K2 + i]);
      me[r] = fmaxf(me[r], fabsf(v.x));
      mo[r] = fmaxf(mo[r], fabsf(v.y));
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      me[r] = fmaxf(me[r], __shfl_xor_sync(FULL, me[r], off));
      mo[r] = fmaxf(mo[r], __shfl_xor_sync(FULL, mo[r], off));
    }
    if (lane == 0) {
      red[(warp * R + r) * 2] = me[r];
      red[(warp * R + r) * 2 + 1] = mo[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    float e = 0.f, o = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      e = fmaxf(e, red[(w * R + r) * 2]);
      o = fmaxf(o, red[(w * R + r) * 2 + 1]);
    }
    if (!split) e = o = fmaxf(e, o);
    e = e / 127.0f;
    o = o / 127.0f;
    s_even[r] = e == 0.f ? 1.f : e;
    s_odd[r] = o == 0.f ? 1.f : o;
  }
  __syncthreads();
}

// Sum a thread's [R][4] partials over the block's k-groups and write the tile's
// outputs through `finish(r, column, sum)`.
template <int R, typename T, typename Finish>
__device__ __forceinline__ void reduce_write(T (&acc)[R][4], T* red, int N, Finish finish) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, cg = t % CG;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T v = acc[r][j];
      v += __shfl_xor_sync(FULL, v, 8);   // lanes of one column group differ in
      v += __shfl_xor_sync(FULL, v, 16);  // lane bits 3 and 4 (their k-group)
      if (lane < CG) red[(warp * R + r) * TN + cg * 4 + j] = v;
    }
  }
  __syncthreads();
  for (int i = t; i < R * TN; i += THREADS) {
    const int r = i / TN, c = i % TN, col = blockIdx.x * TN + c;
    if (col >= N) continue;
    T sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[(w * R + r) * TN + c];
    finish(r, col, sum);
  }
}

// K6: W8A8. w int8 [K, N], ws bf16 [N].
template <int R>
__global__ void __launch_bounds__(THREADS) w8a8_kernel(
    const __nv_bfloat16* __restrict__ h, const uint8_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ ws, __nv_bfloat16* __restrict__ out, int K, int N) {
  __shared__ int a8[R][KC8 / 4];
  __shared__ int red[WARPS * R * TN];
  __shared__ float sred[WARPS * R * 2];
  __shared__ float sc[R], sc_odd[R];
  const int t = threadIdx.x, cg = t % CG, kg = t / CG;
  const int n = blockIdx.x * TN + cg * 4;
  const bool col_ok = n < N;

  int acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0;
  const int nq = K / 4;
  for (int c0 = 0; c0 < nq; c0 += KC8 / 4) {
    const int cq = min(KC8 / 4, nq - c0);
    // The chunk's weight loads go out first, to be in flight while the
    // activations are scaled and staged.
    unsigned wv[QPT8][4];
#pragma unroll
    for (int i = 0; i < QPT8; ++i) {
      const int q = kg * QPT8 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wv[i][j] = load_word(w, (size_t)4 * (c0 + q) + j, N, n, col_ok && q < cq);
    }
    if (c0 == 0) row_scales<R>(h, K, false, sc, sc_odd, sred);
    for (int i = t; i < R * cq; i += THREADS) {
      const int r = i / cq, qq = i % cq;
      const __nv_bfloat162* src =
          reinterpret_cast<const __nv_bfloat162*>(h + (size_t)r * K + 4 * (c0 + qq));
      const float2 a = __bfloat1622float2(src[0]), b = __bfloat1622float2(src[1]);
      const float s = sc[r];
      a8[r][qq] = pack4(quant8(a.x, s), quant8(a.y, s), quant8(b.x, s), quant8(b.y, s));
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < QPT8; ++i) {
      const int q = kg * QPT8 + i;
      if (q >= cq) break;
      unsigned c[4];
      transpose4(wv[i], c);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int a = a8[r][q];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = __dp4a((int)c[j], a, acc[r][j]);
      }
    }
    __syncthreads();
  }
  reduce_write<R>(acc, red, N, [&](int r, int col, int sum) {
    out[(size_t)r * N + col] = __float2bfloat16_rn((float)sum * sc[r] * __bfloat162float(ws[col]));
  });
}

// K5v4: W4A8. w uint8 [K/2, N] packed nibbles, gscale bf16 [K/gs, N].
template <int R>
__global__ void __launch_bounds__(THREADS) w4a8_kernel(
    const __nv_bfloat16* __restrict__ h, const uint8_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ gscale, __nv_bfloat16* __restrict__ out, int K, int N,
    int gs_half) {
  __shared__ int ae[R][PC4 / 4], ao[R][PC4 / 4];
  __shared__ float red[WARPS * R * TN];
  __shared__ float sred[WARPS * R * 2];
  __shared__ float se[R], so[R];
  const int t = threadIdx.x, cg = t % CG, kg = t / CG;
  const int n = blockIdx.x * TN + cg * 4;
  const bool col_ok = n < N;

  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  const int nq = K / 8;  // quads of packed rows
  for (int c0 = 0; c0 < nq; c0 += PC4 / 4) {
    const int cq = min(PC4 / 4, nq - c0);
    const int q0 = kg * (PPT4 / 4);  // this thread's 16 packed rows lie in one group
    unsigned wv[PPT4 / 4][4];  // loads in flight while the activations are staged
#pragma unroll
    for (int i = 0; i < PPT4 / 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wv[i][j] = load_word(w, (size_t)4 * (c0 + q0 + i) + j, N, n, col_ok && q0 < cq);
    if (c0 == 0) row_scales<R>(h, K, true, se, so, sred);
    for (int i = t; i < R * cq; i += THREADS) {
      const int r = i / cq, qq = i % cq;
      const __nv_bfloat162* src =
          reinterpret_cast<const __nv_bfloat162*>(h + (size_t)r * K + 8 * (c0 + qq));
      float2 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __bfloat1622float2(src[k]);
      const float s0 = se[r], s1 = so[r];
      ae[r][qq] = pack4(quant8(v[0].x, s0), quant8(v[1].x, s0), quant8(v[2].x, s0), quant8(v[3].x, s0));
      ao[r][qq] = pack4(quant8(v[0].y, s1), quant8(v[1].y, s1), quant8(v[2].y, s1), quant8(v[3].y, s1));
    }
    __syncthreads();
    if (q0 < cq) {
      int pe[R][4], po[R][4], sae[R], sao[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        sae[r] = sao[r] = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) pe[r][j] = po[r][j] = 0;
      }
#pragma unroll
      for (int i = 0; i < PPT4 / 4; ++i) {
        unsigned c[4], lo[4], hi[4];
        transpose4(wv[i], c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo[j] = lo_biased(c[j]);
          hi[j] = hi_biased(c[j]);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int a = ae[r][q0 + i], b = ao[r][q0 + i];
          sae[r] = __dp4a(0x01010101, a, sae[r]);
          sao[r] = __dp4a(0x01010101, b, sao[r]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            pe[r][j] = __dp4a((int)lo[j], a, pe[r][j]);
            po[r][j] = __dp4a((int)hi[j], b, po[r][j]);
          }
        }
      }
      const int g = 4 * (c0 + q0) / gs_half;
      float gsc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) gsc[j] = col_ok ? __bfloat162float(gscale[(size_t)g * N + n + j]) : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[r][j] += ((float)(pe[r][j] - 8 * sae[r]) * se[r] + (float)(po[r][j] - 8 * sao[r]) * so[r]) * gsc[j];
    }
    __syncthreads();
  }
  reduce_write<R>(acc, red, N, [&](int r, int col, float sum) {
    out[(size_t)r * N + col] = __float2bfloat16_rn(sum);
  });
}

// K5: W4A16, exact. Same operands as K5v4.
template <int R>
__global__ void __launch_bounds__(THREADS) w4a16_kernel(
    const __nv_bfloat16* __restrict__ h, const uint8_t* __restrict__ w,
    const __nv_bfloat16* __restrict__ gscale, __nv_bfloat16* __restrict__ out, int K, int N,
    int gs_half) {
  __shared__ float he[R][PC4_PAD], ho[R][PC4_PAD];
  __shared__ float red[WARPS * R * TN];
  const int t = threadIdx.x, cg = t % CG, kg = t / CG;
  const int n = blockIdx.x * TN + cg * 4;
  const bool col_ok = n < N;
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(h);

  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  const int P = K / 2;
  for (int c0 = 0; c0 < P; c0 += PC4) {
    const int cp = min(PC4, P - c0);
    const int p0 = kg * PPT4;  // 16 packed rows of one group
    unsigned wv[PPT4];  // loads in flight while the activations are staged
#pragma unroll
    for (int i = 0; i < PPT4; ++i) wv[i] = load_word(w, (size_t)(c0 + p0 + i), N, n, col_ok && p0 < cp);
    for (int i = t; i < R * cp; i += THREADS) {
      const int r = i / cp, pp = i % cp;
      const float2 v = __bfloat1622float2(h2[(size_t)r * P + c0 + pp]);
      he[r][skew(pp)] = v.x;
      ho[r][skew(pp)] = v.y;
    }
    __syncthreads();
    if (p0 < cp) {
      float part[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[r][j] = 0.f;
#pragma unroll
      for (int i = 0; i < PPT4; ++i) {
        const unsigned lo = lo_biased(wv[i]), hi = hi_biased(wv[i]);
        float fl[4], fh[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          fl[j] = nibble_f(lo, j);
          fh[j] = nibble_f(hi, j);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float a = he[r][skew(p0 + i)], b = ho[r][skew(p0 + i)];
#pragma unroll
          for (int j = 0; j < 4; ++j) part[r][j] = fmaf(b, fh[j], fmaf(a, fl[j], part[r][j]));
        }
      }
      const int g = (c0 + p0) / gs_half;
      float gsc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) gsc[j] = col_ok ? __bfloat162float(gscale[(size_t)g * N + n + j]) : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(part[r][j], gsc[j], acc[r][j]);
    }
    __syncthreads();
  }
  reduce_write<R>(acc, red, N, [&](int r, int col, float sum) {
    out[(size_t)r * N + col] = __float2bfloat16_rn(sum);
  });
}

// K6, K5 and K5v4 at one decode row.
int launch_w8a8_row(const void* h, const void* w, const void* s, void* out, int K, int N,
                    void* stream) {
  w8a8_kernel<1><<<(N + TN - 1) / TN, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const uint8_t*>(w),
      static_cast<const __nv_bfloat16*>(s), static_cast<__nv_bfloat16*>(out), K, N);
  return (int)cudaGetLastError();
}

int launch_w4a16_row(const void* h, const void* w, const void* s, void* out, int K, int N,
                     int gs_half, void* stream) {
  w4a16_kernel<1><<<(N + TN - 1) / TN, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const uint8_t*>(w),
      static_cast<const __nv_bfloat16*>(s), static_cast<__nv_bfloat16*>(out), K, N, gs_half);
  return (int)cudaGetLastError();
}

int launch_w4a8_row(const void* h, const void* w, const void* s, void* out, int K, int N,
                    int gs_half, void* stream) {
  w4a8_kernel<1><<<(N + TN - 1) / TN, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const uint8_t*>(w),
      static_cast<const __nv_bfloat16*>(s), static_cast<__nv_bfloat16*>(out), K, N, gs_half);
  return (int)cudaGetLastError();
}

bool int4_shape_ok(int rows, int K, int N, int gs) {
  return rows >= 1 && rows <= MAX_ROWS && N >= 4 && N % 4 == 0 && gs >= 32 && gs % 32 == 0 &&
         K >= gs && K % gs == 0;
}

// ---- K5, K5v4 and K6: split-K over a thread-block cluster, mma.sync, one launch ----
//
// K6 (w8a8_cluster_kernel) replaces xotorch_tpu/ops/int8_matmul.py:43
// _int8_matvec_kernel; K5 (w4a16_cluster_kernel) replaces xotorch_tpu/ops/int4_matmul.py
// :46,67,93 _int4_matvec_kernel{,_v2,_v3} (the three differ on the TPU only in where
// the scale multiply sits; here one exact W4A16 kernel serves them); K5v4
// (w4a8_cluster_kernel) replaces xotorch_tpu/ops/int4_matmul.py:122
// _int4_matvec_kernel_v4 (W4A8).
//
// Bound on this card: bytes. The weight is read once and dominates (K*N int8, K*N/2
// int4): 16 MB for a 2048 x 8192 int8 projection is 5.0 us at 3.35 TB/s, while the
// 2*rows*K*N operations take 0.07 us even at rows 8 on the int8 tensor cores. So the
// design is about keeping enough weight bytes in flight on every SM, whatever N:
// - The grid is column tiles x splits of the contraction; the splits of one tile form
//   one thread-block cluster (at most 8, the portable size). A split is a range of
//   whole 32-row k-steps (the last ends at K). The host picks the tile width (16, 32,
//   64 or 128 columns: the widest that still gives a block for every SM) and the splits
//   from static shapes and the SM count (ops/int8_matmul.py::gemv_plan), so the
//   512-column k/v projections fill the card as the 8192-column ones do.
// - A block of 4 warps streams its column strip through a ring of NSTAGE tiles of
//   SROWS rows in shared memory with cp.async (16-byte copies where the layout is
//   aligned), each tile with its slice of h (int4: and the gscale rows of its groups);
//   the next tiles' copies stay in flight while one is computed. The warps split the
//   tile's rows; each computes every 16-column mma tile of the strip.
// - Tensor cores for every row count: mma.sync with n = 8 decode rows, rows past `rows`
//   are zero registers. The weight is the A operand (16 columns x k), the activations
//   B. ldmatrix.trans hands lane (g, t4) the bytes of two neighbouring rows in the
//   column pair (2g, 2g + 1), and A's rows g and g + 8 are those two columns. A sum is
//   order-free, so each lane's k slots hold whichever rows the load gives it, and B is
//   built from h at the same rows.
//   The A8 formats (K6, K5v4) quantize the activations in the launch, bit for bit as
//   rowquant_int8 does: each block takes max|a| over its own range (its loads go out
//   ahead of the tile copies), the cluster exchanges the maxima through distributed
//   shared memory, s = max / 127 (1 for a zero row), q = rintf(a / s) with IEEE
//   division, each value once per column tile. K5v4 takes two maxima a row, over the
//   even and the odd columns apart (the columns that meet the low and the high nibbles).
//   K6, m16n8k32 s8 x s8 -> s32: __byte_perm gathers four rows of one column into an A
//   register. The int32 sums are exact in any order; the epilogue is
//   (float)acc * a_scale * w_scale, in that order, as the plain version.
//   K5, m16n8k16 bf16 x bf16 -> f32: a packed byte holds logical k = 2p and 2p + 1 of
//   one column; a nibble pair moved to bits 0-3 and 16-19 and ORed with 0x43004300 is
//   bf16 (128 + u, 128 + u') exactly, and minus 136 the signed values (u biased by ^ 8).
//   One fp32 fragment a group, scaled by gscale when the group or the tile ends and
//   added to the total; a split that cuts a group scales its own part of it.
//   K5v4, m16n8k16 s8 x s8 -> s32 on 16 packed rows (the grain of both a split edge and
//   the smallest group, so no mma straddles either): K6's gather gives an A register of
//   4 packed rows of one column, split into its low and high nibbles sign-extended per
//   byte; two int32 fragments a group, lows x even activations (pe) and highs x odd
//   ones (po), folded into the fp32 total as ((float)pe * s_even + (float)po * s_odd)
//   * gscale when the group or the tile ends, the plain version's order (two fmas).
// - Each rank of the cluster owns a share of the tile's outputs: every block stores its
//   partials into the owners' shared memory (distributed shared memory), one cluster
//   barrier publishes them, and each owner sums them in rank order and writes: one
//   launch, a result that does not depend on scheduling, no workspace, counter, memset
//   or second kernel.
namespace gemv {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;   // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 8;        // decode rows: one mma's N
constexpr int KSTEP = 32;      // logical rows of a k-step; a split is whole k-steps
constexpr int MAX_SPLITS = 8;  // the portable cluster size
constexpr int NSTAGE = 3;      // weight tiles in the ring
constexpr int SROWS = 128;     // weight rows of a tile (int4: packed rows)

// The weight and activation formats: K6, K5, K5v4.
enum class Fmt { W8A8, W4A16, W4A8 };

// A tile of TN columns: SROWS rows of TN bytes (int8 codes, or packed nibble pairs),
// the rows' h slice beside it.
template <Fmt F, int TN>
struct Geometry {
  static constexpr bool INT4 = F != Fmt::W8A8;
  static constexpr bool A8 = F != Fmt::W4A16;  // activations quantized to int8
  static constexpr int NMAX = F == Fmt::W4A8 ? 2 : 1;  // activation scales a row
  static constexpr int SUB = TN / 16;       // 16-column mma tiles of a weight row
  static constexpr int KPR = INT4 ? 2 : 1;  // logical k a weight row
  static constexpr int KL = SROWS * KPR;    // logical k a tile
  static constexpr int WBYTES = SROWS * TN;
  // int4: the gscale rows of the groups a tile touches (groups are at least 16 packed rows).
  static constexpr int GROUPS = INT4 ? SROWS / 16 + 1 : 0;
  static constexpr int SBYTES = GROUPS * TN * 2;
  // A staged h row: KL bf16 and a pad that puts the rows of one B load (K6: 4 bytes a
  // lane, int4: 8) on distinct banks.
  static constexpr int HSTRIDE = 2 * KL + (INT4 ? 32 : 16);
  __host__ __device__ static constexpr int slot(int rows) {
    return WBYTES + SBYTES + rows * HSTRIDE;
  }
  __host__ __device__ static constexpr int smem(int rows) { return NSTAGE * slot(rows); }
  // The total a lane keeps per fragment, and the running sum of the current group
  // (K5: fp32; K5v4: int32 even and odd dots).
  using Acc = typename std::conditional<F == Fmt::W8A8, int, float>::type;
  using GAcc = typename std::conditional<F == Fmt::W4A8, int, float>::type;
  static constexpr int NGRP = F == Fmt::W4A8 ? 2 : 1;
  static_assert(TN % 16 == 0 && TN <= 128, "whole 16-column mma tiles, at most 8 a row");
  static_assert(WARPS * ROWS * TN * 4 <= NSTAGE * WBYTES, "the epilogue reuses the ring");
};

// Byte offset of 16-byte chunk j (columns 16 j .. 16 j + 15) of weight row r in a tile.
// A 128-byte bank window holds 128 / TN rows; the chunk's slot in it is XORed with the
// window's index, so that the 8 rows an ldmatrix phase reads fall on distinct banks.
template <int TN>
__device__ __forceinline__ int wchunk(int r, int j) {
  return (r * TN + 16 * j) ^ (((r / (128 / TN)) & (TN / 16 - 1)) << 4);
}

// ldmatrix.trans of M (1, 2 or 4) 8 x 8 matrices of 16-bit pairs of bytes: lanes 8m ..
// 8m + 7 give the row addresses of matrix m; lane (g, t4) gets from each matrix the
// pairs of rows 2 t4 and 2 t4 + 1 in column pair g: bytes (row 2t4: 2g, 2g + 1; row
// 2t4 + 1: 2g, 2g + 1).
template <int M>
__device__ __forceinline__ void ldm_trans(uint32_t* x, const void* p) {
  const uint32_t a = xot_mma::smem_u32(p);
  if constexpr (M == 4)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3]) : "r"(a) : "memory");
  else if constexpr (M == 2)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(x[0]), "=r"(x[1]) : "r"(a) : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
                 : "=r"(x[0]) : "r"(a) : "memory");
}

// `vec` bytes (4, 8 or 16, the same in every lane) from global to shared memory; zeros
// when !valid.
__device__ __forceinline__ void copy_async(void* dst, const void* src, int vec, bool valid) {
  const uint32_t d = xot_mma::smem_u32(dst);
  const int n = valid ? vec : 0;
  if (vec == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else if (vec == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
}

// A cluster barrier in two halves: arrive (relaxed) early, wait before the first access
// to another block's shared memory, which must not come before every block has started.
__device__ __forceinline__ void xot_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void xot_cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// c (16x8 s32) += a (16x32 s8, row) . b (32x8 s8, col).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16x8 s32) += a (16x16 s8, row) . b (16x8 s8, col): a0 holds row g, a1 row g + 8,
// both at k 4 t4 .. 4 t4 + 3; b holds k 4 t4 .. 4 t4 + 3 of column g.
__device__ __forceinline__ void mma_s8_k16(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// The bf16 pair of the signed nibbles at bits 0-3 and 16-19 of x >> shift, stored
// biased (u = n ^ 8, 0..15): bf16 0x4300 | u is 128 + u exactly, and minus 136 it is n.
__device__ __forceinline__ uint32_t nibble_pair(uint32_t x, int shift) {
  uint32_t v = ((x >> shift) & 0x000F000Fu) | 0x43004300u;
  __nv_bfloat162 f = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v), __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&f);
}

// The signed nibbles at bits 0-3 of each byte of x >> shift, as four s8: for a nibble of
// value v (-8..7), n ^ 8 is v + 8 (0..15); + 0x78 makes the byte v + 0x80 with no carry
// out of it; ^ 0x80 leaves v in two's complement.
__device__ __forceinline__ uint32_t nibbles_s8(uint32_t x, int shift) {
  return ((((x >> shift) & 0x0F0F0F0Fu) ^ 0x08080808u) + 0x78787878u) ^ 0x80808080u;
}

// Weight rows rs .. rs + SROWS - 1 (zeros from r1 on), columns col0 .. col0 + TN - 1
// (zeros from N on), into a tile, V bytes a copy.
template <int TN, int V>
__device__ __forceinline__ void copy_tile(unsigned char* tile, const uint8_t* w, int rs, int r1,
                                          int col0, int N) {
  constexpr int PER = TN / V;  // copies a row
  for (int i = threadIdx.x; i < SROWS * PER; i += THREADS) {
    const int r = i / PER, c = (i % PER) * V;
    const bool ok = rs + r < r1 && col0 + c < N;
    copy_async(tile + wchunk<TN>(r, c / 16) + c % 16, ok ? w + (size_t)(rs + r) * N + col0 + c : w,
               V, ok);
  }
}

struct Args {
  const __nv_bfloat16* h;      // [rows, K]
  const uint8_t* w;            // int8 [K, N] or packed uint8 [K/2, N]
  const __nv_bfloat16* scale;  // K6: [N]; K5, K5v4: gscale [K/gs, N]
  __nv_bfloat16* out;          // [rows, N]
  int rows, K, N, gs_half, splits;
  int vec_w, vec_h, vec_s;     // bytes a cp.async moves: 16 where row stride and pointer allow
};

template <Fmt F, int TN>
__device__ __forceinline__ void gemv_body(const Args& a) {
  using G = Geometry<F, TN>;
  using Acc = typename G::Acc;
  using GAcc = typename G::GAcc;
  constexpr bool INT4 = G::INT4, A8 = G::A8;
  constexpr int SUB = G::SUB, NMAX = G::NMAX;
  extern __shared__ __align__(16) unsigned char smem[];
  // The A8 formats' activation scales: [scale][row], K5v4's even ones first.
  __shared__ float wmax[WARPS][NMAX * ROWS], amax[NMAX * ROWS], ascale[NMAX * ROWS];
  __shared__ __align__(16) __nv_bfloat16 wscale[TN];              // K6's column scales
  __shared__ Acc inbox[ROWS * TN + MAX_SPLITS];  // [split][output share], this rank's outputs
  cg::cluster_group cluster = cg::this_cluster();
  if constexpr (!A8) xot_cluster_arrive();  // the A8 formats' first cluster.sync does this

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int split = blockIdx.x, col0 = blockIdx.y * TN;
  const int steps = (a.K + KSTEP - 1) / KSTEP;
  const int k0 = split * steps / a.splits * KSTEP;
  const int k1 = min(a.K, (split + 1) * steps / a.splits * KSTEP);
  const int r0 = k0 / G::KPR, r1 = k1 / G::KPR;  // this split's weight rows
  const int nstage = (r1 - r0 + SROWS - 1) / SROWS;
  const int slot = G::slot(a.rows);

  auto fetch = [&](int s) {  // tile s of the split: weight rows and h columns
    unsigned char* base = smem + (s % NSTAGE) * slot;
    const int rs = r0 + s * SROWS;
    if (a.vec_w == 16)
      copy_tile<TN, 16>(base, a.w, rs, r1, col0, a.N);
    else if (a.vec_w == 8)
      copy_tile<TN, 8>(base, a.w, rs, r1, col0, a.N);
    else
      copy_tile<TN, 4>(base, a.w, rs, r1, col0, a.N);
    if constexpr (INT4) {  // gscale rows of groups g0 .. g1, columns of the tile
      const int g0 = rs / a.gs_half, g1 = (min(rs + SROWS, r1) - 1) / a.gs_half;
      const int sper = 2 * TN / a.vec_s, ev = a.vec_s / 2;
      for (int i = threadIdx.x; i < (g1 - g0 + 1) * sper; i += THREADS) {
        const int gi = i / sper, e = (i % sper) * ev;
        const bool ok = col0 + e < a.N;
        copy_async(base + G::WBYTES + 2 * (gi * TN + e),
                   ok ? a.scale + (size_t)(g0 + gi) * a.N + col0 + e : a.scale, a.vec_s, ok);
      }
    }
    const int ks = rs * G::KPR, hper = 2 * G::KL / a.vec_h, ev = a.vec_h / 2;
    for (int i = threadIdx.x; i < a.rows * hper; i += THREADS) {
      const int r = i / hper, e = (i % hper) * ev;
      const bool ok = ks + e < k1;
      copy_async(base + G::WBYTES + G::SBYTES + r * G::HSTRIDE + 2 * e,
                 ok ? a.h + (size_t)r * a.K + ks + e : a.h, a.vec_h, ok);
    }
  };
  if constexpr (!INT4) {  // the column scales, for the epilogue
    for (int e = 2 * threadIdx.x; e < TN; e += 2 * THREADS) {
      const bool ok = col0 + e < a.N;
      copy_async(wscale + e, ok ? a.scale + col0 + e : a.scale, 4, ok);
    }
  }
  // A8: the first PRE pairs of h a thread takes for the row maxima go out ahead of the
  // tiles' copies, which would otherwise queue them behind the tiles' bytes.
  constexpr int PRE = 4;
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(a.h);
  __nv_bfloat162 hv[A8 ? ROWS : 1][PRE];
  if constexpr (A8) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int u = 0; u < PRE; ++u) {
        const int i = k0 / 2 + threadIdx.x + u * THREADS;
        hv[r][u] = r < a.rows && i < k1 / 2 ? h2[(size_t)r * (a.K / 2) + i]
                                             : __floats2bfloat162_rn(0.f, 0.f);
      }
  }
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nstage) fetch(s);
    xot_mma::cp_async_commit();
  }

  if constexpr (A8) {
    // max|a| of each row over this split's range while the first tiles land, then over
    // the cluster: the row's max over all of K, as rowquant_int8 takes it. A pair of h
    // is (even column, odd column): K5v4 keeps their maxima apart, K6 takes both.
    float m[NMAX][ROWS] = {};
    auto take = [&](int r, float2 v) {
      if constexpr (NMAX == 2) {
        m[0][r] = fmaxf(m[0][r], fabsf(v.x));
        m[1][r] = fmaxf(m[1][r], fabsf(v.y));
      } else {
        m[0][r] = fmaxf(m[0][r], fmaxf(fabsf(v.x), fabsf(v.y)));
      }
    };
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int u = 0; u < PRE; ++u) take(r, __bfloat1622float2(hv[r][u]));
    for (int i = k0 / 2 + threadIdx.x + PRE * THREADS; i < k1 / 2; i += THREADS) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < a.rows) take(r, __bfloat1622float2(h2[(size_t)r * (a.K / 2) + i]));
      }
    }
#pragma unroll
    for (int q = 0; q < NMAX; ++q)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          m[q][r] = fmaxf(m[q][r], __shfl_xor_sync(0xffffffffu, m[q][r], off));
        if (lane == 0) wmax[warp][q * ROWS + r] = m[q][r];
      }
    __syncthreads();
    if (threadIdx.x < NMAX * ROWS) {
      float v = 0.f;
      for (int w = 0; w < WARPS; ++w) v = fmaxf(v, wmax[w][threadIdx.x]);
      amax[threadIdx.x] = v;
    }
    cluster.sync();
    if (threadIdx.x < NMAX * ROWS) {
      float v[MAX_SPLITS];
#pragma unroll
      for (int q = 0; q < MAX_SPLITS; ++q)
        v[q] = q < a.splits ? cluster.map_shared_rank(amax, q)[threadIdx.x] : 0.f;
      float mx = 0.f;
#pragma unroll
      for (int q = 0; q < MAX_SPLITS; ++q) mx = fmaxf(mx, v[q]);
      mx = mx / 127.0f;
      ascale[threadIdx.x] = mx == 0.f ? 1.f : mx;  // rows past `rows` read 1
    }
    __syncthreads();
  }

  Acc acc[SUB][4];
  GAcc grp[G::NGRP][SUB][4];  // int4: the current group's fragments (K5v4: pe, po)
#pragma unroll
  for (int j = 0; j < SUB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[j][e] = 0;
#pragma unroll
      for (int q = 0; q < G::NGRP; ++q) grp[q][j][e] = 0;
    }
  // K5v4: the activation scales of this lane's fragment rows 2 t4 and 2 t4 + 1.
  float se[2] = {1.f, 1.f}, so[2] = {1.f, 1.f};
  if constexpr (F == Fmt::W4A8) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      se[e] = ascale[2 * t4 + e];
      so[e] = ascale[ROWS + 2 * t4 + e];
    }
  }
  int group = -1;
  const __nv_bfloat16* gsm = nullptr;  // int4: the stage's gscale rows, from group g_first
  int g_first = 0;
  // int4: totals += the group's fragments scaled, at columns 2g (e 0, 1) and 2g + 1
  // (e 2, 3) of each 16-column tile; K5v4's fragment rows are decode rows 2 t4 + (e & 1).
  auto flush = [&]() {
    if constexpr (INT4) {
      if (group < 0) return;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        const float2 sc = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            gsm + (group - g_first) * TN + 16 * j + 2 * g));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float gsc = e < 2 ? sc.x : sc.y;
          if constexpr (F == Fmt::W4A16) {
            acc[j][e] = fmaf(grp[0][j][e], gsc, acc[j][e]);
          } else {
            acc[j][e] = fmaf(fmaf((float)grp[0][j][e], se[e & 1],
                                  (float)grp[1][j][e] * so[e & 1]), gsc, acc[j][e]);
          }
#pragma unroll
          for (int q = 0; q < G::NGRP; ++q) grp[q][j][e] = 0;
        }
      }
    }
  };

  for (int s = 0; s < nstage; ++s) {
    xot_mma::cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // tile s landed; every warp is done with tile s - 1
    if (s + NSTAGE - 1 < nstage) fetch(s + NSTAGE - 1);
    xot_mma::cp_async_commit();
    const unsigned char* wt = smem + (s % NSTAGE) * slot;
    const unsigned char* ht = wt + G::WBYTES + G::SBYTES + g * G::HSTRIDE;  // this lane's B row
    const int rs = r0 + s * SROWS;
    if constexpr (F == Fmt::W8A8) {
      // 32-row chunks, warp w takes w, w + 4, ... One ldmatrix.x4.trans a 16-column mma
      // tile reads the chunk's four 8-row blocks; lane (g, t4) gets rows 2 t4, 2 t4 + 1
      // of each in columns 2g, 2g + 1, so its k slots hold chunk rows 2 t4 + {0, 1, 8, 9}
      // (a0, a1) and 16 + those (a2, a3), and B is quantized from the same rows, once
      // for the tile's SUB mmas.
      const float sc = ascale[g];
#pragma unroll
      for (int q = 0; q < SROWS / (WARPS * 32); ++q) {
        const int c = (q * WARPS + warp) * 32;
        if (rs + c >= r1) break;
        uint32_t b[2] = {0u, 0u};
        if (g < a.rows) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 lo = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(ht + 2 * (c + 16 * half + 2 * t4)));
            const float2 hi = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(ht + 2 * (c + 16 * half + 8 + 2 * t4)));
            b[half] = pack4(quant8(lo.x, sc), quant8(lo.y, sc), quant8(hi.x, sc), quant8(hi.y, sc));
          }
        }
#pragma unroll
        for (int j = 0; j < SUB; ++j) {
          uint32_t x[4], av[4];
          ldm_trans<4>(x, wt + wchunk<TN>(c + 8 * (lane >> 3) + (lane & 7), j));
          av[0] = __byte_perm(x[0], x[1], 0x6420);  // column 2g
          av[1] = __byte_perm(x[0], x[1], 0x7531);  // column 2g + 1
          av[2] = __byte_perm(x[2], x[3], 0x6420);
          av[3] = __byte_perm(x[2], x[3], 0x7531);
          mma_s8(acc[j], av, b[0], b[1]);
        }
      }
    } else if constexpr (F == Fmt::W4A16) {
      // 8-packed-row chunks (16 logical k), warp w takes the w-th quarter of the tile in
      // order. One ldmatrix.trans reads a chunk of every 16-column mma tile; lane (g, t4)
      // gets packed rows 2 t4, 2 t4 + 1 in columns 2g, 2g + 1: its k slots hold logical
      // k 4 t4, 4 t4 + 2 (a0: column 2g, a1: 2g + 1; low nibbles) and 4 t4 + 1, 4 t4 + 3
      // (a2, a3; high nibbles), and B takes h at the same k. A group's fragments are
      // scaled when the group or the tile ends.
      constexpr int PER_WARP = SROWS / WARPS, LDM = SUB < 4 ? SUB : 4;
      gsm = reinterpret_cast<const __nv_bfloat16*>(wt + G::WBYTES);
      g_first = rs / a.gs_half;
#pragma unroll
      for (int q = 0; q < PER_WARP / 8; ++q) {
        const int c = warp * PER_WARP + 8 * q;
        if (rs + c >= r1) break;
        const int gi = (rs + c) / a.gs_half;
        if (gi != group) {
          flush();
          group = gi;
        }
        uint32_t b0 = 0u, b1 = 0u;
        if (g < a.rows) {
          const uint2 v = *reinterpret_cast<const uint2*>(ht + 4 * c + 8 * t4);  // h at 2c + 4 t4 ..
          b0 = __byte_perm(v.x, v.y, 0x5410);  // h at 4 t4, 4 t4 + 2
          b1 = __byte_perm(v.x, v.y, 0x7632);  // h at 4 t4 + 1, 4 t4 + 3
        }
        uint32_t x[SUB];
#pragma unroll
        for (int j0 = 0; j0 < SUB; j0 += LDM)
          ldm_trans<LDM>(x + j0, wt + wchunk<TN>(c + (lane & 7), j0 + ((lane >> 3) & (LDM - 1))));
#pragma unroll
        for (int j = 0; j < SUB; ++j) {
          const uint32_t xb = x[j] ^ 0x88888888u;
          const uint32_t av[4] = {nibble_pair(xb, 0), nibble_pair(xb, 8), nibble_pair(xb, 4),
                                  nibble_pair(xb, 12)};
          xot_mma::mma_bf16(grp[0][j], av, b0, b1);
        }
      }
      flush();
      group = -1;
    } else {
      // 16-packed-row chunks, warp w takes the w-th quarter of the tile in order. As in
      // K6, one ldmatrix.trans matrix pair reads the chunk's two 8-row blocks of a
      // 16-column mma tile (x4: two tiles at once), and lane (g, t4)'s k slots 4 t4 ..
      // 4 t4 + 3 hold packed rows 2 t4 + {0, 1, 8, 9} of columns 2g (a0) and 2g + 1
      // (a1); their low nibbles meet h at logical 2p (even), the high ones 2p + 1 (odd),
      // one 8-byte load of h for each row pair. B is quantized once for the SUB mmas.
      constexpr int PER_WARP = SROWS / WARPS, LDM = SUB < 2 ? 2 : 4;
      gsm = reinterpret_cast<const __nv_bfloat16*>(wt + G::WBYTES);
      g_first = rs / a.gs_half;
      const float s_e = ascale[g], s_o = ascale[ROWS + g];
#pragma unroll
      for (int q = 0; q < PER_WARP / 16; ++q) {
        const int c = warp * PER_WARP + 16 * q;
        if (rs + c >= r1) break;
        const int gi = (rs + c) / a.gs_half;
        if (gi != group) {
          flush();
          group = gi;
        }
        uint32_t be = 0u, bo = 0u;
        if (g < a.rows) {
          // (even, odd) at packed rows 2 t4, 2 t4 + 1, then 8 + those.
          const uint2 v = *reinterpret_cast<const uint2*>(ht + 4 * (c + 2 * t4));
          const uint2 u = *reinterpret_cast<const uint2*>(ht + 4 * (c + 8 + 2 * t4));
          const float2 p0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
          const float2 p1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
          const float2 p8 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
          const float2 p9 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
          be = pack4(quant8(p0.x, s_e), quant8(p1.x, s_e), quant8(p8.x, s_e), quant8(p9.x, s_e));
          bo = pack4(quant8(p0.y, s_o), quant8(p1.y, s_o), quant8(p8.y, s_o), quant8(p9.y, s_o));
        }
        uint32_t x[2 * SUB];  // x[2j], x[2j + 1]: rows 0-7 and 8-15 of mma tile j
#pragma unroll
        for (int j0 = 0; j0 < SUB; j0 += LDM / 2)
          ldm_trans<LDM>(x + 2 * j0,
                         wt + wchunk<TN>(c + (lane & 7) + 8 * ((lane >> 3) & 1),
                                         j0 + (LDM == 4 ? lane >> 4 : 0)));
#pragma unroll
        for (int j = 0; j < SUB; ++j) {
          const uint32_t a0 = __byte_perm(x[2 * j], x[2 * j + 1], 0x6420);  // column 2g
          const uint32_t a1 = __byte_perm(x[2 * j], x[2 * j + 1], 0x7531);  // column 2g + 1
          mma_s8_k16(grp[0][j], nibbles_s8(a0, 0), nibbles_s8(a1, 0), be);
          mma_s8_k16(grp[1][j], nibbles_s8(a0, 4), nibbles_s8(a1, 4), bo);
        }
      }
      flush();
      group = -1;
    }
  }

  // The ring is free now: the warps' partials, summed in warp order. Fragment (j, e):
  // column 16 j + 2g + (e >> 1), row 2 t4 + (e & 1). Output t (row t / TN, column
  // t % TN) belongs to rank t / per, which sums it over the splits in rank order: each
  // block stores its partial into the owner's inbox (distributed shared memory), and
  // one cluster barrier publishes the stores.
  xot_mma::cp_async_wait<0>();
  __syncthreads();
  Acc* red = reinterpret_cast<Acc*>(smem);  // [WARPS][ROWS * TN]
#pragma unroll
  for (int j = 0; j < SUB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[warp * ROWS * TN + (2 * t4 + (e & 1)) * TN + 16 * j + 2 * g + (e >> 1)] = acc[j][e];
  __syncthreads();
  const int n_out = a.rows * TN, per = (n_out + a.splits - 1) / a.splits;
  const int rank = (int)cluster.block_rank();
  if constexpr (!A8) xot_cluster_wait();  // every block of the cluster has started
  for (int t = threadIdx.x; t < n_out; t += THREADS) {
    Acc v = red[t];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += red[w * ROWS * TN + t];
    *cluster.map_shared_rank(&inbox[rank * per + t % per], t / per) = v;
  }
  cluster.sync();
  for (int t = rank * per + threadIdx.x; t < min(n_out, (rank + 1) * per); t += THREADS) {
    const int r = t / TN, col = col0 + t % TN;
    if (col >= a.N) continue;
    Acc sum = inbox[t - rank * per];
    for (int q = 1; q < a.splits; ++q) sum += inbox[q * per + t - rank * per];
    if constexpr (INT4)
      a.out[(size_t)r * a.N + col] = __float2bfloat16_rn(sum);
    else
      a.out[(size_t)r * a.N + col] =
          __float2bfloat16_rn((float)sum * ascale[r] * __bfloat162float(wscale[t % TN]));
  }
}

template <int TN>
__global__ void __launch_bounds__(THREADS) w8a8_cluster_kernel(Args a) {
  gemv_body<Fmt::W8A8, TN>(a);
}
template <int TN>
__global__ void __launch_bounds__(THREADS) w4a16_cluster_kernel(Args a) {
  gemv_body<Fmt::W4A16, TN>(a);
}
// K5v4 at 128 columns would hold 195 registers, two blocks an SM, and the plan's
// blocks would then take two waves (gate/up: 320 blocks); bounded to three blocks an
// SM it holds 168 and spills nothing.
template <int TN>
__global__ void __launch_bounds__(THREADS, 3) w4a8_cluster_kernel(Args a) {
  gemv_body<Fmt::W4A8, TN>(a);
}

// The widest cp.async (16, 8 or 4 bytes) that a row stride and a base pointer allow.
int vec_bytes(const void* p, long long row_bytes) {
  for (int v : {16, 8}) {
    if (reinterpret_cast<uintptr_t>(p) % v == 0 && row_bytes % v == 0) return v;
  }
  return 4;
}

template <Fmt F, int TN>
int launch_tn(const Args& a, cudaStream_t stream) {
  auto kernel = F == Fmt::W8A8    ? w8a8_cluster_kernel<TN>
                : F == Fmt::W4A16 ? w4a16_cluster_kernel<TN>
                                  : w4a8_cluster_kernel<TN>;
  const int smem = Geometry<F, TN>::smem(a.rows);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.splits, (a.N + TN - 1) / TN, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, a);
}

template <Fmt F>
int launch(const void* h, const void* w, const void* s, void* out, int rows, int K, int N,
           int gs, int tile, int splits, void* stream) {
  const int steps = (K + KSTEP - 1) / KSTEP;
  if (splits < 1 || splits > MAX_SPLITS || splits > steps) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(h), static_cast<const uint8_t*>(w),
               static_cast<const __nv_bfloat16*>(s), static_cast<__nv_bfloat16*>(out),
               rows, K, N, gs / 2, splits, vec_bytes(w, N), vec_bytes(h, 2LL * K),
               vec_bytes(s, 2LL * N)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 16: return launch_tn<F, 16>(a, st);
    case 32: return launch_tn<F, 32>(a, st);
    case 64: return launch_tn<F, 64>(a, st);
    case 128: return launch_tn<F, 128>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace gemv

}  // namespace

// h bf16 [rows, K], w int8 [K, N], ws bf16 [N] -> out bf16 [rows, N], in column tiles of
// `tile` (16, 32, 64 or 128) with the contraction cut into `splits` ranges of whole
// 32-row k-steps, or (rows 1, tile 0) on the one-row kernel (ops/int8_matmul.py::gemv_plan).
extern "C" int xot_w8a8_matvec_bf16(const void* h, const void* w, const void* ws, void* out,
                                    int rows, int K, int N, int tile, int splits, void* stream) {
  if (rows < 1 || rows > MAX_ROWS || K < 4 || K % 4 != 0 || N < 4 || N % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (tile == 0) return rows == 1 ? launch_w8a8_row(h, w, ws, out, K, N, stream)
                                   : (int)cudaErrorInvalidValue;
  return gemv::launch<gemv::Fmt::W8A8>(h, w, ws, out, rows, K, N, 0, tile, splits, stream);
}

// h bf16 [rows, K], w uint8 [K/gs, gs/2, N] packed nibbles, gscale bf16 [K/gs, N];
// `tile` and `splits` as K6's.
extern "C" int xot_w4a8_matvec_bf16(const void* h, const void* w, const void* gscale, void* out,
                                    int rows, int K, int N, int gs, int tile, int splits,
                                    void* stream) {
  if (!int4_shape_ok(rows, K, N, gs)) return (int)cudaErrorInvalidValue;
  if (tile == 0) return rows == 1 ? launch_w4a8_row(h, w, gscale, out, K, N, gs / 2, stream)
                                   : (int)cudaErrorInvalidValue;
  return gemv::launch<gemv::Fmt::W4A8>(h, w, gscale, out, rows, K, N, gs, tile, splits, stream);
}

// As K5v4's operands and plan.
extern "C" int xot_w4a16_matvec_bf16(const void* h, const void* w, const void* gscale, void* out,
                                     int rows, int K, int N, int gs, int tile, int splits,
                                     void* stream) {
  if (!int4_shape_ok(rows, K, N, gs)) return (int)cudaErrorInvalidValue;
  if (tile == 0) return rows == 1 ? launch_w4a16_row(h, w, gscale, out, K, N, gs / 2, stream)
                                   : (int)cudaErrorInvalidValue;
  return gemv::launch<gemv::Fmt::W4A16>(h, w, gscale, out, rows, K, N, gs, tile, splits, stream);
}
