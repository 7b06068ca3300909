// K5, K5v4 and K6: decode GEMVs over quantized weights, for Hopper (sm_90a).
//
// Replaces
//   K5   xotorch_tpu/ops/int4_matmul.py::_int4_matvec_kernel{,_v2,_v3}  (W4A16, exact)
//   K5v4 xotorch_tpu/ops/int4_matmul.py::_int4_matvec_kernel_v4         (W4A8)
//   K6   xotorch_tpu/ops/int8_matmul.py::_int8_matvec_kernel            (W8A8)
// with out[rows, N] = h[rows, K] @ W for rows <= 8 decode rows. W8A8: W int8 [K, N]
// with a scale per column. int4: W packed two values a byte, uint8 [K/2, N] (packed
// row p holds logical rows 2p in the low nibble and 2p+1 in the high one), with a
// scale per (group of gs logical rows, column).
//
// What bounds it: the weight is read once and dominates the bytes (K*N or K*N/2), so
// every case is bound by bytes: 4 MB (int8) or 2 MB (int4) for a 2048 x 2048
// projection, 1.25 / 0.63 us at 3.35 TB/s. The arithmetic is 2*rows*K*N operations.
//
// Design. One block of 256 threads owns 32 output columns and the whole contraction
// (one launch per projection, no cross-block reduction). Each thread reads 4-byte
// words (4 neighbouring columns of one weight row), so the 8 threads of a column
// group cover the tile's 32 bytes of a row and a warp reads 4 rows at once. The 32
// k-groups of a block split the contraction; their partial sums meet through warp
// shuffles and one shared-memory pass. Activations are staged in shared memory one
// K-chunk at a time (at most 41 KB of static shared memory, no opt-in needed); a
// thread starts its weight loads for the chunk before the staging, so they are in
// flight while the activations are scaled and staged.
// - W8A8 / W4A8 quantize the activation inside the launch, as rowquant_int8 does:
//   s = max|a| / 127 (1 for an all-zero row), q = rintf(a / s) with IEEE division
//   (this file is built without fast math), so the kernel and the plain version
//   see the same int8 values. W4A8 quantizes the even and the odd columns apart.
//   A thread transposes 4 rows x 4 columns of bytes with __byte_perm and feeds
//   __dp4a (int8x4 -> int32). int4 nibbles are biased to 0..15 (n ^ 8) so that
//   they are valid int8 bytes; the bias is taken back as 8 * sum(a), which is one
//   __dp4a per activation word.
// - W4A16 converts each nibble to fp32 exactly (2^23 + u as float bits, minus
//   2^23 + 8) and accumulates h * w in fp32 per group, scaling after the group's dot.
// Scales are applied after the dots in fp32: K6 as acc * a_scale * w_scale, K5v4 as
// (pe * s_even + po * s_odd) * gscale, per 16 packed rows of one group.
//
// Known limits: the grid is N / 32 blocks, so the 512-column k/v projections use 16
// of the 132 SMs; W4A16 runs its arithmetic on CUDA-core FMA, no tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

enum class Kind { W8A8, W4A8, W4A16 };

template <Kind KIND, int R>
cudaError_t launch_rows(const void* h, const void* w, const void* s, void* out, int K, int N,
                        int gs_half, cudaStream_t stream) {
  const dim3 grid((N + TN - 1) / TN);
  const auto* hp = static_cast<const __nv_bfloat16*>(h);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* sp = static_cast<const __nv_bfloat16*>(s);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if constexpr (KIND == Kind::W8A8) w8a8_kernel<R><<<grid, THREADS, 0, stream>>>(hp, wp, sp, op, K, N);
  if constexpr (KIND == Kind::W4A8) w4a8_kernel<R><<<grid, THREADS, 0, stream>>>(hp, wp, sp, op, K, N, gs_half);
  if constexpr (KIND == Kind::W4A16) w4a16_kernel<R><<<grid, THREADS, 0, stream>>>(hp, wp, sp, op, K, N, gs_half);
  return cudaGetLastError();
}

template <Kind KIND>
int launch(const void* h, const void* w, const void* s, void* out, int rows, int K, int N,
           int gs_half, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: return (int)launch_rows<KIND, 1>(h, w, s, out, K, N, gs_half, st);
    case 2: return (int)launch_rows<KIND, 2>(h, w, s, out, K, N, gs_half, st);
    case 3: return (int)launch_rows<KIND, 3>(h, w, s, out, K, N, gs_half, st);
    case 4: return (int)launch_rows<KIND, 4>(h, w, s, out, K, N, gs_half, st);
    case 5: return (int)launch_rows<KIND, 5>(h, w, s, out, K, N, gs_half, st);
    case 6: return (int)launch_rows<KIND, 6>(h, w, s, out, K, N, gs_half, st);
    case 7: return (int)launch_rows<KIND, 7>(h, w, s, out, K, N, gs_half, st);
    case 8: return (int)launch_rows<KIND, 8>(h, w, s, out, K, N, gs_half, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool int4_shape_ok(int rows, int K, int N, int gs) {
  return rows >= 1 && rows <= MAX_ROWS && N >= 4 && N % 4 == 0 && gs >= 32 && gs % 32 == 0 &&
         K >= gs && K % gs == 0;
}

}  // namespace

// h bf16 [rows, K], w int8 [K, N], ws bf16 [N] -> out bf16 [rows, N].
extern "C" int xot_w8a8_matvec_bf16(const void* h, const void* w, const void* ws, void* out,
                                    int rows, int K, int N, void* stream) {
  if (rows < 1 || rows > MAX_ROWS || K < 4 || K % 4 != 0 || N < 4 || N % 4 != 0)
    return (int)cudaErrorInvalidValue;
  return launch<Kind::W8A8>(h, w, ws, out, rows, K, N, 0, stream);
}

// h bf16 [rows, K], w uint8 [K/gs, gs/2, N] packed nibbles, gscale bf16 [K/gs, N].
extern "C" int xot_w4a8_matvec_bf16(const void* h, const void* w, const void* gscale, void* out,
                                    int rows, int K, int N, int gs, void* stream) {
  if (!int4_shape_ok(rows, K, N, gs)) return (int)cudaErrorInvalidValue;
  return launch<Kind::W4A8>(h, w, gscale, out, rows, K, N, gs / 2, stream);
}

extern "C" int xot_w4a16_matvec_bf16(const void* h, const void* w, const void* gscale, void* out,
                                     int rows, int K, int N, int gs, void* stream) {
  if (!int4_shape_ok(rows, K, N, gs)) return (int)cudaErrorInvalidValue;
  return launch<Kind::W4A16>(h, w, gscale, out, rows, K, N, gs / 2, stream);
}
