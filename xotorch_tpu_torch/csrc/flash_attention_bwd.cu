// K1b: the gradient of K1 (flash_attention.cu), for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package trains through XLA, which differentiates
// xotorch_tpu/ops/attention.py::gqa_attention (xotorch_tpu/train/step.py:83-84 runs the
// forward with use_flash=False). This kernel computes that gradient for K1's function:
// causal grouped-query attention of one segment from position 0 over its own K/V, with
// the per-layer window (query t sees keys (t - window, t]), the tanh softcap
// (s = c * tanh(x / c), whose derivative is 1 - tanh^2) and the score scale. dK and dV
// are summed over each kv head's query group, since every query head of the group read
// the same K/V rows.
//
// Algorithm (FlashAttention-2's backward, without atomics):
//   delta = rowsum(dO o O), lse = the row's log-sum-exp of the scores;
//   P = exp(S - lse), dV = P^T dO, dS = P o (dO V^T - delta) (o (1 - tanh^2)),
//   dQ = scale * dS K, dK = scale * dS^T Q.
// Two device kernels a call, one launch count:
//   flash_bwd_dq_kernel: one block holds ROWS query rows of one (batch row, kv head),
//     flattened as positions x groups like K1. Pass 1 walks the visible key tiles for the
//     rows' log-sum-exp (written out for the second kernel, with delta); pass 2 walks
//     them again for P and dS and accumulates dQ in registers.
//   flash_bwd_dkdv_kernel: one block holds KT keys of one (batch row, kv head) and walks
//     the query-row tiles that see them, accumulating dK and dV in registers.
// Each score tile is computed twice (once per kernel) so that no block sums into
// another's output: no atomics, the same bits every run.
//
// What bounds it: about 5 products of 2 * B * Hq * T^2 / 2 * D operations (S, dP, dV, dK,
// dQ; causal halves the square) on inputs read once, so at training lengths it is bound
// by operations. This first version runs them on CUDA cores in fp32 (bf16 tiles in
// shared memory, 4 x 4 register tiles a thread, fp32 accumulation, one bf16 rounding of
// each output), two blocks of 256 threads an SM at most: simple and right first. The
// tensor-core version (wgmma, TMA, the dQ sum across key tiles) is ROADMAP work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // 16 x 16: tx = tid % 16 walks columns, ty = tid / 16 rows
constexpr int ROWS = 64;      // query rows of a tile (positions x groups)
constexpr int KT = 64;        // keys of a tile

template <int D>
struct Geo {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "head_dim 16..128 in steps of 16");
  // bf16 row stride in shared memory: D / 2 + 1 words, odd, so the 16 rows that a
  // half-warp reads at one column fall on 16 distinct banks.
  static constexpr int DS = D + 2;
  static constexpr int PS = KT + 1;  // fp32 row stride of a P or dS tile
  static constexpr int DJ = D / 16;  // head columns a thread accumulates: tx + 16 j
};

__device__ __forceinline__ size_t head_offset(int b, int t, int T, int heads, int h, int D) {
  return (((size_t)b * T + t) * heads + h) * D;
}

// Query rows [r0, r0 + ROWS) of (b, kvh) from src [B, T, Hq, D] into dst [ROWS][DS];
// rows past n_rows are zeros.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* __restrict__ src, int r0,
                                          int n_rows, int T, int Hq, int groups, int kvh,
                                          int b) {
  constexpr int W = D / 2;  // 32-bit words a row
  for (int i = threadIdx.x; i < ROWS * W; i += THREADS) {
    const int r = i / W, c = i % W, row = r0 + r;
    uint32_t val = 0u;
    if (row < n_rows) {
      const bf16* p = src + head_offset(b, row / groups, T, Hq, kvh * groups + row % groups, D);
      val = reinterpret_cast<const uint32_t*>(p)[c];
    }
    reinterpret_cast<uint32_t*>(dst + r * Geo<D>::DS)[c] = val;
  }
}

// Keys [k0, k0 + KT) of (b, kvh) from src [B, T, Hkv, D] into dst [KT][DS]; positions
// past T are zeros.
template <int D>
__device__ __forceinline__ void load_keys(bf16* dst, const bf16* __restrict__ src, int k0, int T,
                                          int Hkv, int kvh, int b) {
  constexpr int W = D / 2;
  for (int i = threadIdx.x; i < KT * W; i += THREADS) {
    const int j = i / W, c = i % W, s = k0 + j;
    uint32_t val = 0u;
    if (s < T) val = reinterpret_cast<const uint32_t*>(src + head_offset(b, s, T, Hkv, kvh, D))[c];
    reinterpret_cast<uint32_t*>(dst + j * Geo<D>::DS)[c] = val;
  }
}

// acc[i][j] = a[ty + 16 i] . m[tx + 16 j] over the head dimension, both [rows][DS] bf16
// tiles in shared memory, in fp32.
template <int D>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const bf16* a, const bf16* m) {
  constexpr int DS = Geo<D>::DS;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 2) {
    float2 av[4], mv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a + (ty + 16 * i) * DS + d));
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mv[j] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(m + (tx + 16 * j) * DS + d));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i].y, mv[j].y, fmaf(av[i].x, mv[j].x, acc[i][j]));
  }
}

// The score of a raw product x = q.k in natural units, with the softcap's derivative in
// *fac (1 without a softcap).
__device__ __forceinline__ float score(float x, float scale, float softcap, float* fac) {
  x *= scale;
  if (softcap > 0.f) {
    const float th = tanhf(x / softcap);
    *fac = 1.f - th * th;
    return th * softcap;
  }
  *fac = 1.f;
  return x;
}

__device__ __forceinline__ bool visible(int row, int n_rows, int groups, int key, int window) {
  if (row >= n_rows) return false;
  const int t = row / groups;
  return key <= t && (window <= 0 || key > t - window);
}

// Max and sum over the 16 lanes of a half-warp (one row's columns).
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t dq_smem() {
  return (size_t)(2 * ROWS + 2 * KT) * Geo<D>::DS * sizeof(bf16) +
         ((size_t)ROWS * Geo<D>::PS + 2 * ROWS) * sizeof(float);
}

template <int D>
constexpr size_t dkdv_smem() {
  return dq_smem<D>() + (size_t)ROWS * Geo<D>::PS * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, bf16* __restrict__ dq,
    float* __restrict__ lse_out, float* __restrict__ delta_out, int T, int Hq, int Hkv,
    int window, float scale, float softcap) {
  using G = Geo<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + ROWS * G::DS;
  bf16* ks = dos + ROWS * G::DS;
  bf16* vs = ks + KT * G::DS;
  float* ps = reinterpret_cast<float*>(vs + KT * G::DS);
  float* lse_s = ps + ROWS * G::PS;
  float* del_s = lse_s + ROWS;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16, warp = tid / 32, lane = tid % 32;
  const int groups = Hq / Hkv, kvh = blockIdx.y, b = blockIdx.z;
  const int n_rows = T * groups;
  const int r0 = (int)(gridDim.x - 1 - blockIdx.x) * ROWS;  // the heaviest rows first
  const int r_last = min(r0 + ROWS, n_rows) - 1;
  const int hi = r_last / groups + 1;  // keys past the last row's position are never seen
  const int lo = window > 0 ? max(0, r0 / groups - window + 1) : 0;

  load_rows<D>(qs, q, r0, n_rows, T, Hq, groups, kvh, b);
  load_rows<D>(dos, dout, r0, n_rows, T, Hq, groups, kvh, b);
  // delta = rowsum(dO o O), one warp a row.
  for (int r = warp; r < ROWS; r += THREADS / 32) {
    const int row = r0 + r;
    float s = 0.f;
    if (row < n_rows) {
      const size_t off = head_offset(b, row / groups, T, Hq, kvh * groups + row % groups, D);
      for (int d = lane; d < D; d += 32)
        s += __bfloat162float(o[off + d]) * __bfloat162float(dout[off + d]);
    }
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) s += __shfl_xor_sync(0xffffffffu, s, x);
    if (lane == 0) del_s[r] = s;
  }

  // Pass 1: each row's running max and sum of exp over the visible keys.
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  for (int k0 = lo; k0 < hi; k0 += KT) {
    __syncthreads();  // the tile before is consumed
    load_keys<D>(ks, k, k0, T, Hkv, kvh, b);
    __syncthreads();
    float s[4][4];
    dot_tile<D>(s, qs, ks);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float fac, mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(r0 + ty + 16 * i, n_rows, groups, k0 + tx + 16 * j, window)
                      ? score(s[i][j], scale, softcap, &fac) : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], max16(mx));
      const float base = mn == -INFINITY ? 0.f : mn;  // no key seen yet: every term is 0
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += __expf(s[i][j] - base);
      l[i] = l[i] * __expf(m[i] - base) + sum16(sum);
      m[i] = mn;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty + 16 * i;
      // A pad row has no key: an infinite lse makes each of its P exactly 0.
      const float lse = l[i] > 0.f ? m[i] + __logf(l[i]) : INFINITY;
      lse_s[ty + 16 * i] = lse;
      if (row < n_rows) {
        const size_t at = ((size_t)b * T + row / groups) * Hq + kvh * groups + row % groups;
        lse_out[at] = lse;
        delta_out[at] = del_s[ty + 16 * i];
      }
    }
  }

  // Pass 2: P and dS a tile, dQ += dS K.
  float acc[4][G::DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < G::DJ; ++jj) acc[i][jj] = 0.f;
  for (int k0 = lo; k0 < hi; k0 += KT) {
    __syncthreads();
    load_keys<D>(ks, k, k0, T, Hkv, kvh, b);
    load_keys<D>(vs, v, k0, T, Hkv, kvh, b);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D>(s, qs, ks);
    dot_tile<D>(dp, dos, vs);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lse = lse_s[ty + 16 * i], del = del_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float fac;
        const float x = score(s[i][j], scale, softcap, &fac);
        const float p = visible(r0 + ty + 16 * i, n_rows, groups, k0 + tx + 16 * j, window)
                            ? __expf(x - lse) : 0.f;
        ps[(ty + 16 * i) * G::PS + tx + 16 * j] = p * (dp[i][j] - del) * fac;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < KT; ++kk) {
      float a[4], kv[G::DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ps[(ty + 16 * i) * G::PS + kk];
#pragma unroll
      for (int jj = 0; jj < G::DJ; ++jj) kv[jj] = __bfloat162float(ks[kk * G::DS + tx + 16 * jj]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < G::DJ; ++jj) acc[i][jj] = fmaf(a[i], kv[jj], acc[i][jj]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= n_rows) continue;
    bf16* dst = dq + head_offset(b, row / groups, T, Hq, kvh * groups + row % groups, D);
#pragma unroll
    for (int jj = 0; jj < G::DJ; ++jj) dst[tx + 16 * jj] = __float2bfloat16(acc[i][jj] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int Hq, int Hkv, int window,
    float scale, float softcap) {
  using G = Geo<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + ROWS * G::DS;
  bf16* ks = dos + ROWS * G::DS;
  bf16* vs = ks + KT * G::DS;
  float* ps = reinterpret_cast<float*>(vs + KT * G::DS);
  float* lse_s = ps + ROWS * G::PS;
  float* del_s = lse_s + ROWS;
  float* dss = del_s + ROWS;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int groups = Hq / Hkv, kvh = blockIdx.y, b = blockIdx.z;
  const int n_rows = T * groups;
  const int k0 = blockIdx.x * KT;  // the first key tiles have the most rows: they go first
  const int k_last = min(k0 + KT, T) - 1;
  // Query positions that see a key of the tile: [k0, k_last + window - 1] with a window.
  const int p_hi = window > 0 ? min(T - 1, k_last + window - 1) : T - 1;

  load_keys<D>(ks, k, k0, T, Hkv, kvh, b);
  load_keys<D>(vs, v, k0, T, Hkv, kvh, b);

  float dkacc[4][G::DJ], dvacc[4][G::DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < G::DJ; ++jj) dkacc[i][jj] = dvacc[i][jj] = 0.f;

  for (int r0 = k0 * groups; r0 < (p_hi + 1) * groups; r0 += ROWS) {
    __syncthreads();  // the row tile before is consumed
    load_rows<D>(qs, q, r0, n_rows, T, Hq, groups, kvh, b);
    load_rows<D>(dos, dout, r0, n_rows, T, Hq, groups, kvh, b);
    for (int r = tid; r < ROWS; r += THREADS) {
      const int row = r0 + r;
      const size_t at = ((size_t)b * T + row / groups) * Hq + kvh * groups + row % groups;
      lse_s[r] = row < n_rows ? lse[at] : INFINITY;
      del_s[r] = row < n_rows ? delta[at] : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D>(s, qs, ks);   // [query row ty + 16 i][key tx + 16 j]
    dot_tile<D>(dp, dos, vs);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float l = lse_s[ty + 16 * i], del = del_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float fac;
        const float x = score(s[i][j], scale, softcap, &fac);
        const float p = visible(r0 + ty + 16 * i, n_rows, groups, k0 + tx + 16 * j, window)
                            ? __expf(x - l) : 0.f;
        ps[(ty + 16 * i) * G::PS + tx + 16 * j] = p;
        dss[(ty + 16 * i) * G::PS + tx + 16 * j] = p * (dp[i][j] - del) * fac;
      }
    }
    __syncthreads();
    // dV[key ty + 16 i] += P[r][key] dO[r], dK[key] += dS[r][key] Q[r], columns tx + 16 jj.
    for (int r = 0; r < ROWS; ++r) {
      float pr[4], dr[4], dov[G::DJ], qv[G::DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = ps[r * G::PS + ty + 16 * i];
        dr[i] = dss[r * G::PS + ty + 16 * i];
      }
#pragma unroll
      for (int jj = 0; jj < G::DJ; ++jj) {
        dov[jj] = __bfloat162float(dos[r * G::DS + tx + 16 * jj]);
        qv[jj] = __bfloat162float(qs[r * G::DS + tx + 16 * jj]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < G::DJ; ++jj) {
          dvacc[i][jj] = fmaf(pr[i], dov[jj], dvacc[i][jj]);
          dkacc[i][jj] = fmaf(dr[i], qv[jj], dkacc[i][jj]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= T) continue;
    const size_t off = head_offset(b, s, T, Hkv, kvh, D);
#pragma unroll
    for (int jj = 0; jj < G::DJ; ++jj) {
      dk[off + tx + 16 * jj] = __float2bfloat16(dkacc[i][jj] * scale);
      dv[off + tx + 16 * jj] = __float2bfloat16(dvacc[i][jj]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, void* lse, void* delta, int B, int T, int Hq, int Hkv,
           int window, float scale, float softcap, cudaStream_t stream) {
  static_assert(dkdv_smem<D>() <= 227 * 1024, "shared memory of one block");
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dq_smem<D>());
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkdv_smem<D>());
  if (err != cudaSuccess) return (int)err;
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* db = static_cast<const bf16*>(dout);
  const long long rows = (long long)T * (Hq / Hkv);
  dim3 grid_q((unsigned)((rows + ROWS - 1) / ROWS), Hkv, B);
  flash_bwd_dq_kernel<D><<<grid_q, THREADS, dq_smem<D>(), stream>>>(
      qb, kb, vb, static_cast<const bf16*>(o), db, static_cast<bf16*>(dq),
      static_cast<float*>(lse), static_cast<float*>(delta), T, Hq, Hkv, window, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_k((unsigned)((T + KT - 1) / KT), Hkv, B);
  flash_bwd_dkdv_kernel<D><<<grid_k, THREADS, dkdv_smem<D>(), stream>>>(
      qb, kb, vb, db, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, Hq, Hkv, window, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq [B, T, Hq, D]; k, v, dk, dv [B, T, Hkv, D]: contiguous bf16 on the device.
// lse and delta: fp32 scratch of B * T * Hq values each (the first kernel writes them,
// the second reads them). D in {16, 32, 64, 128}. Returns a cudaError_t value: nonzero
// when the arguments are refused or a launch failed.
extern "C" int xot_flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                            const void* o, const void* dout, void* dq, void* dk,
                                            void* dv, void* lse, void* delta, int B, int T, int Hq,
                                            int Hkv, int D, int window, float scale,
                                            float softcap, void* stream) {
  if (B < 1 || T < 1 || Hkv < 1 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if ((long long)T * (Hq / Hkv) > 0x7fffffffLL - ROWS) return (int)cudaErrorInvalidValue;
  if (Hkv > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, T, Hq, Hkv, window, scale, softcap, s);
    case 32: return launch<32>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, T, Hq, Hkv, window, scale, softcap, s);
    case 64: return launch<64>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, T, Hq, Hkv, window, scale, softcap, s);
    case 128: return launch<128>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, T, Hq, Hkv, window, scale, softcap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
