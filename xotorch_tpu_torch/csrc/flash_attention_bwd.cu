// K1b: the gradient of K1 (flash_attention.cu), for Hopper (sm_90a), on the tensor cores.
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
// Algorithm (FlashAttention-2's backward, without atomics), in the forward's base-2 units:
//   lse = each row's log-sum-exp, written by K1's epilogue (attention_mma.cuh) and read
//   here, never recomputed; delta = rowsum(dO o O);
//   P = exp2(s2 - lse) with s2 the scaled (soft-capped) score times log2(e);
//   dV = P^T dO, dS = P o (dO V^T - delta) o (1 - tanh^2), dQ = scale dS K,
//   dK = scale dS^T Q.
// Two device kernels a call, one launch count:
//   flash_bwd_dq_kernel: one block holds 64 query rows of one (batch row, kv head),
//     flattened as positions x groups like K1 (so one K/V tile serves the whole query
//     group). Its prologue computes the rows' delta (written out for the second kernel).
//     K and V tiles stream through a two-stage cp.async ring; per tile S = Q K^T and
//     dP = dO V^T, then dS in registers, then dQ += dS K (K through ldmatrix.trans).
//   flash_bwd_dkdv_kernel: one block owns 64 keys of one (batch row, kv head), 16 a warp.
//     The query-row tiles that see those keys (Q, dO and their lse and delta) stream
//     through a two-stage ring; per tile S^T = K Q^T and dP^T = V dO^T with the keys as
//     the M dimension, then P^T and dS^T in registers, then dV += P^T dO and
//     dK += dS^T Q (dO and Q through ldmatrix.trans).
// P^T and dS^T (and dS) are rounded to bf16 in registers, where the fp32 accumulator
// fragments of one product are the A fragments of the next as they stand (as attend turns
// S into P): nothing goes through shared memory between products. Each score tile is
// computed twice (once per kernel, 7 products where dQ atomics would need 5) so that no
// block sums into another's output: no atomics, the same bits every run.
//
// What bounds it: 7 products of 2 D operations a visible (query head, key) pair, on
// inputs read once, so at training lengths it is bound by operations. Every product is
// mma.sync.m16n8k16 bf16 -> fp32 on the tensor cores. Tiles that no row of a warp sees are
// skipped, and only tiles that cross a diagonal or a window edge are masked, as in K1.
//
// Registers. The warp's fragments of K and V (dK/dV kernel) stay in registers beside the
// accumulators up to D = 64, those of Q and dO (dQ kernel) up to D = 32; above, they are
// re-read from shared memory each tile (at D = 64 that takes the dQ kernel from 192
// registers to 167, three blocks an SM, and 28 % off its time on the H100). At D = 256
// one warp's 16 x 256 fp32 accumulator is 128 registers a thread, so dK and dV do not
// both fit: the dK/dV kernel splits the head columns over two blocks a key tile, each
// recomputing S^T and dP^T over the full D and accumulating 128 columns of dK and of dV;
// the dQ kernel takes 32-key tiles there.
#include "attention_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using xot_mma::cp_async16;
using xot_mma::exp2_fast;
using xot_mma::ldmatrix_x4;
using xot_mma::ldmatrix_x4_trans;
using xot_mma::mma_bf16;
using xot_mma::pack_bf16;

// 4 bytes from global to shared memory; zeros when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(xot_mma::smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Index of flattened row `row` (position row / groups, query head kvh * groups + row %
// groups) of batch row b in a [B, T, Hq] tensor; times D, its head vector in [B, T, Hq, D].
__device__ __forceinline__ size_t row_index(int b, int T, int Hq, int groups, int kvh, int row) {
  return ((size_t)b * T + row / groups) * Hq + (size_t)kvh * groups + row % groups;
}

// The score of a raw product x = q.k in the forward's base-2 units, with the softcap's
// derivative 1 - tanh^2 in *fac (1 without a softcap). pre and post as in attend.
__device__ __forceinline__ float score2(float x, float pre, float post, bool capped, float* fac) {
  if (capped) {
    const float th = tanhf(x * pre);
    *fac = 1.f - th * th;
    return th * post;
  }
  *fac = 1.f;
  return x * pre;
}

// The A fragment of a 16 x 16 slice from two fp32 accumulator n-tiles (columns 16 i to
// 16 i + 7 and 16 i + 8 to 16 i + 15), rounded to bf16.
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4], const float (&lo)[4],
                                           const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// The lane's ldmatrix row address for the B fragments of 16 rows x 16 columns of a
// row-major [n][k] tile (the "col" operand as it stands: K for S = Q K^T) ...
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int b_col(int lane) { return ((lane >> 3) & 1) * 8; }
// ... and of a row-major [k][n] tile read transposed (V for O = P V).
__device__ __forceinline__ int bt_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int bt_col(int lane) { return (lane >> 4) * 8; }

// ------------------------------------------------------------------------ dQ kernel

template <int D>
struct DqShape {
  static constexpr int ROWS = 64;  // query rows a block, 16 a warp
  static constexpr int THREADS = ROWS * 2;
  static constexpr int KT = D <= 128 ? 64 : 32;  // keys a tile
  static constexpr bool Q_REG = D <= 32;         // Q and dO fragments in registers
  static constexpr int DS = D + 8;
  static constexpr int STAGE = 2 * KT * DS;  // K tile, then V tile
  static constexpr size_t SMEM = (2 * (size_t)ROWS * DS + 2 * STAGE) * sizeof(bf16) +
                                 ROWS * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(DqShape<D>::THREADS) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    bf16* __restrict__ dq, float* __restrict__ delta, int T, int Hq, int Hkv, int window,
    float scale, float softcap) {
  using S = DqShape<D>;
  constexpr int DS = S::DS, KT = S::KT, ROWS = S::ROWS, CH = D / 8;
  constexpr int NK = KT / 8;  // S and dP n-tiles a tile
  constexpr int ND = D / 8;   // dQ n-tiles
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + ROWS * DS;
  bf16* stage0 = dos + ROWS * DS;
  bf16* stage1 = stage0 + S::STAGE;
  float* del_s = reinterpret_cast<float*>(stage1 + S::STAGE);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int groups = Hq / Hkv, kvh = blockIdx.y, b = blockIdx.z;
  const int n_rows = T * groups;
  const int row0 = (int)(gridDim.x - 1 - blockIdx.x) * ROWS;  // the heaviest rows first
  const int r_last = min(row0 + ROWS, n_rows) - 1;
  const int hi = r_last / groups + 1;  // keys past the last row's position are never seen
  int lo = window > 0 ? max(0, row0 / groups - window + 1) : 0;
  lo -= lo % KT;
  const size_t rs = (size_t)Hkv * D;  // elements between positions of K/V
  const bf16* kb = k + (size_t)b * T * rs + (size_t)kvh * D;
  const bf16* vb = v + (size_t)b * T * rs + (size_t)kvh * D;
  const auto key_off = [&](int k0) { return [=](int j) { return (size_t)(k0 + j) * rs; }; };

  // Q and dO rows, and tile lo, land while delta is computed.
  for (int i = tid; i < ROWS * CH; i += S::THREADS) {
    const int r = i / CH, c = i % CH, row = row0 + r;
    const bool ok = row < n_rows;
    const size_t off = ok ? row_index(b, T, Hq, groups, kvh, row) * D + 8 * c : 0;
    cp_async16(qs + r * DS + 8 * c, q + off, ok);
    cp_async16(dos + r * DS + 8 * c, dout + off, ok);
  }
  xot_mma::stage_tile<D, KT, S::THREADS>(stage0, stage0 + KT * DS, kb, vb, lo, 0, hi, key_off(lo));
  xot_mma::cp_async_commit();
  // delta = rowsum(dO o O) in fp32, one warp a row.
  for (int r = warp; r < ROWS; r += S::THREADS / 32) {
    const int row = row0 + r;
    float s = 0.f;
    if (row < n_rows) {
      const size_t off = row_index(b, T, Hq, groups, kvh, row) * D;
      for (int d = 2 * lane; d < D; d += 64) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + off + d));
        const float2 g = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + off + d));
        s = fmaf(a.x, g.x, fmaf(a.y, g.y, s));
      }
    }
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) s += __shfl_xor_sync(0xffffffffu, s, x);
    if (lane == 0) {
      del_s[r] = s;
      if (row < n_rows) delta[row_index(b, T, Hq, groups, kvh, row)] = s;
    }
  }
  xot_mma::cp_async_wait<0>();
  __syncthreads();

  // The warp's rows, and the two rows this lane holds (quad row g and g + 8).
  const int wr0 = row0 + 16 * warp;
  const bool active = wr0 <= r_last;
  const int wp_min = wr0 / groups;
  const int wp_max = min(wr0 + 15, r_last) / groups;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int ra = wr0 + g, rb = ra + 8;
  const int pa = ra <= r_last ? ra / groups : -1;  // -1: no key is visible
  const int pb = rb <= r_last ? rb / groups : -1;
  const float lse_a = ra <= r_last ? lse[row_index(b, T, Hq, groups, kvh, ra)] : INFINITY;
  const float lse_b = rb <= r_last ? lse[row_index(b, T, Hq, groups, kvh, rb)] : INFINITY;
  const float del_a = del_s[16 * warp + g], del_b = del_s[16 * warp + g + 8];

  const int frag = (16 * warp + (lane & 15)) * DS + (lane >> 4) * 8;
  uint32_t qa[S::Q_REG ? D / 16 : 1][4], da[S::Q_REG ? D / 16 : 1][4];
  if (S::Q_REG && active) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      ldmatrix_x4(qa[kk], qs + frag + 16 * kk);
      ldmatrix_x4(da[kk], dos + frag + 16 * kk);
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const bool capped = softcap > 0.f;
  const float pre = capped ? scale / softcap : scale * xot_mma::LOG2E;
  const float post = softcap * xot_mma::LOG2E;

  int it = 0;
  for (int k0 = lo; k0 < hi; k0 += KT, ++it) {
    bf16* cur = (it & 1) ? stage1 : stage0;
    if (k0 + KT < hi) {
      bf16* nxt = (it & 1) ? stage0 : stage1;
      xot_mma::stage_tile<D, KT, S::THREADS>(nxt, nxt + KT * DS, kb, vb, k0 + KT, 0, hi,
                                             key_off(k0 + KT));
      xot_mma::cp_async_commit();
      xot_mma::cp_async_wait<1>();
    } else {
      xot_mma::cp_async_wait<0>();
    }
    __syncthreads();  // tile k0 has landed for every thread

    const bool visible = active && k0 <= wp_max && !(window > 0 && k0 + KT - 1 <= wp_min - window);
    if (visible) {
      const bf16* ks = cur;
      const bf16* vs = cur + KT * DS;
      // 16-key slices that hold a key at or below the warp's last diagonal.
      const int n16 = min(KT / 16, (wp_max - k0) / 16 + 1);
      float s[NK][4], dp[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qk[4], dk[4];
        if constexpr (S::Q_REG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qk[e] = qa[kk][e], dk[e] = da[kk][e];
        } else {
          ldmatrix_x4(qk, qs + frag + 16 * kk);
          ldmatrix_x4(dk, dos + frag + 16 * kk);
        }
#pragma unroll
        for (int jn = 0; jn < KT / 16; ++jn) {
          if (jn < n16) {
            const int at = (16 * jn + b_row(lane)) * DS + 16 * kk + b_col(lane);
            uint32_t kf[4], vf[4];
            ldmatrix_x4(kf, ks + at);
            mma_bf16(s[2 * jn], qk, kf[0], kf[1]);
            mma_bf16(s[2 * jn + 1], qk, kf[2], kf[3]);
            ldmatrix_x4(vf, vs + at);
            mma_bf16(dp[2 * jn], dk, vf[0], vf[1]);
            mma_bf16(dp[2 * jn + 1], dk, vf[2], vf[3]);
          }
        }
      }

      // dS = P o (dP - delta) o (1 - tanh^2) in place of S; masked only where a diagonal
      // or a window edge crosses the warp's rows (slices past n16 lie above every
      // diagonal: masked here, and skipped below).
      const bool mask = k0 + KT - 1 > wp_min || (window > 0 && k0 <= wp_max - window);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float fac;
          const float x = score2(s[j][e], pre, post, capped, &fac);
          float p = exp2_fast(x - (e < 2 ? lse_a : lse_b));
          if (mask) {
            const int key = k0 + 8 * j + c2 + (e & 1);
            const int pos = e < 2 ? pa : pb;
            if (key > pos || (window > 0 && key <= pos - window)) p = 0.f;
          }
          s[j][e] = p * (dp[j][e] - (e < 2 ? del_a : del_b)) * fac;
        }
      }

      // dQ += dS K: S n-tiles 2i and 2i + 1 are the A fragment of keys [16i, 16i + 16);
      // K's B fragments come from ldmatrix.trans, so K stays [keys, D].
#pragma unroll
      for (int i = 0; i < KT / 16; ++i) {
        if (i < n16) {
          uint32_t sa[4];
          a_fragment(sa, s[2 * i], s[2 * i + 1]);
#pragma unroll
          for (int dn = 0; dn < D / 16; ++dn) {
            uint32_t kf[4];
            ldmatrix_x4_trans(kf, ks + (16 * i + bt_row(lane)) * DS + 16 * dn + bt_col(lane));
            mma_bf16(acc[2 * dn], sa, kf[0], kf[1]);
            mma_bf16(acc[2 * dn + 1], sa, kf[2], kf[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is consumed: the next prefetch may overwrite it
  }

  if (active && ra <= r_last) {
    uint32_t* out = reinterpret_cast<uint32_t*>(dq + row_index(b, T, Hq, groups, kvh, ra) * D + c2);
#pragma unroll
    for (int n = 0; n < ND; ++n) out[4 * n] = pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
  }
  if (active && rb <= r_last) {
    uint32_t* out = reinterpret_cast<uint32_t*>(dq + row_index(b, T, Hq, groups, kvh, rb) * D + c2);
#pragma unroll
    for (int n = 0; n < ND; ++n) out[4 * n] = pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// --------------------------------------------------------------------- dK/dV kernel

template <int D>
struct DkdvShape {
  static constexpr int KB = 64;  // keys a block, 16 a warp
  static constexpr int THREADS = KB * 2;
  static constexpr int QR = D <= 64 ? 64 : 32;   // query rows a streamed tile
  static constexpr int DH = D <= 128 ? D : 128;  // dK and dV columns a block accumulates
  static constexpr int HALVES = D / DH;          // blocks a key tile
  static constexpr bool KV_REG = D <= 64;        // K and V fragments in registers
  static constexpr int DS = D + 8;
  static constexpr int STAGE = 2 * QR * DS;  // Q tile, then dO tile
  static constexpr size_t SMEM = (2 * (size_t)KB * DS + 2 * STAGE) * sizeof(bf16) +
                                 2 * 2 * QR * sizeof(float);
};

// Query rows [r0, r0 + QR) of (b, kvh): Q and dO into qs and ds ([QR][D + 8] bf16), their
// lse and delta into ls and dl; rows past n_rows are zeros.
template <int D, int QR, int THREADS>
__device__ __forceinline__ void stage_rows(bf16* qs, bf16* ds, float* ls, float* dl,
                                           const bf16* __restrict__ q,
                                           const bf16* __restrict__ dout,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta, int r0, int n_rows,
                                           int T, int Hq, int groups, int kvh, int b) {
  constexpr int CH = D / 8, DS = D + 8;
  for (int i = threadIdx.x; i < QR * CH; i += THREADS) {
    const int r = i / CH, c = i % CH, row = r0 + r;
    const bool ok = row < n_rows;
    const size_t off = ok ? row_index(b, T, Hq, groups, kvh, row) * D + 8 * c : 0;
    cp_async16(qs + r * DS + 8 * c, q + off, ok);
    cp_async16(ds + r * DS + 8 * c, dout + off, ok);
  }
  for (int r = threadIdx.x; r < QR; r += THREADS) {
    const int row = r0 + r;
    const bool ok = row < n_rows;
    const size_t at = ok ? row_index(b, T, Hq, groups, kvh, row) : 0;
    cp_async4(ls + r, lse + at, ok);
    cp_async4(dl + r, delta + at, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(DkdvShape<D>::THREADS) flash_bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int Hq, int Hkv, int window,
    float scale, float softcap) {
  using S = DkdvShape<D>;
  constexpr int DS = S::DS, QR = S::QR, DH = S::DH, KB = S::KB;
  constexpr int NQ = QR / 8;   // S^T and dP^T n-tiles (query rows) a tile
  constexpr int NH = DH / 8;   // dK and dV n-tiles
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + KB * DS;
  bf16* stage0 = vs + KB * DS;
  float* fl = reinterpret_cast<float*>(stage0 + 2 * S::STAGE);  // per stage: lse, delta

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int groups = Hq / Hkv, kvh = blockIdx.y, b = blockIdx.z;
  const int n_rows = T * groups;
  const int k0 = (int)(blockIdx.x / S::HALVES) * KB;  // the first keys have the most rows: first
  const int col0 = (int)(blockIdx.x % S::HALVES) * DH;
  const int k_last = min(k0 + KB, T) - 1;
  // Query positions that see a key of the block: [k0, k_last + window - 1] with a window.
  const int p_hi = window > 0 ? min(T - 1, k_last + window - 1) : T - 1;
  const int r_begin = k0 * groups, r_end = (p_hi + 1) * groups;
  const size_t rs = (size_t)Hkv * D;
  const bf16* kb = k + (size_t)b * T * rs + (size_t)kvh * D;
  const bf16* vb = v + (size_t)b * T * rs + (size_t)kvh * D;

  xot_mma::stage_tile<D, KB, S::THREADS>(ks, vs, kb, vb, k0, 0, T,
                                         [&](int j) { return (size_t)(k0 + j) * rs; });
  stage_rows<D, QR, S::THREADS>(stage0, stage0 + QR * DS, fl, fl + QR, q, dout, lse, delta,
                                r_begin, n_rows, T, Hq, groups, kvh, b);
  xot_mma::cp_async_commit();
  xot_mma::cp_async_wait<0>();
  __syncthreads();

  // The warp's 16 keys, and the two keys this lane holds (quad row g and g + 8).
  const int wk0 = k0 + 16 * warp, wk1 = wk0 + 15;
  const bool active = wk0 < T;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int key_a = wk0 + g, key_b = key_a + 8;
  const int frag = (16 * warp + (lane & 15)) * DS + (lane >> 4) * 8;
  uint32_t ka[S::KV_REG ? D / 16 : 1][4], va[S::KV_REG ? D / 16 : 1][4];
  if (S::KV_REG && active) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      ldmatrix_x4(ka[kk], ks + frag + 16 * kk);
      ldmatrix_x4(va[kk], vs + frag + 16 * kk);
    }
  }

  float dka[NH][4], dva[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }
  const bool capped = softcap > 0.f;
  const float pre = capped ? scale / softcap : scale * xot_mma::LOG2E;
  const float post = softcap * xot_mma::LOG2E;

  int it = 0;
  for (int r0 = r_begin; r0 < r_end; r0 += QR, ++it) {
    bf16* cur = stage0 + (it & 1) * S::STAGE;
    const float* lcur = fl + (it & 1) * 2 * QR;
    if (r0 + QR < r_end) {
      bf16* nxt = stage0 + ((it + 1) & 1) * S::STAGE;
      float* lnxt = fl + ((it + 1) & 1) * 2 * QR;
      stage_rows<D, QR, S::THREADS>(nxt, nxt + QR * DS, lnxt, lnxt + QR, q, dout, lse, delta,
                                    r0 + QR, n_rows, T, Hq, groups, kvh, b);
      xot_mma::cp_async_commit();
      xot_mma::cp_async_wait<1>();
    } else {
      xot_mma::cp_async_wait<0>();
    }
    __syncthreads();  // row tile r0 has landed for every thread

    // The tile's query positions: t_min to t_max (rows past n_rows are none).
    const int t_min = r0 / groups;
    const int t_max = (min(r0 + QR, n_rows) - 1) / groups;
    const bool visible = active && t_max >= wk0 && !(window > 0 && wk1 <= t_min - window);
    if (visible) {
      const bf16* qt = cur;
      const bf16* dt = cur + QR * DS;
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
        dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
      }
      // S^T = K Q^T and dP^T = V dO^T: the Q and dO tiles are [rows, D], the "col"
      // operand as they stand.
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kf[4], vf[4];
        if constexpr (S::KV_REG) {
#pragma unroll
          for (int e = 0; e < 4; ++e) kf[e] = ka[kk][e], vf[e] = va[kk][e];
        } else {
          ldmatrix_x4(kf, ks + frag + 16 * kk);
          ldmatrix_x4(vf, vs + frag + 16 * kk);
        }
#pragma unroll
        for (int jn = 0; jn < QR / 16; ++jn) {
          const int at = (16 * jn + b_row(lane)) * DS + 16 * kk + b_col(lane);
          uint32_t qf[4], df[4];
          ldmatrix_x4(qf, qt + at);
          mma_bf16(st[2 * jn], kf, qf[0], qf[1]);
          mma_bf16(st[2 * jn + 1], kf, qf[2], qf[3]);
          ldmatrix_x4(df, dt + at);
          mma_bf16(dpt[2 * jn], vf, df[0], df[1]);
          mma_bf16(dpt[2 * jn + 1], vf, df[2], df[3]);
        }
      }

      // P^T in place of S^T, dS^T in place of dP^T. Masked where a row's diagonal or
      // window edge crosses the warp's keys, or the tile runs past the last row.
      const bool mask = t_min < wk1 || (window > 0 && wk0 <= t_max - window) ||
                        r0 + QR > n_rows;
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + c2 + (e & 1);  // the query row within the tile
          float fac;
          const float x = score2(st[j][e], pre, post, capped, &fac);
          float p = exp2_fast(x - lcur[col]);
          if (mask) {
            const int row = r0 + col, pos = row / groups, key = e < 2 ? key_a : key_b;
            if (row >= n_rows || key > pos || (window > 0 && key <= pos - window)) p = 0.f;
          }
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - lcur[QR + col]) * fac;
        }
      }

      // dV += P^T dO and dK += dS^T Q over the tile's rows, 16 at a time: n-tiles 2i and
      // 2i + 1 are the A fragment of rows [16i, 16i + 16); dO's and Q's B fragments come
      // from ldmatrix.trans (columns col0 to col0 + DH).
#pragma unroll
      for (int i = 0; i < QR / 16; ++i) {
        uint32_t pa[4], sa[4];
        a_fragment(pa, st[2 * i], st[2 * i + 1]);
        a_fragment(sa, dpt[2 * i], dpt[2 * i + 1]);
#pragma unroll
        for (int dn = 0; dn < DH / 16; ++dn) {
          const int at = (16 * i + bt_row(lane)) * DS + col0 + 16 * dn + bt_col(lane);
          uint32_t of[4], qf[4];
          ldmatrix_x4_trans(of, dt + at);
          mma_bf16(dva[2 * dn], pa, of[0], of[1]);
          mma_bf16(dva[2 * dn + 1], pa, of[2], of[3]);
          ldmatrix_x4_trans(qf, qt + at);
          mma_bf16(dka[2 * dn], sa, qf[0], qf[1]);
          mma_bf16(dka[2 * dn + 1], sa, qf[2], qf[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed: the next prefetch may overwrite it
  }

  const size_t base = (size_t)b * T * rs + (size_t)kvh * D + col0 + c2;
  if (active && key_a < T) {
    uint32_t* ko = reinterpret_cast<uint32_t*>(dk + base + (size_t)key_a * rs);
    uint32_t* vo = reinterpret_cast<uint32_t*>(dv + base + (size_t)key_a * rs);
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      ko[4 * n] = pack_bf16(dka[n][0] * scale, dka[n][1] * scale);
      vo[4 * n] = pack_bf16(dva[n][0], dva[n][1]);
    }
  }
  if (active && key_b < T) {
    uint32_t* ko = reinterpret_cast<uint32_t*>(dk + base + (size_t)key_b * rs);
    uint32_t* vo = reinterpret_cast<uint32_t*>(dv + base + (size_t)key_b * rs);
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      ko[4 * n] = pack_bf16(dka[n][2] * scale, dka[n][3] * scale);
      vo[4 * n] = pack_bf16(dva[n][2], dva[n][3]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* dq, void* dk, void* dv, void* delta, int B, int T, int Hq,
           int Hkv, int window, float scale, float softcap, cudaStream_t stream) {
  using Q = DqShape<D>;
  using K = DkdvShape<D>;
  static_assert(Q::SMEM <= 227 * 1024 && K::SMEM <= 227 * 1024, "shared memory of one block");
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Q::SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)K::SMEM);
  if (err != cudaSuccess) return (int)err;
  const auto* qb = static_cast<const bf16*>(q);
  const auto* db = static_cast<const bf16*>(dout);
  const auto* lb = static_cast<const float*>(lse);
  const long long rows = (long long)T * (Hq / Hkv);
  // The dQ kernel writes delta, which the dK/dV kernel reads: the same stream orders them.
  dim3 grid_q((unsigned)((rows + Q::ROWS - 1) / Q::ROWS), Hkv, B);
  flash_bwd_dq_kernel<D><<<grid_q, Q::THREADS, Q::SMEM, stream>>>(
      qb, static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      db, lb, static_cast<bf16*>(dq), static_cast<float*>(delta), T, Hq, Hkv, window, scale,
      softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_k((unsigned)((T + K::KB - 1) / K::KB * K::HALVES), Hkv, B);
  flash_bwd_dkdv_kernel<D><<<grid_k, K::THREADS, K::SMEM, stream>>>(
      qb, static_cast<const bf16*>(k), static_cast<const bf16*>(v), db, lb,
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, Hq,
      Hkv, window, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq [B, T, Hq, D]; k, v, dk, dv [B, T, Hkv, D]: contiguous bf16 on the device.
// lse: fp32 [B, T, Hq], each row's log-sum-exp as K1 wrote it for this forward (base 2).
// delta: fp32 scratch of B * T * Hq values (the first kernel writes it, the second reads
// it). D in {16, 32, 64, 128, 256}. Returns a cudaError_t value: nonzero when the
// arguments are refused or a launch failed.
extern "C" int xot_flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                            const void* o, const void* dout, const void* lse,
                                            void* dq, void* dk, void* dv, void* delta, int B,
                                            int T, int Hq, int Hkv, int D, int window,
                                            float scale, float softcap, void* stream) {
  if (B < 1 || T < 1 || Hkv < 1 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if ((long long)T * (Hq / Hkv) > 0x7fffffffLL - 128) return (int)cudaErrorInvalidValue;
  if (Hkv > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, T, Hq, Hkv, window, scale, softcap, s);
    case 32: return launch<32>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, T, Hq, Hkv, window, scale, softcap, s);
    case 64: return launch<64>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, T, Hq, Hkv, window, scale, softcap, s);
    case 128: return launch<128>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, T, Hq, Hkv, window, scale, softcap, s);
    case 256: return launch<256>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, T, Hq, Hkv, window, scale, softcap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
