// The tensor-core tile core shared by K1 (flash_attention.cu::flash_prefill_kernel),
// K2/K2q's segments at T > 1 (flash_decode.cu::flash_cached_segment_kernel) and K4/K4q
// (paged_attention.cu::paged_prefill_kernel), for Hopper (sm_90a). The tile loaders
// (stage_tile, Kv8Tile) also feed the split-K decode core of decode_split.cuh.
//
// All three replace Pallas kernels whose two products run on the TPU's matrix unit
// with bf16 operands and fp32 accumulation (xotorch_tpu/ops/flash_attention.py::
// _flash_kernel, xotorch_tpu/ops/flash_decode.py::_cached_kernel,
// xotorch_tpu/ops/paged_attention.py::_paged_ragged_kernel), and all three attend a
// prefill segment: about 4 * rows * visible keys * D operations on inputs read once, so
// they are bound by operations. Here both products are warp-level
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 on the tensor cores.
//
// One block holds ROWS query rows of one (batch row, kv head): rows are the flattened
// (position, group) index t * groups + g, so every query head of the kv head shares each
// K/V tile. A warp owns 16 rows. Their Q fragments (ldmatrix.x4 from shared memory, once),
// their O accumulator (16 x D fp32) and each row's running max and sum stay in registers.
//
// A step over one KV tile (KT keys x D, bf16 in shared memory, rows padded to D + 8 so
// that the 8 row addresses of an ldmatrix fall on distinct banks):
//   S = Q.K^T: ldmatrix.x4 on K rows gives the B fragments (K is [keys, D], which is
//     the "col" operand as it stands); fp32 accumulators.
//   scale, the optional tanh softcap, then the visibility mask (causal and window; a
//     key past the valid length lies above every row's diagonal) on tiles that cross
//     one of the warp's diagonals or window edges only; a tile outside every row of
//     the warp is skipped, and so is each 16-key slice above the warp's last diagonal.
//   online softmax in base 2 on the fragments: a row lives on the 4 lanes of a quad, so
//     its max takes two __shfl_xor_sync; its sum stays partial per lane until the end.
//   P is rounded to bf16 in registers (JAX's p.astype(v.dtype)) and the S accumulator
//     fragments become the A fragments of O += P.V as they stand; V's B fragments come
//     from ldmatrix.trans, so V stays [keys, D] in shared memory.
// Tiles are double-buffered: cp.async.cg 16-byte copies of tile j + 1 land while tile j
// is computed (commit_group / wait_group). The epilogue keeps JAX's l == 0 -> 1 guard
// and rounds acc / l once to bf16; for K1's training forward it also writes each row's
// log-sum-exp (RowTile::lse), which the gradient kernels of flash_attention_bwd.cu read.
//
// Head width 256 (gemma-2's): a warp's 16 x 256 fp32 O accumulator alone takes 128
// registers a thread, so the Q fragments (64 more) do not stay in registers beside it.
// There Q keeps its own region of shared memory and each 16-wide slice of it is
// re-read by ldmatrix once a tile (Shape::Q_SMEM); one tile shape, 64 rows by 64 keys,
// puts the block at 165 KB of shared memory (dynamic, above 48 KB), one block an SM.
//
// mma.sync rather than wgmma: at these sizes (a few GFLOP over a few hundred tiles,
// about two waves on 132 SMs) occupancy and the softmax's latency decide, not the peak
// tensor-core rate. wgmma with TMA and warp specialisation is the next step.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace xot_mma {

constexpr float LOG2E = 1.4426950408889634f;

// Tile geometry: ROWS query rows (ROWS / 16 warps), KT keys a tile, head width D.
// Above D = 128 the Q rows stay in shared memory (a region after the two stages) and
// their fragments are re-read each tile; up to 128 they are staged in the second stage
// and kept in registers.
template <int D, int KT, int ROWS>
struct Shape {
  static_assert(D % 16 == 0 && KT % 16 == 0 && ROWS % 16 == 0, "mma tiles are 16 wide");
  static constexpr bool Q_SMEM = D > 128;
  static_assert(Q_SMEM || ROWS <= 2 * KT, "the Q tile is staged in the second K/V stage");
  static constexpr int WARPS = ROWS / 16;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int DS = D + 8;        // shared-memory row stride (bf16)
  static constexpr int STAGE = 2 * KT * DS;  // one stage: K tile, then V tile
  static constexpr int QS = Q_SMEM ? ROWS * DS : 0;  // the Q region (bf16), if any
  static constexpr size_t SMEM = (2 * (size_t)STAGE + QS) * sizeof(__nv_bfloat16);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, around L1; zeros when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c (16x8 fp32) += a (16x16 bf16, row) . b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 in one register, lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float exp2_fast(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The query rows one block holds: rows [row0, row0 + ROWS) of the flattened index
// t * groups + g of batch row b and kv head kvh, over q/o [B, T, Hq, D] (Hq = Hkv *
// groups); query t sits at absolute position start + t. lse, when not null, receives each
// row's log-sum-exp [B, T, Hq] (fp32, base 2: see attend's epilogue); K1's training
// instantiation passes it, and every serving kernel leaves it null, a constant there, so
// that its code is that of a tile core without the output.
struct RowTile {
  const __nv_bfloat16* q;
  __nv_bfloat16* o;
  int T, Hq, groups, kvh, b, row0, start;
  float* lse = nullptr;
};

// Offset of a row's head vector in q/o, in units of D (and the row's index in lse).
__device__ __forceinline__ size_t row_vector(const RowTile& rt, int row) {
  return ((size_t)rt.b * rt.T + row / rt.groups) * rt.Hq + (size_t)rt.kvh * rt.groups +
         row % rt.groups;
}

// Stage one K/V tile: rows j in [0, KT) hold positions k0 + j, read at element offset
// off(j) from kb/vb; positions outside [lo, hi) are zeros (their scores are masked, and a
// zero V row keeps P.V finite). Each thread keeps one 16-byte column, so off(j) is
// evaluated once per row it copies, and only for rows it reads.
template <int D, int KT, int THREADS, class Off>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                           const __nv_bfloat16* kb, const __nv_bfloat16* vb,
                                           int k0, int lo, int hi, const Off& off) {
  constexpr int CH = D / 8;
  constexpr int DS = D + 8;
  static_assert(THREADS % CH == 0, "a thread keeps one column of the tile");
  const int c = threadIdx.x % CH;
  for (int j = threadIdx.x / CH; j < KT; j += THREADS / CH) {
    const bool ok = k0 + j >= lo && k0 + j < hi;
    const size_t o = ok ? off(j) : 0;
    cp_async16(ks + j * DS + 8 * c, kb + o + 8 * c, ok);
    cp_async16(vs + j * DS + 8 * c, vb + o + 8 * c, ok);
  }
}

// Byte i of a word of int8 codes biased by 128 (word ^ 0x80808080) as an exact float:
// the byte lands in the significand of 2^23, whose bias (2^23 + 128) is then taken off,
// an integer op and an add where a conversion instruction would take the slower pipe.
__device__ __forceinline__ float biased_code(uint32_t biased, int i) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 + i)) - 8388736.f;
}

// Two int8 codes (bytes i and i + 1 of a word) times their scale, each rounded once to
// bf16, as one bf16 pair.
__device__ __forceinline__ uint32_t dequant2(uint32_t biased, int i, float sc) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(biased_code(biased, i) * sc,
                                                 biased_code(biased, i + 1) * sc);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Eight int8 codes dequantized: one 16-byte chunk of a bf16 tile row.
__device__ __forceinline__ uint4 dequant8(uint2 w, float sc) {
  const uint32_t x = w.x ^ 0x80808080u, y = w.y ^ 0x80808080u;
  return make_uint4(dequant2(x, 0, sc), dequant2(x, 2, sc), dequant2(y, 0, sc),
                    dequant2(y, 2, sc));
}

// stage_tile over an int8 cache, in two steps so that the loads of the next tile can be
// in flight while the current one is computed: fetch() loads each of the thread's rows'
// 8 codes (row j's D codes at byte offset off(j) from kb/vb) and the row's bf16 scale
// (at ksc/vsc[off(j) / D]: one scale per (position, head), laid out as the codes' rows)
// into registers; land() stores code x scale, rounded once to bf16, where stage_tile's
// cp.async would put the bf16 value. The tile is the same, so the consumer runs the bf16
// kernel's instructions on the dequantized values (an 8-bit code times a bf16
// significand is exact in fp32, so this equals a bf16 multiply bit for bit). Rows
// outside [lo, hi) are zeros.
template <int D, int KT, int THREADS>
struct Kv8Tile {
  static constexpr int CH = D / 8;
  static constexpr int STEP = THREADS / CH;           // rows a pass of the block
  static constexpr int PER = (KT + STEP - 1) / STEP;  // rows a thread
  static_assert(THREADS % CH == 0, "a thread keeps one column of the tile");
  uint2 kw[PER], vw[PER];
  float kscl[PER], vscl[PER];

  template <class Off>
  __device__ __forceinline__ void fetch(const int8_t* __restrict__ kb,
                                        const int8_t* __restrict__ vb,
                                        const __nv_bfloat16* __restrict__ ksc,
                                        const __nv_bfloat16* __restrict__ vsc, int k0, int lo,
                                        int hi, const Off& off) {
    const int c = threadIdx.x % CH;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int j = threadIdx.x / CH + i * STEP;
      kw[i] = vw[i] = make_uint2(0u, 0u);
      kscl[i] = vscl[i] = 0.f;
      if (j < KT && k0 + j >= lo && k0 + j < hi) {
        const size_t o = off(j);
        kw[i] = *reinterpret_cast<const uint2*>(kb + o + 8 * c);
        vw[i] = *reinterpret_cast<const uint2*>(vb + o + 8 * c);
        kscl[i] = __bfloat162float(ksc[o / D]);
        vscl[i] = __bfloat162float(vsc[o / D]);
      }
    }
  }

  __device__ __forceinline__ void land(__nv_bfloat16* ks, __nv_bfloat16* vs) const {
    constexpr int DS = D + 8;
    const int c = threadIdx.x % CH;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int j = threadIdx.x / CH + i * STEP;
      if (j < KT) {
        *reinterpret_cast<uint4*>(ks + j * DS + 8 * c) = dequant8(kw[i], kscl[i]);
        *reinterpret_cast<uint4*>(vs + j * DS + 8 * c) = dequant8(vw[i], vscl[i]);
      }
    }
  }
};

// Whether an int8 tile of head width D is dequantized straight into shared memory
// (stage_tile_kv8) instead of being fetched into registers a tile ahead (Kv8Tile): at
// D = 256 a thread's share of a 64-key tile is 16 rows (64 threads: 32) of 8 codes of K
// and of V plus their scales, 96 registers or more held across the compute of the tile
// before, beside a 128-register O accumulator.
template <int D>
__device__ __host__ constexpr bool kv8_direct() {
  return D > 128;
}

// stage_tile over an int8 cache, in one step: each row's 8 codes and its scale are read
// and stored as code x scale (rounded once to bf16) at once, as Kv8Tile's land() stores
// them, so the tile is the same; the loads are not overlapped with the tile before.
template <int D, int KT, int THREADS, class Off>
__device__ __forceinline__ void stage_tile_kv8(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                               const int8_t* __restrict__ kb,
                                               const int8_t* __restrict__ vb,
                                               const __nv_bfloat16* __restrict__ ksc,
                                               const __nv_bfloat16* __restrict__ vsc, int k0,
                                               int lo, int hi, const Off& off) {
  constexpr int CH = D / 8;
  constexpr int DS = D + 8;
  static_assert(THREADS % CH == 0, "a thread keeps one column of the tile");
  const int c = threadIdx.x % CH;
  for (int j = threadIdx.x / CH; j < KT; j += THREADS / CH) {
    uint2 kw = make_uint2(0u, 0u), vw = make_uint2(0u, 0u);
    float kscl = 0.f, vscl = 0.f;
    if (k0 + j >= lo && k0 + j < hi) {
      const size_t o = off(j);
      kw = *reinterpret_cast<const uint2*>(kb + o + 8 * c);
      vw = *reinterpret_cast<const uint2*>(vb + o + 8 * c);
      kscl = __bfloat162float(ksc[o / D]);
      vscl = __bfloat162float(vsc[o / D]);
    }
    *reinterpret_cast<uint4*>(ks + j * DS + 8 * c) = dequant8(kw, kscl);
    *reinterpret_cast<uint4*>(vs + j * DS + 8 * c) = dequant8(vw, vscl);
  }
}

// The second step of a loader whose first (load) lands the tile itself (cp.async).
struct NoLand {
  __device__ __forceinline__ void operator()(__nv_bfloat16*, __nv_bfloat16*) const {}
};

// Attend the block's rows over keys [window low of its first row, its last row's
// position], capped at kv_cap. load(ks, vs, k0, hi) stages the tile of positions
// [k0, k0 + KT) into one stage (cp.async) with positions >= hi zeroed, or fetches it
// into registers for land(ks, vs) to store once the tile before it is computed.
template <int D, int KT, int ROWS, class Load, class Land = NoLand>
__device__ __forceinline__ void attend(const RowTile& rt, unsigned char* smem, int kv_cap,
                                       int window, float scale, float softcap,
                                       const Load& load, const Land& land = Land()) {
  using S = Shape<D, KT, ROWS>;
  constexpr int DS = S::DS;
  constexpr int CH = D / 8;
  constexpr int NK = KT / 8;   // S n-tiles a tile
  constexpr int ND = D / 8;    // O n-tiles
  __nv_bfloat16* stage0 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* stage1 = stage0 + S::STAGE;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n_rows = rt.T * rt.groups;
  const int r_last = min(rt.row0 + ROWS, n_rows) - 1;
  const int p_first = rt.start + rt.row0 / rt.groups;
  const int p_last = rt.start + r_last / rt.groups;
  const int hi = min(p_last + 1, kv_cap);
  int lo = window > 0 ? max(0, p_first - window + 1) : 0;
  lo -= lo % KT;

  // Q rows into the second stage (free until the first prefetch) or, above D = 128,
  // into their own region; tile `lo` into the first stage.
  __nv_bfloat16* qsm = S::Q_SMEM ? stage1 + S::STAGE : stage1;
  for (int i = tid; i < ROWS * CH; i += S::THREADS) {
    const int r = i / CH;
    const int c = i % CH;
    const int row = rt.row0 + r;
    const bool ok = row < n_rows;
    const __nv_bfloat16* src = ok ? rt.q + row_vector(rt, row) * D + 8 * c : rt.q;
    cp_async16(qsm + r * DS + 8 * c, src, ok);
  }
  cp_async_commit();
  if (lo < hi) {
    load(stage0, stage0 + KT * DS, lo, hi);
    land(stage0, stage0 + KT * DS);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // The warp's rows, and the two rows this lane holds (quad row g and g + 8).
  const int wr0 = rt.row0 + 16 * warp;
  const bool active = wr0 <= r_last;
  const int wp_min = rt.start + wr0 / rt.groups;
  const int wp_max = rt.start + min(wr0 + 15, r_last) / rt.groups;
  const int g = lane >> 2;
  const int c2 = 2 * (lane & 3);
  const int ra = wr0 + g;
  const int rb = ra + 8;
  const int pa = ra <= r_last ? rt.start + ra / rt.groups : -1;  // -1: no key is visible
  const int pb = rb <= r_last ? rt.start + rb / rt.groups : -1;

  // The lane's slice of Q row (16 warp + lane % 16), columns 16 kk + 8 (lane / 16).
  const __nv_bfloat16* qrow = qsm + (16 * warp + (lane & 15)) * DS + (lane >> 4) * 8;
  uint32_t qa[S::Q_SMEM ? 1 : D / 16][4];
  if (!S::Q_SMEM && active) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qa[kk], qrow + 16 * kk);
  }
  __syncthreads();  // Q is in registers: the second stage may take tile lo + KT

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;
  // Scores go to base-2 units: x * scale * log2(e), or tanh(x * scale / cap) * cap * log2(e).
  const float pre = softcap > 0.f ? scale / softcap : scale * LOG2E;
  const float post = softcap * LOG2E;

  int it = 0;
  for (int k0 = lo; k0 < hi; k0 += KT, ++it) {
    __nv_bfloat16* cur = (it & 1) ? stage1 : stage0;
    if (k0 + KT < hi) {
      __nv_bfloat16* nxt = (it & 1) ? stage0 : stage1;
      load(nxt, nxt + KT * DS, k0 + KT, hi);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile k0 has landed for every thread

    const bool visible = active && k0 <= wp_max && !(window > 0 && k0 + KT - 1 <= wp_min - window);
    if (visible) {
      const __nv_bfloat16* ks = cur;
      const __nv_bfloat16* vs = cur + KT * DS;
      // 16-key slices that hold a key at or below the warp's last diagonal.
      const int n16 = min(KT / 16, (wp_max - k0) / 16 + 1);

      float s[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qk[4];
        if constexpr (S::Q_SMEM) {
          ldmatrix_x4(qk, qrow + 16 * kk);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) qk[e] = qa[kk][e];
        }
#pragma unroll
        for (int jn = 0; jn < KT / 16; ++jn) {
          if (jn < n16) {
            uint32_t kb[4];
            ldmatrix_x4(kb, ks + (16 * jn + (lane & 7) + ((lane >> 4) << 3)) * DS + 16 * kk +
                                ((lane >> 3) & 1) * 8);
            mma_bf16(s[2 * jn], qk, kb[0], kb[1]);
            mma_bf16(s[2 * jn + 1], qk, kb[2], kb[3]);
          }
        }
      }

      // Scale, softcap and mask (only where a diagonal or a window edge crosses the
      // warp's rows; slices past n16 lie above every diagonal and are masked here).
      const bool mask = k0 + KT - 1 > wp_min || (window > 0 && k0 <= wp_max - window);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * pre;
          if (softcap > 0.f) x = tanhf(x) * post;
          if (mask) {
            const int key = k0 + 8 * j + c2 + (e & 1);
            const int p = e < 2 ? pa : pb;
            if (key > p || (window > 0 && key <= p - window)) x = -INFINITY;
          }
          s[j][e] = x;
        }
      }

      // Online softmax: rows a (fragment elements 0, 1) and b (2, 3).
      float xa = -INFINITY, xb = -INFINITY;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        xa = fmaxf(xa, fmaxf(s[j][0], s[j][1]));
        xb = fmaxf(xb, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, off));
        xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, off));
      }
      const float na = fmaxf(ma, xa);
      const float nb = fmaxf(mb, xb);
      // A row with no visible key so far keeps m = -inf: subtract 0 instead, so that
      // every p and alpha is 0, never NaN.
      const float ba = na == -INFINITY ? 0.f : na;
      const float bb = nb == -INFINITY ? 0.f : nb;
      const float alpha_a = exp2_fast(ma - ba);
      const float alpha_b = exp2_fast(mb - bb);
      ma = na;
      mb = nb;
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        s[j][0] = exp2_fast(s[j][0] - ba);
        s[j][1] = exp2_fast(s[j][1] - ba);
        s[j][2] = exp2_fast(s[j][2] - bb);
        s[j][3] = exp2_fast(s[j][3] - bb);
        sa += s[j][0] + s[j][1];
        sb += s[j][2] + s[j][3];
      }
      la = la * alpha_a + sa;
      lb = lb * alpha_b + sb;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= alpha_a;
        acc[n][1] *= alpha_a;
        acc[n][2] *= alpha_b;
        acc[n][3] *= alpha_b;
      }

      // O += P.V with P in bf16: S n-tiles 2i and 2i + 1 are the A fragment of keys
      // [16i, 16i + 16).
#pragma unroll
      for (int i = 0; i < KT / 16; ++i) {
        if (i < n16) {
          const uint32_t pa4[4] = {pack_bf16(s[2 * i][0], s[2 * i][1]),
                                   pack_bf16(s[2 * i][2], s[2 * i][3]),
                                   pack_bf16(s[2 * i + 1][0], s[2 * i + 1][1]),
                                   pack_bf16(s[2 * i + 1][2], s[2 * i + 1][3])};
#pragma unroll
          for (int dn = 0; dn < D / 16; ++dn) {
            uint32_t vb[4];
            ldmatrix_x4_trans(vb, vs + (16 * i + (lane & 7) + ((lane >> 3) & 1) * 8) * DS +
                                      16 * dn + (lane >> 4) * 8);
            mma_bf16(acc[2 * dn], pa4, vb[0], vb[1]);
            mma_bf16(acc[2 * dn + 1], pa4, vb[2], vb[3]);
          }
        }
      }
    }
    // A fetched tile lands in the stage the previous iteration consumed.
    if (k0 + KT < hi) land((it & 1) ? stage0 : stage1, ((it & 1) ? stage0 : stage1) + KT * DS);
    __syncthreads();  // this stage is consumed: the next prefetch may overwrite it
  }

  // Epilogue: the row sums over the quad, the l == 0 -> 1 guard, one bf16 rounding.
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    la += __shfl_xor_sync(0xffffffffu, la, off);
    lb += __shfl_xor_sync(0xffffffffu, lb, off);
  }
  // The log-sum-exp in the loop's base-2 units: lse = m + log2(l) over the scaled (and
  // soft-capped) scores times log2(e), so that a gradient kernel rebuilds each P as
  // exp2(score * log2(e) - lse). A row with no visible key gets +inf: every P it
  // rebuilds is then exactly 0.
  if (rt.lse != nullptr && active && (lane & 3) == 0) {
    if (ra <= r_last) rt.lse[row_vector(rt, ra)] = la > 0.f ? ma + log2f(la) : INFINITY;
    if (rb <= r_last) rt.lse[row_vector(rt, rb)] = lb > 0.f ? mb + log2f(lb) : INFINITY;
  }
  const float ia = 1.f / (la == 0.f ? 1.f : la);
  const float ib = 1.f / (lb == 0.f ? 1.f : lb);
  if (active && ra <= r_last) {
    uint32_t* oa = reinterpret_cast<uint32_t*>(rt.o + row_vector(rt, ra) * D + c2);
#pragma unroll
    for (int n = 0; n < ND; ++n) oa[4 * n] = pack_bf16(acc[n][0] * ia, acc[n][1] * ia);
  }
  if (active && rb <= r_last) {
    uint32_t* ob = reinterpret_cast<uint32_t*>(rt.o + row_vector(rt, rb) * D + c2);
#pragma unroll
    for (int n = 0; n < ND; ++n) ob[4 * n] = pack_bf16(acc[n][2] * ib, acc[n][3] * ib);
  }
}

}  // namespace xot_mma
