// The split-K decode core shared by K2/K2q at T == 1 (flash_decode.cu::
// flash_cached_split_kernel) and K3/K3q (paged_attention.cu::paged_decode_split_kernel),
// for Hopper (sm_90a).
//
// Both replace Pallas kernels that attend one query per (batch row, q head) over the
// row's cache (xotorch_tpu/ops/flash_decode.py::_cached_kernel at T == 1,
// xotorch_tpu/ops/paged_attention.py::_paged_kernel). A decode step must stream the
// visible cache once, 2 * Lvis * Hkv * D * 2 bytes per (batch row, layer) in bf16, for
// about 4 * Hq * Lvis * D operations: it is bound by bytes. The TPU grid walks a row's
// kv blocks in order on one core; on Hopper one row's cache has to spread over many SMs
// to stream at the card's rate. So this is split-K flash-decoding:
//
// - A row's key positions [0, S) are cut into `splits` ranges of `kps` keys (whole
//   64-key tiles), fixed by the static shapes and the SM count (ops/flash_decode.py::
//   split_plan), so the host never reads a position or a length. Block (split, kv head
//   [x row block], batch row) attends the visible keys of its range, [max(lo, s0),
//   min(p + 1, s1)) for the query at position p with the window's lower bound lo. A
//   range that holds none writes the neutral state (m = -inf, l = 0) and exits before
//   it reads the cache.
// - Inside a block, K/V tiles of 64 keys are staged in shared memory by the caller's
//   loader (cp.async, double-buffered; int8 codes x scale fetched into registers while
//   the tile before is computed), rows padded to D + 8 bf16, so a lane's 16-byte reads
//   of its own key row are free of bank conflicts. Warp w takes keys [32 w, 32 w + 32)
//   of each tile: lane j scores key j against the block's q rows (1, 2, 4 or 8 q heads
//   of one kv head, a compile-time count, fp32 in shared memory, read by broadcast);
//   the chunk's max and sum are warp reductions; for P.V each lane owns pairs of output
//   dimensions and reads V rows from the tile. Every warp keeps an online-softmax state
//   per row in registers; the block merges its warps' states in shared memory and
//   writes one fp32 partial (m, l, acc[D]) per (row, split).
// - More q heads than 8 a kv head (K3's groups of 12, 16, ... up to 32 a block): the
//   block holds `nb` row blocks of 8 rows, two warps each (64 nb threads). The first
//   two warps stage each tile once and every warp pair scores it against its own row
//   block, so a tile is read from memory once for all of them, not once a row block.
// - merge_splits_kernel, launched next on the same stream, combines a row's partials
//   (one warp a row): M = max m, L = sum l e^(m - M), O = sum acc e^(m - M), out = O / L
//   with JAX's l == 0 -> 1 guard, rounded once to bf16.
#pragma once

#include "attention_mma.cuh"

namespace xot_split {

using bf16 = __nv_bfloat16;

constexpr int KT = 64;             // keys a staged tile; a split is whole tiles
constexpr int WARPS = KT / 32;     // warp w scores keys [32 w, 32 w + 32) of a tile
constexpr int THREADS = WARPS * 32;
constexpr int RB = 8;              // q rows (q heads of one kv head) a row block
constexpr int MAX_NB = 4;          // row blocks one block holds (two warps each)
constexpr unsigned FULL = 0xffffffffu;

template <int D>
struct Smem {
  static constexpr int DS = D + 8;           // bf16 row stride of a tile
  static constexpr int STAGE = 2 * KT * DS;  // K tile, then V tile
  // Two stages, then the q rows of nb row blocks in fp32. The warps' merge reuses the
  // first stage.
  static constexpr size_t bytes(int nb) {
    return 2 * (size_t)STAGE * sizeof(bf16) + (size_t)nb * RB * D * sizeof(float);
  }
  static constexpr size_t BYTES = bytes(1);
  static_assert((size_t)WARPS * MAX_NB * RB * (D + 2) * sizeof(float) <= STAGE * sizeof(bf16),
                "the warps' states fit one stage");
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// Attend q rows [0, rows) (rows <= nb * R, R <= RB, row r's bf16 vector at q + r * D)
// of the query at position p over the visible keys [max(lo, s0), min(p + 1, s1)) of one
// split, s0 a multiple of KT. The block holds nb row blocks of R rows (nb * THREADS
// threads; nb > 1 only at R = RB): warps 2 b and 2 b + 1 compute rows [b R, b R + R)
// (the q rows past `rows` read as zeros), so no row loop holds a branch and the rows'
// shuffles overlap; it writes rows [0, rows). Row r's partial goes to
// part_acc[(idx0 + r * stride) * D + d] and part_ml[(idx0 + r * stride) * 2 + {0: m,
// 1: l}]. load(ks, vs, k0, a, e), called by the first THREADS threads, stages the tile
// of positions [k0, k0 + KT) into one stage (ks, then vs), every position outside
// [a, e) zeroed, by cp.async (it commits nothing itself), or fetches it into registers
// for land(ks, vs) to store once the tile before it is computed.
template <int D, int R, class Load, class Land>
__device__ __forceinline__ void attend_split(const bf16* __restrict__ q, int rows, int p,
                                             int lo, int s0, int s1, float scale,
                                             float softcap, float* __restrict__ part_acc,
                                             float* __restrict__ part_ml, size_t idx0,
                                             int stride, unsigned char* smem,
                                             const Load& load, const Land& land,
                                             int nb = 1) {
  static_assert(R >= 1 && R <= RB, "rows a row block");
  using SM = Smem<D>;
  constexpr int DS = SM::DS;
  constexpr int NP = (D / 2 + 31) / 32;  // dimension pairs a lane owns in P.V
  const int tid = threadIdx.x;
  const int nthreads = nb * THREADS;
  const int warp = tid / 32;
  const int kw = warp % WARPS;  // the warp's keys of each tile: [32 kw, 32 kw + 32)
  const int gb = warp / WARPS;  // the warp's row block: rows [gb R, gb R + R)
  const int lane = tid % 32;
  const bool loader = tid < THREADS;
  const int a = max(lo, s0);
  const int e = min(p + 1, s1);
  if (a >= e) {  // no visible key in this split (uniform across the block)
    for (int r = tid; r < rows; r += nthreads) {
      part_ml[(idx0 + (size_t)r * stride) * 2] = -INFINITY;
      part_ml[(idx0 + (size_t)r * stride) * 2 + 1] = 0.f;
    }
    return;
  }
  bf16* stage0 = reinterpret_cast<bf16*>(smem);
  bf16* stage1 = stage0 + SM::STAGE;
  float* qs = reinterpret_cast<float*>(stage1 + SM::STAGE);  // [nb R][D]
  const float* qw = qs + gb * R * D;                          // the warp's row block

  int k0 = a - (a - s0) % KT;  // the tile that holds a
  if (loader) {
    load(stage0, stage0 + KT * DS, k0, a, e);
    land(stage0, stage0 + KT * DS);
  }
  xot_mma::cp_async_commit();
  // q rows to fp32, 8 values a 16-byte load; a fixed trip count keeps the loads together
  // (nb row blocks take nb times the threads: the same count).
#pragma unroll
  for (int i0 = 0; i0 < R * D / 8; i0 += THREADS) {
    const int i = i0 * nb + tid;
    if (i < nb * R * D / 8) {
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (i < rows * D / 8) raw = *reinterpret_cast<const uint4*>(q + 8 * i);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float4* dst = reinterpret_cast<float4*>(qs + 8 * i);
      const float2 f0 = __bfloat1622float2(h2[0]), f1 = __bfloat1622float2(h2[1]);
      const float2 f2 = __bfloat1622float2(h2[2]), f3 = __bfloat1622float2(h2[3]);
      dst[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
      dst[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
    }
  }

  float m[R], l[R], acc[R][2 * NP];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 2 * NP; ++i) acc[r][i] = 0.f;
  }

  for (int it = 0; k0 < e; k0 += KT, ++it) {
    const bf16* cur = (it & 1) ? stage1 : stage0;
    if (k0 + KT < e) {
      bf16* nxt = (it & 1) ? stage0 : stage1;
      if (loader) load(nxt, nxt + KT * DS, k0 + KT, a, e);
      xot_mma::cp_async_commit();
      xot_mma::cp_async_wait<1>();
    } else {
      xot_mma::cp_async_wait<0>();
    }
    __syncthreads();  // tile k0 (and, the first time, q) is in shared memory

    const int c0 = k0 + 32 * kw;  // this warp's chunk
    if (c0 < e && c0 + 32 > a) {    // it holds a visible key, so every max below is finite
      const int kp = c0 + lane;
      const bool vis = kp >= a && kp < e;
      const bf16* krow = cur + (32 * kw + lane) * DS;
      float s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = 0.f;
#pragma unroll
      for (int w = 0; w < D / 8; ++w) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + 8 * w);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        float kf[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(h2[i]);
          kf[2 * i] = f.x;
          kf[2 * i + 1] = f.y;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 qa = *reinterpret_cast<const float4*>(qw + r * D + 8 * w);
          const float4 qb = *reinterpret_cast<const float4*>(qw + r * D + 8 * w + 4);
          float x = s[r];
          x = fmaf(qa.x, kf[0], x);
          x = fmaf(qa.y, kf[1], x);
          x = fmaf(qa.z, kf[2], x);
          x = fmaf(qa.w, kf[3], x);
          x = fmaf(qb.x, kf[4], x);
          x = fmaf(qb.y, kf[5], x);
          x = fmaf(qb.z, kf[6], x);
          s[r] = fmaf(qb.w, kf[7], x);
        }
      }
      float pr[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float x = s[r] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[r] = vis ? x : -INFINITY;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float m_new = fmaxf(m[r], warp_max(s[r]));
        const float alpha = __expf(m[r] - m_new);
        pr[r] = __expf(s[r] - m_new);
        l[r] = l[r] * alpha + warp_sum(pr[r]);
#pragma unroll
        for (int i = 0; i < 2 * NP; ++i) acc[r][i] *= alpha;
        m[r] = m_new;
      }
      const bf16* vt = cur + KT * DS + 32 * kw * DS;
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        float2 vf[NP];
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const int dp = lane + 32 * i;
          vf[i] = dp < D / 2
                      ? __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(vt + j * DS)[dp])
                      : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float pj = __shfl_sync(FULL, pr[r], j);
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            acc[r][2 * i] = fmaf(pj, vf[i].x, acc[r][2 * i]);
            acc[r][2 * i + 1] = fmaf(pj, vf[i].y, acc[r][2 * i + 1]);
          }
        }
      }
    }
    // A fetched tile lands in the stage the previous iteration consumed.
    if (loader && k0 + KT < e) {
      land((it & 1) ? stage0 : stage1, ((it & 1) ? stage0 : stage1) + KT * DS);
    }
    __syncthreads();  // this stage is consumed: the next prefetch may overwrite it
  }

  // Merge the warps' states in the first stage. A warp that took no chunk holds
  // m = -inf and weighs nothing; at least one warp of each row block holds the split's
  // first visible key. Row r of the block's nb R rows is (row block r / R, row r % R).
  const int RT = nb * R;
  float* wml = reinterpret_cast<float*>(stage0);  // [WARPS][nb R][2]
  float* wacc = wml + 2 * WARPS * RT;             // [WARPS][nb R][D]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = gb * R + r;
    if (lane == 0) {
      wml[(kw * RT + row) * 2] = m[r];
      wml[(kw * RT + row) * 2 + 1] = l[r];
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int dp = lane + 32 * i;
      if (dp < D / 2) {
        reinterpret_cast<float2*>(wacc + (size_t)(kw * RT + row) * D)[dp] =
            make_float2(acc[r][2 * i], acc[r][2 * i + 1]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += nthreads) {
    const int r = i / D;
    const int d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, wml[(w * RT + r) * 2]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float mw = wml[(w * RT + r) * 2];
      if (mw == -INFINITY) continue;
      const float wt = __expf(mw - M);
      L += wml[(w * RT + r) * 2 + 1] * wt;
      O += wacc[(size_t)(w * RT + r) * D + d] * wt;
    }
    const size_t idx = idx0 + (size_t)r * stride;
    part_acc[idx * D + d] = O;
    if (d == 0) {
      part_ml[idx * 2] = M;
      part_ml[idx * 2 + 1] = L;
    }
  }
}

// The rows one split block's row blocks hold for `groups` q heads per kv head: the power
// of two at or above min(groups, RB), so a row block pads at most to the next power of
// two.
__host__ __forceinline__ int rows_per_block(int groups) {
  return groups <= 1 ? 1 : groups <= 2 ? 2 : groups <= 4 ? 4 : RB;
}

// The row blocks of RB rows one block holds for `groups` q heads per kv head (1 up to RB
// groups), at most MAX_NB: above MAX_NB * RB groups a kv head's rows take several
// blocks, each reading the tiles once.
__host__ __forceinline__ int row_blocks(int groups) {
  return groups <= RB ? 1 : min(MAX_NB, (groups + RB - 1) / RB);
}

// Row bh in [0, rows_total) (b * Hq + h) of the output o [B, 1, Hq, D]: its `splits`
// partials at part_acc[(bh * splits + s) * D + d] and part_ml[(bh * splits + s) * 2],
// merged by one warp: lane s reads split s's (m, l), so the max M over the splits takes
// one load a lane; then lane d sums acc[s][d] e^(m_s - M) over the splits, loading only
// those that hold a key (an empty split, m = -inf, weighs nothing and its acc was never
// written), 8 at a time.
template <int D>
__global__ void __launch_bounds__(128) merge_splits_kernel(const float* __restrict__ part_acc,
                                                           const float* __restrict__ part_ml,
                                                           bf16* __restrict__ o, int rows_total,
                                                           int splits) {
  constexpr int NDL = (D + 31) / 32;  // output dimensions a lane owns: lane + 32 i
  const int bh = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (bh >= rows_total) return;  // uniform across the warp
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + (size_t)bh * splits;
  const float* acc = part_acc + (size_t)bh * splits * D;
  float M = -INFINITY;
  for (int s = lane; s < splits; s += 32) M = fmaxf(M, ml[s].x);
  M = warp_max(M);
  float L = 0.f, O[NDL];
#pragma unroll
  for (int i = 0; i < NDL; ++i) O[i] = 0.f;
  for (int c = 0; c < splits; c += 32) {
    float w = 0.f;  // split c + lane's weight
    if (c + lane < splits) {
      const float2 x = ml[c + lane];
      if (x.x != -INFINITY) {
        w = __expf(x.x - M);
        L += x.y * w;
      }
    }
    const int n = min(32, splits - c);
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float wj = __shfl_sync(FULL, w, j);
      if (wj != 0.f) {  // uniform across the warp
#pragma unroll
        for (int i = 0; i < NDL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) O[i] = fmaf(acc[(size_t)(c + j) * D + d], wj, O[i]);
        }
      }
    }
  }
  L = warp_sum(L);
  const float inv = 1.f / (L == 0.f ? 1.f : L);
#pragma unroll
  for (int i = 0; i < NDL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) o[(size_t)bh * D + d] = __float2bfloat16_rn(O[i] * inv);
  }
}

// The partials of rows_total = B * Hq rows over `splits` splits lie in one buffer of
// rows_total * splits * (D + 2) floats that the caller allocates: acc first, then (m, l).
__host__ __device__ __forceinline__ float* part_ml_of(float* part, int rows_total, int splits,
                                                     int D) {
  return part + (size_t)rows_total * splits * D;
}

// Launch the merge of those partials into o [rows_total, D] (bf16) on `stream`: a warp a
// row, four rows a block.
template <int D>
int merge_splits(float* part, void* o, int rows_total, int splits, cudaStream_t stream) {
  merge_splits_kernel<D><<<(rows_total + 3) / 4, 128, 0, stream>>>(
      part, part_ml_of(part, rows_total, splits, D), static_cast<bf16*>(o), rows_total, splits);
  return (int)cudaGetLastError();
}

// Raise a kernel's dynamic shared memory limit once per process (0 when it needs none).
template <class Kernel>
int smem_limit(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace xot_split
