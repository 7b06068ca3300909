// K3 and K4: grouped-query attention over the shared paged KV arena, for Hopper
// (sm_90a).
//
// The arena holds every resident request's cache as fixed-size pages, one layer at a
// time: k/v [P, PAGE, Hkv, D] bf16, read IN PLACE (a head's rows are Hkv * D apart; no
// per-call transpose of the layer arena). Row b of a batch reaches logical page j of
// its context through table[b, j], a physical page id; page 0 is the pool's scratch
// page, the padding of every table row.
//
// K3 (paged_decode_kernel) replaces xotorch_tpu/ops/paged_attention.py::_paged_kernel:
// one decode query per row (T == 1) attends positions [0, lengths[b]) of its own
// pages, or only the last `window` of them.
// K4 (paged_prefill_kernel) replaces ::_paged_ragged_kernel: a segment of T queries
// per row, query t at absolute position q_start[b] + t with q_start = kv_valid[b] - T,
// attends the occupied positions at or before its own (and above its own position
// minus the window). It serves every prefill segment of a paged request, the first
// one at position 0 included.
//
// What bounds them: decode must stream each row's visible pages once, 2 * Lvis * Hkv *
// D * 2 bytes per (row, layer), for about 4 * Hq * Lvis * D FLOPs: bytes. A prefill
// segment of hundreds of queries over the same pages does ~T times the FLOPs on the
// same bytes: operations.
//
// Design. Blocks load their own page ids from the table (there is no scalar prefetch)
// and loop over keys from the window's first position to the last visible one, so no
// byte of a page past a row's occupied prefix, or below its window, is read: the
// property the Pallas kernels get by clamping the logical page index
// (_logical_page_index) so that repeated block indices elide the DMA.
//
// - K3: one block per (kv head, row) holds that head's `groups` query heads. Its
//   eight warps split the row's keys in 32-key chunks (chunk c goes to warp c % 8),
//   so a short context still keeps every warp of the block busy: lane j resolves key
//   j's page and reads its K row straight from device memory (16-byte loads) and
//   scores it against every query head (q staged once in shared memory as fp32); the
//   chunk's max and sum are warp reductions; for P.V each lane owns D/32 output
//   dimensions and reads V rows coalesced. Each warp keeps its own online-softmax
//   state in registers; the block merges the eight states in shared memory at the
//   end.
// - K4: the tensor-core tile core of attention_mma.cuh (mma.sync, bf16 operands, fp32
//   accumulation, the Pallas kernel's two dots on the matrix unit) behind a paged
//   loader. One block per (row tile, kv head, batch row): 64 query rows, packed as
//   positions x groups (the JAX kernel's groups x T rows of one kv head), in 4 warps
//   of 16 rows, so one K/V tile serves every query head of its kv head (128-row
//   blocks of 8 warps ran slower on an H100 in every case measured: half the blocks,
//   one a SM).
//   Tiles of 64 keys are aligned to 64 positions: at page 128 a tile lies inside one
//   page, whose id is read once per tile and whose rows are Hkv * D apart; at page 16
//   one id serves 16 rows. bf16 tiles travel by cp.async, double-buffered; the kv loop
//   stops at the block's last row and starts at its first row's window.
//
// K3q and K4q (KV8 = true) replace the same Pallas kernels with quant=True: the arena is
// int8 with one bf16 scale per (position, head) in scale pages [P, PAGE, Hkv], indexed by
// the same page id and slot as the payload (offset / D). K3q's lane reads its key's D
// codes with 16-byte loads and its scale; the V loop reads one code per lane and the
// key's scale. K4q's tiles go through registers: 8 codes and the row's scale in, code x
// scale out into the very shared-memory layout K4's cp.async fills, so the tile core
// then runs K4's instructions.
// Every dequantized value is code x scale rounded once to bf16, which equals JAX's bf16
// multiply bit for bit (an 8-bit code times a bf16 significand is exact in fp32); the
// rest is K3's and K4's arithmetic. The arena streams half the bytes.
//
// Known limits: K3 at B=1 runs Hkv blocks (8 for Llama-3.2-1B) on 132 SMs, and scores on
// CUDA cores (split-K flash-decoding is later work); K4q's tile loads are not overlapped
// with the tile before them, as K4's cp.async copies are.
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace {

constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_GROUPS = 8;              // K3, K4: q heads per kv head
constexpr int KT4 = 64;                    // K4: keys per shared-memory tile
constexpr int ROWS4 = 64;                  // K4: query rows (positions x groups) a block
constexpr int VEC = 8;                     // bf16 values per 16-byte load

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

// Element offset of slot `slot` of page `id`, kv head `kvh`, in a layer arena
// [P, PAGE, Hkv, D]. Page ids are clamped into the arena.
template <int D, int PAGE>
__device__ __forceinline__ size_t page_row(int id, int slot, int num_pages, int Hkv, int kvh) {
  id = min(max(id, 0), num_pages - 1);
  return ((size_t)id * PAGE + slot) * (size_t)Hkv * D + (size_t)kvh * D;
}

// The same for position `pos` of one row, through its page table.
template <int D, int PAGE>
__device__ __forceinline__ size_t page_offset(const int* tb, int pos, int num_pages, int Hkv,
                                              int kvh) {
  return page_row<D, PAGE>(tb[pos / PAGE], pos % PAGE, num_pages, Hkv, kvh);
}

// An int8 code times its scale, rounded once to bf16, back in fp32.
__device__ __forceinline__ float dq(int code, float sc) {
  return __bfloat162float(__float2bfloat16_rn((float)code * sc));
}

// Two int8 codes (bits shift..shift+15 of a word) times their scale, each rounded once
// to bf16, as one bf16 pair.
__device__ __forceinline__ uint32_t dequant2(uint32_t word, int shift, float sc) {
  __nv_bfloat162 h = __halves2bfloat162(
      __float2bfloat16_rn((float)(int8_t)((word >> shift) & 0xffu) * sc),
      __float2bfloat16_rn((float)(int8_t)((word >> (shift + 8)) & 0xffu) * sc));
  return *reinterpret_cast<uint32_t*>(&h);
}

// Eight int8 codes dequantized: one 16-byte chunk of a bf16 tile row.
__device__ __forceinline__ uint4 dequant8(uint2 w, float sc) {
  return make_uint4(dequant2(w.x, 0, sc), dequant2(w.x, 16, sc), dequant2(w.y, 0, sc),
                    dequant2(w.y, 16, sc));
}

template <bool KV8>
using ArenaElem = typename std::conditional<KV8, int8_t, __nv_bfloat16>::type;

template <int D, int PAGE, bool KV8>
__global__ void __launch_bounds__(WARPS * 32) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const ArenaElem<KV8>* __restrict__ kp,
    const ArenaElem<KV8>* __restrict__ vp, const __nv_bfloat16* __restrict__ ksp,
    const __nv_bfloat16* __restrict__ vsp, const int* __restrict__ table,
    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ o, int maxp, int num_pages,
    int Hq, int Hkv, int window, float scale, float softcap) {
  constexpr int DL = (D + 31) / 32;      // output dimensions per lane
  extern __shared__ float4 smem4[];
  const int groups = Hq / Hkv;
  float* qs = reinterpret_cast<float*>(smem4);  // [groups][D]
  float* ms = qs + groups * D;                  // [WARPS][groups]
  float* ls = ms + WARPS * groups;              // [WARPS][groups]
  float* accs = ls + WARPS * groups;            // [WARPS][groups][D]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = min(lengths[b], maxp * PAGE);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int* tb = table + (size_t)b * maxp;

  for (int i = threadIdx.x; i < groups * D; i += blockDim.x) {
    qs[i] = __bfloat162float(q[((size_t)b * Hq + (size_t)kvh * groups) * D + i]);
  }
  __syncthreads();

  float m[MAX_GROUPS], l[MAX_GROUPS], acc[MAX_GROUPS][DL];
#pragma unroll
  for (int r = 0; r < MAX_GROUPS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DL; ++kk) acc[r][kk] = 0.f;
  }

  // Every chunk in [lo / 32, (len - 1) / 32] holds a visible key (lo < len), so each
  // processed chunk leaves a finite running max.
  const int c_last = len > 0 ? (len - 1) / 32 : -1;
  for (int c = lo / 32 + warp; c <= c_last; c += WARPS) {
    const int pos = c * 32 + lane;
    const bool vis = pos >= lo && pos < len;
    const size_t off = vis ? page_offset<D, PAGE>(tb, pos, num_pages, Hkv, kvh) : 0;
    // The key's V scale (int8 arenas): its scale page slot is off / D.
    float vscl = 0.f;
    float s[MAX_GROUPS];
#pragma unroll
    for (int r = 0; r < MAX_GROUPS; ++r) s[r] = 0.f;
    if (vis) {
      if constexpr (KV8) {
        // D int8 codes, 16 to a load; each dequantized with the key's scale.
        const float kscl = __bfloat162float(ksp[off / D]);
        vscl = __bfloat162float(vsp[off / D]);
        const uint4* krow = reinterpret_cast<const uint4*>(kp + off);
#pragma unroll
        for (int w = 0; w < D / 16; ++w) {
          const uint4 raw = krow[w];
          const int8_t* codes = reinterpret_cast<const int8_t*>(&raw);
          float kf[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) kf[e] = dq(codes[e], kscl);
#pragma unroll
          for (int r = 0; r < MAX_GROUPS; ++r) {
            if (r < groups) {
              const float* qr = qs + r * D + w * 16;
#pragma unroll
              for (int e = 0; e < 16; ++e) s[r] = fmaf(qr[e], kf[e], s[r]);
            }
          }
        }
      } else {
        const uint4* krow = reinterpret_cast<const uint4*>(kp + off);
#pragma unroll
        for (int w = 0; w < D / VEC; ++w) {
          const uint4 raw = krow[w];
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
          float kf[VEC];
#pragma unroll
          for (int e = 0; e < VEC / 2; ++e) {
            const float2 f = __bfloat1622float2(h2[e]);
            kf[2 * e] = f.x;
            kf[2 * e + 1] = f.y;
          }
#pragma unroll
          for (int r = 0; r < MAX_GROUPS; ++r) {
            if (r < groups) {
              const float* qr = qs + r * D + w * VEC;
#pragma unroll
              for (int e = 0; e < VEC; ++e) s[r] = fmaf(qr[e], kf[e], s[r]);
            }
          }
        }
      }
    }
    float p[MAX_GROUPS];
#pragma unroll
    for (int r = 0; r < MAX_GROUPS; ++r) {
      p[r] = 0.f;
      if (r < groups) {  // uniform across the block: the shuffles stay converged
        float x = s[r] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        x = vis ? x : -INFINITY;
        const float m_new = fmaxf(m[r], warp_max(x));
        const float alpha = __expf(m[r] - m_new);
        p[r] = __expf(x - m_new);
        l[r] = l[r] * alpha + warp_sum(p[r]);
#pragma unroll
        for (int kk = 0; kk < DL; ++kk) acc[r][kk] *= alpha;
        m[r] = m_new;
      }
    }
    for (int j = 0; j < 32; ++j) {
      const int vis_j = __shfl_sync(FULL, (int)vis, j);
      const unsigned long long off_j = __shfl_sync(FULL, (unsigned long long)off, j);
      float vscl_j = 0.f;
      if constexpr (KV8) vscl_j = __shfl_sync(FULL, vscl, j);
      if (!vis_j) continue;
      const ArenaElem<KV8>* vrow = vp + off_j;
      float vf[DL];
#pragma unroll
      for (int kk = 0; kk < DL; ++kk) {
        const int d = lane + kk * 32;
        if constexpr (KV8) {
          vf[kk] = d < D ? dq(vrow[d], vscl_j) : 0.f;
        } else {
          vf[kk] = d < D ? __bfloat162float(vrow[d]) : 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < MAX_GROUPS; ++r) {
        if (r < groups) {
          const float pj = __shfl_sync(FULL, p[r], j);
#pragma unroll
          for (int kk = 0; kk < DL; ++kk) acc[r][kk] = fmaf(pj, vf[kk], acc[r][kk]);
        }
      }
    }
  }

  // Merge the warps' online-softmax states. A warp that took no chunk holds m = -inf,
  // l = 0, acc = 0 and weighs nothing.
#pragma unroll
  for (int r = 0; r < MAX_GROUPS; ++r) {
    if (r < groups) {
      if (lane == 0) {
        ms[warp * groups + r] = m[r];
        ls[warp * groups + r] = l[r];
      }
#pragma unroll
      for (int kk = 0; kk < DL; ++kk) {
        const int d = lane + kk * 32;
        if (d < D) accs[(size_t)(warp * groups + r) * D + d] = acc[r][kk];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < groups * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i % D;
    float M = -INFINITY;
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, ms[w * groups + r]);
    float L = 0.f, O = 0.f;
    if (M > -INFINITY) {
      for (int w = 0; w < WARPS; ++w) {
        const float wt = __expf(ms[w * groups + r] - M);
        L += ls[w * groups + r] * wt;
        O += accs[(size_t)(w * groups + r) * D + d] * wt;
      }
    }
    o[((size_t)b * Hq + (size_t)kvh * groups + r) * D + d] =
        __float2bfloat16_rn(L > 0.f ? O / L : 0.f);
  }
}

// K4's tile of positions [k0, k0 + KT4) over an int8 arena: each thread loads 8 codes
// of one row and its scale, and stores code x scale, rounded once to bf16, where K4's
// cp.async would have put the bf16 value: the same shared-memory tile, so the tile core
// runs K4's instructions on K4's values. Positions at or past hi are zeros.
template <int D, int PAGE, int THREADS>
__device__ __forceinline__ void stage_tile_kv8(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                               const int8_t* __restrict__ kp,
                                               const int8_t* __restrict__ vp,
                                               const __nv_bfloat16* __restrict__ ksp,
                                               const __nv_bfloat16* __restrict__ vsp,
                                               const int* tbk, int k0, int hi, int num_pages,
                                               int Hkv, int kvh) {
  constexpr int CH = D / 8;
  constexpr int DS = D + 8;
  const int c = threadIdx.x % CH;
  const int id0 = PAGE >= KT4 ? tbk[0] : 0;  // the tile's one page
  for (int j = threadIdx.x / CH; j < KT4; j += THREADS / CH) {
    uint4 kw = make_uint4(0u, 0u, 0u, 0u);
    uint4 vw = kw;
    if (k0 + j < hi) {
      const size_t off = PAGE >= KT4
                             ? page_row<D, PAGE>(id0, k0 % PAGE + j, num_pages, Hkv, kvh)
                             : page_row<D, PAGE>(tbk[j / PAGE], j % PAGE, num_pages, Hkv, kvh);
      kw = dequant8(*reinterpret_cast<const uint2*>(kp + off + 8 * c),
                    __bfloat162float(ksp[off / D]));
      vw = dequant8(*reinterpret_cast<const uint2*>(vp + off + 8 * c),
                    __bfloat162float(vsp[off / D]));
    }
    *reinterpret_cast<uint4*>(ks + j * DS + 8 * c) = kw;
    *reinterpret_cast<uint4*>(vs + j * DS + 8 * c) = vw;
  }
}

template <int D, int PAGE, bool KV8>
__global__ void __launch_bounds__(ROWS4 * 2) paged_prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const ArenaElem<KV8>* __restrict__ kp,
    const ArenaElem<KV8>* __restrict__ vp, const __nv_bfloat16* __restrict__ ksp,
    const __nv_bfloat16* __restrict__ vsp, const int* __restrict__ table,
    const int* __restrict__ kv_valid, __nv_bfloat16* __restrict__ o, int T, int maxp,
    int num_pages, int Hq, int Hkv, int window, float scale, float softcap) {
  constexpr int THREADS = ROWS4 * 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const xot_mma::RowTile rt{q, o, T, Hq, Hq / Hkv, kvh, b,
                            (int)(gridDim.x - 1 - blockIdx.x) * ROWS4, kv_valid[b] - T};
  const int* tb = table + (size_t)b * maxp;
  xot_mma::attend<D, KT4, ROWS4>(
      rt, smem, maxp * PAGE, window, scale, softcap,
      [&](__nv_bfloat16* ks, __nv_bfloat16* vs, int k0, int hi) {
        const int* tbk = tb + k0 / PAGE;  // the tile's page ids: one, or one per PAGE rows
        if constexpr (KV8) {
          stage_tile_kv8<D, PAGE, THREADS>(ks, vs, kp, vp, ksp, vsp, tbk, k0, hi, num_pages, Hkv,
                                           kvh);
        } else if constexpr (PAGE >= KT4) {
          const size_t base = page_row<D, PAGE>(tbk[0], k0 % PAGE, num_pages, Hkv, kvh);
          const size_t rs = (size_t)Hkv * D;
          xot_mma::stage_tile<D, KT4, THREADS>(ks, vs, kp, vp, k0, hi,
                                               [&](int j) { return base + j * rs; });
        } else {
          xot_mma::stage_tile<D, KT4, THREADS>(ks, vs, kp, vp, k0, hi, [&](int j) {
            return page_row<D, PAGE>(tbk[j / PAGE], j % PAGE, num_pages, Hkv, kvh);
          });
        }
      });
}

template <int D, int PAGE, bool KV8>
int launch_decode(const void* q, const void* kp, const void* vp, const void* ksp,
                  const void* vsp, const int* table, const int* lengths, void* o, int B,
                  int maxp, int num_pages, int Hq, int Hkv, int window, float scale,
                  float softcap, cudaStream_t stream) {
  const int groups = Hq / Hkv;
  const size_t smem = ((size_t)groups * D + 2 * WARPS * groups + (size_t)WARPS * groups * D) *
                      sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  dim3 grid(Hkv, B);
  paged_decode_kernel<D, PAGE, KV8><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const ArenaElem<KV8>*>(kp),
      static_cast<const ArenaElem<KV8>*>(vp), static_cast<const __nv_bfloat16*>(ksp),
      static_cast<const __nv_bfloat16*>(vsp), table, lengths, static_cast<__nv_bfloat16*>(o),
      maxp, num_pages, Hq, Hkv, window, scale, softcap);
  return (int)cudaGetLastError();
}

template <int D, int PAGE, bool KV8>
int launch_prefill(const void* q, const void* kp, const void* vp, const void* ksp,
                   const void* vsp, const int* table, const int* kv_valid, void* o, int B, int T,
                   int maxp, int num_pages, int Hq, int Hkv, int window, float scale,
                   float softcap, cudaStream_t stream) {
  constexpr size_t smem = xot_mma::Shape<D, KT4, ROWS4>::SMEM;
  static_assert(smem <= 227 * 1024, "shared memory of one block");
  cudaError_t err = cudaFuncSetAttribute(paged_prefill_kernel<D, PAGE, KV8>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)T * (Hq / Hkv);
  dim3 grid((unsigned)((rows + ROWS4 - 1) / ROWS4), Hkv, B);
  paged_prefill_kernel<D, PAGE, KV8><<<grid, ROWS4 * 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const ArenaElem<KV8>*>(kp),
      static_cast<const ArenaElem<KV8>*>(vp), static_cast<const __nv_bfloat16*>(ksp),
      static_cast<const __nv_bfloat16*>(vsp), table, kv_valid, static_cast<__nv_bfloat16*>(o), T,
      maxp, num_pages, Hq, Hkv, window, scale, softcap);
  return (int)cudaGetLastError();
}

#define XOT_DISPATCH(FN, KV8, ...)                                          \
  switch (D * 1000 + page) {                                                \
    case 16 * 1000 + 16: return FN<16, 16, KV8>(__VA_ARGS__);               \
    case 16 * 1000 + 128: return FN<16, 128, KV8>(__VA_ARGS__);             \
    case 64 * 1000 + 16: return FN<64, 16, KV8>(__VA_ARGS__);               \
    case 64 * 1000 + 128: return FN<64, 128, KV8>(__VA_ARGS__);             \
    case 128 * 1000 + 16: return FN<128, 16, KV8>(__VA_ARGS__);             \
    case 128 * 1000 + 128: return FN<128, 128, KV8>(__VA_ARGS__);           \
    default: return (int)cudaErrorInvalidValue;                             \
  }

template <bool KV8>
int decode(const void* q, const void* kp, const void* vp, const void* ksp, const void* vsp,
           const void* table, const void* lengths, void* o, int B, int maxp, int P, int page,
           int Hq, int Hkv, int D, int window, float scale, float softcap, void* stream) {
  if (B < 1 || maxp < 1 || P < 1 || Hkv < 1 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (Hq / Hkv > MAX_GROUPS || Hkv > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  XOT_DISPATCH(launch_decode, KV8, q, kp, vp, ksp, vsp, tb, ln, o, B, maxp, P, Hq, Hkv, window,
               scale, softcap, s)
}

template <bool KV8>
int prefill(const void* q, const void* kp, const void* vp, const void* ksp, const void* vsp,
            const void* table, const void* kv_valid, void* o, int B, int T, int maxp, int P,
            int page, int Hq, int Hkv, int D, int block_q, int window, float scale,
            float softcap, void* stream) {
  if (B < 1 || T < 1 || maxp < 1 || P < 1 || Hkv < 1 || Hq % Hkv != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (Hq / Hkv > MAX_GROUPS || block_q != ROWS4) return (int)cudaErrorInvalidValue;
  if (Hkv > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(table);
  const int* kv = static_cast<const int*>(kv_valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  XOT_DISPATCH(launch_prefill, KV8, q, kp, vp, ksp, vsp, tb, kv, o, B, T, maxp, P, Hq, Hkv,
               window, scale, softcap, s)
}

}  // namespace

// q [B, 1, Hq, D], o [B, 1, Hq, D], k/v pages [P, page, Hkv, D]: contiguous bf16 on the
// device; table [B, maxp] and lengths [B] int32 on the device. D in {16, 64, 128}, page
// in {16, 128}, Hq / Hkv <= 8. Returns a cudaError_t value: nonzero when the arguments
// are refused or the launch failed.
extern "C" int xot_paged_decode_attention_bf16(const void* q, const void* kp, const void* vp,
                                               const void* table, const void* lengths, void* o,
                                               int B, int maxp, int P, int page, int Hq,
                                               int Hkv, int D, int window, float scale,
                                               float softcap, void* stream) {
  return decode<false>(q, kp, vp, nullptr, nullptr, table, lengths, o, B, maxp, P, page, Hq, Hkv,
                       D, window, scale, softcap, stream);
}

// K3q: as above over an int8 arena k/v pages [P, page, Hkv, D] with bf16 scale pages
// k/v_scale_pages [P, page, Hkv], contiguous on the device.
extern "C" int xot_paged_decode_attention_kv8(const void* q, const void* kp, const void* vp,
                                              const void* ksp, const void* vsp,
                                              const void* table, const void* lengths, void* o,
                                              int B, int maxp, int P, int page, int Hq, int Hkv,
                                              int D, int window, float scale, float softcap,
                                              void* stream) {
  return decode<true>(q, kp, vp, ksp, vsp, table, lengths, o, B, maxp, P, page, Hq, Hkv, D,
                      window, scale, softcap, stream);
}

// q [B, T, Hq, D], o [B, T, Hq, D], k/v pages [P, page, Hkv, D]: contiguous bf16 on the
// device; table [B, maxp] and kv_valid [B] int32 on the device (query t of row b sits
// at kv_valid[b] - T + t). D in {16, 64, 128}, page in {16, 128}, Hq / Hkv <= 8;
// block_q, the query rows a block (positions x groups flattened), is 64. Returns a
// cudaError_t value.
extern "C" int xot_paged_prefill_attention_bf16(const void* q, const void* kp, const void* vp,
                                                const void* table, const void* kv_valid,
                                                void* o, int B, int T, int maxp, int P,
                                                int page, int Hq, int Hkv, int D, int block_q,
                                                int window, float scale, float softcap,
                                                void* stream) {
  return prefill<false>(q, kp, vp, nullptr, nullptr, table, kv_valid, o, B, T, maxp, P, page, Hq,
                        Hkv, D, block_q, window, scale, softcap, stream);
}

// K4q: as above over an int8 arena with bf16 scale pages [P, page, Hkv].
extern "C" int xot_paged_prefill_attention_kv8(const void* q, const void* kp, const void* vp,
                                               const void* ksp, const void* vsp,
                                               const void* table, const void* kv_valid, void* o,
                                               int B, int T, int maxp, int P, int page, int Hq,
                                               int Hkv, int D, int block_q, int window,
                                               float scale, float softcap, void* stream) {
  return prefill<true>(q, kp, vp, ksp, vsp, table, kv_valid, o, B, T, maxp, P, page, Hq, Hkv, D,
                       block_q, window, scale, softcap, stream);
}
