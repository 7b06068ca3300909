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
// - K4: one block per (q tile, kv head, row): the tile's rows are positions x groups
//   (<= 64 rows), each K/V tile of 64 keys is gathered through the table into shared
//   memory once for the whole tile, a warp scores one row at a time with lane j on key
//   j of a 32-key chunk, and the kv loop stops at the tile's last causal position: the
//   design of K2 (flash_decode.cu) with the cache rows reached through pages.
//
// K3q and K4q (KV8 = true) replace the same Pallas kernels with quant=True: the arena is
// int8 with one bf16 scale per (position, head) in scale pages [P, PAGE, Hkv], indexed by
// the same page id and slot as the payload (offset / D). K3q's lane reads its key's D
// codes with 16-byte loads and its scale; the V loop reads one code per lane and the
// key's scale. K4q's tile gather writes code x scale into K4's shared-memory tiles.
// Every dequantized value is code x scale rounded once to bf16, which equals JAX's bf16
// multiply bit for bit (an 8-bit code times a bf16 significand is exact in fp32); the
// rest is K3's and K4's arithmetic. The arena streams half the bytes.
//
// Known limits: K3 at B=1 runs Hkv blocks (8 for Llama-3.2-1B) on 132 SMs; K4 uses
// CUDA-core FMAs, no tensor cores. Both are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_GROUPS = 8;              // K3: q heads per kv head
constexpr int MAX_ROWS = 64;               // K4: q rows (positions x groups) per block
constexpr int RPW = MAX_ROWS / WARPS;      // K4: rows per warp
constexpr int KT = 64;                     // K4: keys per shared-memory tile
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

// Element offset of position `pos`, kv head `kvh`, in a layer arena [P, PAGE, Hkv, D],
// through one row's page table. Page ids are clamped into the arena.
template <int D, int PAGE>
__device__ __forceinline__ size_t page_offset(const int* tb, int pos, int num_pages, int Hkv,
                                              int kvh) {
  int phys = tb[pos / PAGE];
  phys = min(max(phys, 0), num_pages - 1);
  return ((size_t)phys * PAGE + pos % PAGE) * (size_t)Hkv * D + (size_t)kvh * D;
}

// An int8 code times its scale, rounded once to bf16, back in fp32.
__device__ __forceinline__ float dq(int code, float sc) {
  return __bfloat162float(__float2bfloat16_rn((float)code * sc));
}

// Four int8 codes (one 32-bit word) dequantized, stored as two bf16 pairs at `dst`.
__device__ __forceinline__ void dequant4(uint32_t word, float sc, __nv_bfloat16* dst) {
  __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
  d2[0] = __halves2bfloat162(__float2bfloat16_rn((float)(int8_t)(word & 0xffu) * sc),
                             __float2bfloat16_rn((float)(int8_t)((word >> 8) & 0xffu) * sc));
  d2[1] = __halves2bfloat162(__float2bfloat16_rn((float)(int8_t)((word >> 16) & 0xffu) * sc),
                             __float2bfloat16_rn((float)(int8_t)(word >> 24) * sc));
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

template <int D, int PAGE, bool KV8>
__global__ void __launch_bounds__(WARPS * 32) paged_prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const ArenaElem<KV8>* __restrict__ kp,
    const ArenaElem<KV8>* __restrict__ vp, const __nv_bfloat16* __restrict__ ksp,
    const __nv_bfloat16* __restrict__ vsp, const int* __restrict__ table,
    const int* __restrict__ kv_valid, __nv_bfloat16* __restrict__ o, int T, int maxp,
    int num_pages, int Hq, int Hkv, int block_q, int window, float scale, float softcap) {
  constexpr int DP = D + 2;              // padded K row stride (bf16): conflict-free reads
  constexpr int DL = (D + 31) / 32;      // output dimensions per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);                               // [MAX_ROWS][D]
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(qs + MAX_ROWS * D);   // [KT][DP]
  __nv_bfloat16* vs = ks + (size_t)KT * DP;                                  // [KT][D]

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int groups = Hq / Hkv;
  const int rows = block_q * groups;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int start = kv_valid[b] - T;     // absolute position of query 0
  const int t0 = blockIdx.x * block_q;
  const int t_end = min(T, t0 + block_q);
  const int* tb = table + (size_t)b * maxp;

  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i % D;
    const int t = t0 + r / groups;
    float x = 0.f;
    if (t < T) {
      x = __bfloat162float(q[(((size_t)b * T + t) * Hq + kvh * groups + r % groups) * D + d]);
    }
    qs[i] = x;
  }

  float m[RPW], l[RPW], acc[RPW][DL];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DL; ++kk) acc[rr][kk] = 0.f;
  }

  // kv range of the block: [window low of its first position, its last visible one].
  const int hi = min(maxp * PAGE, start + t_end);
  int lo = window > 0 ? max(0, start + t0 - window + 1) : 0;
  lo = (lo / KT) * KT;

  for (int k0 = lo; k0 < hi; k0 += KT) {
    __syncthreads();  // the previous tile is consumed (and q is staged, first time)
    if constexpr (KV8) {
      // Four codes a word, dequantized with the key's scale (scale page slot off / D).
      constexpr int words = D / 4;
      for (int i = threadIdx.x; i < KT * words; i += blockDim.x) {
        const int j = i / words;
        const int w = i % words;
        const int pos = k0 + j;
        uint32_t kw = 0u, vw = 0u;
        float kscl = 0.f, vscl = 0.f;
        if (pos < hi) {
          const size_t off = page_offset<D, PAGE>(tb, pos, num_pages, Hkv, kvh);
          kw = reinterpret_cast<const uint32_t*>(kp + off)[w];
          vw = reinterpret_cast<const uint32_t*>(vp + off)[w];
          kscl = __bfloat162float(ksp[off / D]);
          vscl = __bfloat162float(vsp[off / D]);
        }
        dequant4(kw, kscl, ks + (size_t)j * DP + 4 * w);
        dequant4(vw, vscl, vs + (size_t)j * D + 4 * w);
      }
    } else {
      constexpr int words = D / 2;
      for (int i = threadIdx.x; i < KT * words; i += blockDim.x) {
        const int j = i / words;
        const int w = i % words;
        const int pos = k0 + j;
        uint32_t kw = 0u, vw = 0u;
        if (pos < hi) {
          const size_t off = page_offset<D, PAGE>(tb, pos, num_pages, Hkv, kvh);
          kw = reinterpret_cast<const uint32_t*>(kp + off)[w];
          vw = reinterpret_cast<const uint32_t*>(vp + off)[w];
        }
        reinterpret_cast<uint32_t*>(ks + (size_t)j * DP)[w] = kw;
        reinterpret_cast<uint32_t*>(vs + (size_t)j * D)[w] = vw;
      }
    }
    __syncthreads();

    const int tile_end = min(k0 + KT, hi);
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = warp + rr * WARPS;
      if (r >= rows) break;
      const int t = t0 + r / groups;
      if (t >= T) continue;
      const int p = start + t;
      const float* qr = qs + r * D;
      for (int c0 = k0; c0 < tile_end; c0 += 32) {
        if (c0 > p) break;                                     // past the diagonal
        if (window > 0 && c0 + 31 <= p - window) continue;     // below the window
        const int pos = c0 + lane;
        const __nv_bfloat162* krow =
            reinterpret_cast<const __nv_bfloat162*>(ks + (size_t)(c0 - k0 + lane) * DP);
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int d = 0; d < D / 2; d += 2) {
          const float2 k0f = __bfloat1622float2(krow[d]);
          const float2 q0f = *reinterpret_cast<const float2*>(qr + 2 * d);
          s0 = fmaf(q0f.x, k0f.x, fmaf(q0f.y, k0f.y, s0));
          if (d + 1 < D / 2) {
            const float2 k1f = __bfloat1622float2(krow[d + 1]);
            const float2 q1f = *reinterpret_cast<const float2*>(qr + 2 * d + 2);
            s1 = fmaf(q1f.x, k1f.x, fmaf(q1f.y, k1f.y, s1));
          }
        }
        float s = (s0 + s1) * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        bool vis = pos <= p && pos < tile_end;
        if (window > 0 && pos <= p - window) vis = false;
        s = vis ? s : -INFINITY;
        // The chunk holds at least one visible key: KT is a multiple of 32, so chunks
        // never straddle a tile, and p < hi.
        const float m_new = fmaxf(m[rr], warp_max(s));
        const float alpha = __expf(m[rr] - m_new);
        const float pr = __expf(s - m_new);
        l[rr] = l[rr] * alpha + warp_sum(pr);
#pragma unroll
        for (int kk = 0; kk < DL; ++kk) acc[rr][kk] *= alpha;
        const __nv_bfloat16* vt = vs + (size_t)(c0 - k0) * D;
#pragma unroll 8
        for (int j = 0; j < 32; ++j) {
          const float pj = __shfl_sync(FULL, pr, j);
#pragma unroll
          for (int kk = 0; kk < DL; ++kk) {
            const int d = lane + kk * 32;
            if (d < D) acc[rr][kk] = fmaf(pj, __bfloat162float(vt[j * D + d]), acc[rr][kk]);
          }
        }
        m[rr] = m_new;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int r = warp + rr * WARPS;
    if (r >= rows) break;
    const int t = t0 + r / groups;
    if (t >= T) continue;
    const float inv = 1.f / (l[rr] == 0.f ? 1.f : l[rr]);
    __nv_bfloat16* op = o + (((size_t)b * T + t) * Hq + kvh * groups + r % groups) * D;
#pragma unroll
    for (int kk = 0; kk < DL; ++kk) {
      const int d = lane + kk * 32;
      if (d < D) op[d] = __float2bfloat16_rn(acc[rr][kk] * inv);
    }
  }
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
                   int maxp, int num_pages, int Hq, int Hkv, int block_q, int window,
                   float scale, float softcap, cudaStream_t stream) {
  const size_t smem = (size_t)MAX_ROWS * D * sizeof(float) +
                      (size_t)KT * (D + 2) * sizeof(__nv_bfloat16) +
                      (size_t)KT * D * sizeof(__nv_bfloat16);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      paged_prefill_kernel<D, PAGE, KV8>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + block_q - 1) / block_q, Hkv, B);
  paged_prefill_kernel<D, PAGE, KV8><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const ArenaElem<KV8>*>(kp),
      static_cast<const ArenaElem<KV8>*>(vp), static_cast<const __nv_bfloat16*>(ksp),
      static_cast<const __nv_bfloat16*>(vsp), table, kv_valid, static_cast<__nv_bfloat16*>(o), T,
      maxp, num_pages, Hq, Hkv, block_q, window, scale, softcap);
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
  if (block_q < 1 || block_q * (Hq / Hkv) > MAX_ROWS) return (int)cudaErrorInvalidValue;
  if (Hkv > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(table);
  const int* kv = static_cast<const int*>(kv_valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  XOT_DISPATCH(launch_prefill, KV8, q, kp, vp, ksp, vsp, tb, kv, o, B, T, maxp, P, Hq, Hkv,
               block_q, window, scale, softcap, s)
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
// at kv_valid[b] - T + t). block_q positions per block with block_q * (Hq / Hkv) <= 64.
// Returns a cudaError_t value.
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
