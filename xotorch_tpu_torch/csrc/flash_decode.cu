// K2 and K2q: cached grouped-query attention of a query segment over the resident KV
// cache, for Hopper (sm_90a).
//
// Replaces xotorch_tpu/ops/flash_decode.py::_cached_kernel and its windowed twin
// _cached_kernel_windowed: T queries at absolute positions q_start[b] + [0, T) attend the
// contiguous cache [B, S, Hkv, D]; query position p sees cache positions
// [max(0, p - window + 1), p] (window 0 = the whole prefix). T == 1 is a decode step,
// T > 1 a chunked-prefill segment that starts at q_start > 0.
//
// K2q (KV8 = true) replaces the same kernels with quant=True: the cache is int8 with one
// bf16 scale per (position, head), k/v_scale [B, S, Hkv]. The staging loop reads int8
// words (four codes a word) and the row's scale and writes code x scale, rounded once to
// bf16, into the same shared-memory tiles K2 fills: the product of an 8-bit integer and
// a bf16 significand is exact in fp32, so this equals the bf16 multiply of JAX's _load_kv
// bit for bit. Scoring, softmax and P.V are K2's. The cache then streams half the bytes.
//
// What bounds it: a decode step must stream the visible cache once, 2 * Lvis * Hkv * D * 2
// bytes per (batch row, layer), for about 4 * Hq * Lvis * D FLOPs, so decode is bound by
// cache bytes. Chunked-prefill segments (T in the hundreds) are bound by operations.
//
// Design. One block owns (b, kv-head, q-tile) and holds every q head of that kv head:
// its rows are positions x groups (the GQA packing of flash_decode.py:243-244), so each
// K/V tile is read from device memory once for the whole group. The block loops over kv
// tiles itself, from the window's lower bound to q_start[b] + the tile's last position,
// so it never reads past the occupied prefix: decode cost follows occupancy, not S (the
// property the Pallas kernel gets from DMA elision). Inside a tile a warp takes one row
// at a time: lane j scores key j of a 32-key chunk against the row's q (q staged in
// shared memory as fp32 and read by broadcast; the K tile kept as bf16 with a padded row
// stride so the 32 lanes hit 32 banks), the chunk's max and sum are warp reductions, and
// for P.V each lane owns D/32 output dimensions. Accumulators are fp32 registers.
//
// Known limit: at decode with B = 1 the grid is B * Hkv blocks (8 for Llama-3.2-1B) on
// 132 SMs, so the kernel uses a small share of the card. Splitting the kv range across
// blocks (flash-decoding) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 8;
constexpr int MAX_ROWS = 64;               // q rows (positions x groups) per block
constexpr int RPW = MAX_ROWS / WARPS;      // rows per warp
constexpr unsigned FULL = 0xffffffffu;

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

// Four int8 codes (one 32-bit word) times a scale, each product rounded once to bf16,
// stored as two bf16 pairs at `dst` (4-byte aligned).
__device__ __forceinline__ void dequant4(uint32_t word, float sc, __nv_bfloat16* dst) {
  const float c0 = (float)(int8_t)(word & 0xffu);
  const float c1 = (float)(int8_t)((word >> 8) & 0xffu);
  const float c2 = (float)(int8_t)((word >> 16) & 0xffu);
  const float c3 = (float)(int8_t)(word >> 24);
  __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
  d2[0] = __halves2bfloat162(__float2bfloat16_rn(c0 * sc), __float2bfloat16_rn(c1 * sc));
  d2[1] = __halves2bfloat162(__float2bfloat16_rn(c2 * sc), __float2bfloat16_rn(c3 * sc));
}

template <int D, bool KV8>
__global__ void __launch_bounds__(WARPS * 32) flash_cached_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ kc,
    const void* __restrict__ vc, const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale, const int* __restrict__ q_start,
    __nv_bfloat16* __restrict__ o, int T, int S, int Hq, int Hkv, int block_q, int block_k,
    int window, float scale, float softcap) {
  constexpr int DP = D + 2;              // padded K row stride (bf16): conflict-free reads
  constexpr int DL = (D + 31) / 32;      // output dimensions per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);                        // [MAX_ROWS][D]
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(qs + MAX_ROWS * D);  // [block_k][DP]
  __nv_bfloat16* vs = ks + (size_t)block_k * DP;                      // [block_k][D]

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int groups = Hq / Hkv;
  const int rows = block_q * groups;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int start = q_start[b];
  const int t0 = blockIdx.x * block_q;
  const int t_end = min(T, t0 + block_q);

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

  // kv range of the block: [window low of its first position, its last visible position].
  const int hi = min(S, start + t_end);
  int lo = window > 0 ? max(0, start + t0 - window + 1) : 0;
  lo = (lo / block_k) * block_k;
  const size_t row_stride = (size_t)Hkv * D;  // elements (bf16) or bytes (int8)
  using Elem = typename std::conditional<KV8, int8_t, __nv_bfloat16>::type;
  const Elem* kb = static_cast<const Elem*>(kc) + (size_t)b * S * row_stride + (size_t)kvh * D;
  const Elem* vb = static_cast<const Elem*>(vc) + (size_t)b * S * row_stride + (size_t)kvh * D;

  for (int k0 = lo; k0 < hi; k0 += block_k) {
    __syncthreads();  // the previous tile is consumed (and q is staged, first time)
    if constexpr (KV8) {
      // Four codes a word; the (position, head) scale sits at (b*S + kp)*Hkv + kvh.
      constexpr int words = D / 4;
      const __nv_bfloat16* ksb = k_scale + (size_t)b * S * Hkv + kvh;
      const __nv_bfloat16* vsb = v_scale + (size_t)b * S * Hkv + kvh;
      for (int i = threadIdx.x; i < block_k * words; i += blockDim.x) {
        const int j = i / words;
        const int w = i % words;
        const int kp = k0 + j;
        uint32_t kw = 0u, vw = 0u;
        float kscl = 0.f, vscl = 0.f;
        if (kp < hi) {
          kw = reinterpret_cast<const uint32_t*>(kb + (size_t)kp * row_stride)[w];
          vw = reinterpret_cast<const uint32_t*>(vb + (size_t)kp * row_stride)[w];
          kscl = __bfloat162float(ksb[(size_t)kp * Hkv]);
          vscl = __bfloat162float(vsb[(size_t)kp * Hkv]);
        }
        dequant4(kw, kscl, ks + (size_t)j * DP + 4 * w);
        dequant4(vw, vscl, vs + (size_t)j * D + 4 * w);
      }
    } else {
      constexpr int words = D / 2;
      for (int i = threadIdx.x; i < block_k * words; i += blockDim.x) {
        const int j = i / words;
        const int w = i % words;
        const int kp = k0 + j;
        uint32_t kw = 0u, vw = 0u;
        if (kp < hi) {
          kw = reinterpret_cast<const uint32_t*>(kb + (size_t)kp * row_stride)[w];
          vw = reinterpret_cast<const uint32_t*>(vb + (size_t)kp * row_stride)[w];
        }
        reinterpret_cast<uint32_t*>(ks + (size_t)j * DP)[w] = kw;
        reinterpret_cast<uint32_t*>(vs + (size_t)j * D)[w] = vw;
      }
    }
    __syncthreads();

    const int tile_end = min(k0 + block_k, hi);
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
        const int kp = c0 + lane;
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
        bool vis = kp <= p && kp < tile_end;
        if (window > 0 && kp <= p - window) vis = false;
        s = vis ? s : -INFINITY;
        // The chunk holds at least one visible key (the tests above and p < hi).
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

template <int D, bool KV8>
int launch(const void* q, const void* kc, const void* vc, const void* ks, const void* vs,
           const int* q_start, void* o, int B, int T, int S, int Hq, int Hkv, int block_q,
           int block_k, int window, float scale, float softcap, cudaStream_t stream) {
  const size_t smem = (size_t)MAX_ROWS * D * sizeof(float) +
                      (size_t)block_k * (D + 2) * sizeof(__nv_bfloat16) +
                      (size_t)block_k * D * sizeof(__nv_bfloat16);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_cached_kernel<D, KV8>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + block_q - 1) / block_q, Hkv, B);
  flash_cached_kernel<D, KV8><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), kc, vc, static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), q_start, static_cast<__nv_bfloat16*>(o), T, S, Hq,
      Hkv, block_q, block_k, window, scale, softcap);
  return (int)cudaGetLastError();
}

template <bool KV8>
int dispatch(const void* q, const void* kc, const void* vc, const void* ks, const void* vs,
             const void* q_start, void* o, int B, int T, int S, int Hq, int Hkv, int D,
             int block_q, int block_k, int window, float scale, float softcap, void* stream) {
  if (B < 1 || T < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (block_q < 1 || block_q * (Hq / Hkv) > MAX_ROWS) return (int)cudaErrorInvalidValue;
  if (block_k % 32 != 0 || block_k < 32) return (int)cudaErrorInvalidValue;
  if (Hkv > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const int* qs = static_cast<const int*>(q_start);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16, KV8>(q, kc, vc, ks, vs, qs, o, B, T, S, Hq, Hkv, block_q, block_k, window, scale, softcap, s);
    case 32: return launch<32, KV8>(q, kc, vc, ks, vs, qs, o, B, T, S, Hq, Hkv, block_q, block_k, window, scale, softcap, s);
    case 64: return launch<64, KV8>(q, kc, vc, ks, vs, qs, o, B, T, S, Hq, Hkv, block_q, block_k, window, scale, softcap, s);
    case 128: return launch<128, KV8>(q, kc, vc, ks, vs, qs, o, B, T, S, Hq, Hkv, block_q, block_k, window, scale, softcap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, T, Hq, D], k/v cache [B, S, Hkv, D], o [B, T, Hq, D]: contiguous bf16 on the
// device; q_start [B] int32 on the device. block_q positions per block, with
// block_q * (Hq / Hkv) <= 64 rows; block_k (keys per shared-memory tile) a positive
// multiple of 32. Returns a cudaError_t value: nonzero when the arguments are refused or
// the launch failed.
extern "C" int xot_flash_cached_attention_bf16(const void* q, const void* kc, const void* vc,
                                               const void* q_start, void* o, int B, int T,
                                               int S, int Hq, int Hkv, int D, int block_q,
                                               int block_k, int window, float scale,
                                               float softcap, void* stream) {
  return dispatch<false>(q, kc, vc, nullptr, nullptr, q_start, o, B, T, S, Hq, Hkv, D, block_q,
                         block_k, window, scale, softcap, stream);
}

// K2q: as above over an int8 cache k/v [B, S, Hkv, D] with bf16 scales k/v_scale
// [B, S, Hkv], all contiguous on the device.
extern "C" int xot_flash_cached_attention_kv8(const void* q, const void* kc, const void* vc,
                                              const void* k_scale, const void* v_scale,
                                              const void* q_start, void* o, int B, int T, int S,
                                              int Hq, int Hkv, int D, int block_q, int block_k,
                                              int window, float scale, float softcap,
                                              void* stream) {
  return dispatch<true>(q, kc, vc, k_scale, v_scale, q_start, o, B, T, S, Hq, Hkv, D, block_q,
                        block_k, window, scale, softcap, stream);
}
