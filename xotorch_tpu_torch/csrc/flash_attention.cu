// K1: causal grouped-query flash attention over one prefill segment, for Hopper (sm_90a).
//
// Replaces xotorch_tpu/ops/flash_attention.py::_flash_kernel and its windowed twin
// _flash_kernel_windowed: a prefill that starts at position 0 attends over its own fresh
// K/V [B, T, Hkv, D]; query t sees keys [max(0, t - window + 1), t] (window 0 = all of
// [0, t]); scores are scaled, optionally tanh soft-capped, and never leave the SM.
//
// What bounds it: causal attention does about 2 * B * Hq * T^2 * D FLOPs (two products,
// half the square) and moves q, k, v and o once, so at prefill lengths it is bound by
// operations. This first version computes the products with fp32 FMA on CUDA cores
// (no tensor cores yet: wgmma/TMA are later work), so it runs well below the bf16
// tensor-core bound.
//
// Design. The Pallas grid walks kv blocks in order and carries the online-softmax state
// in VMEM scratch; here one CUDA block owns (b, q-head, q-tile) and loops over kv tiles
// itself. One thread owns one query row: its q row and fp32 accumulator live in
// registers, the K/V tile is staged in shared memory as fp32 and read with 16-byte
// broadcast loads (every thread of the block reads the same key at the same time), and
// scores are produced 32 keys at a time so the rescale of the accumulator is paid once
// per 32 keys. The kv loop starts at the window's lower bound and stops at the causal
// diagonal of the block's last row, so tiles the block cannot see are never read. The
// kernel masks the ragged edge (T need not be a multiple of any tile).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CHUNK = 32;  // scores a thread holds in registers at once

template <int D>
__global__ void __launch_bounds__(256) flash_prefill_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int T, int Hq, int Hkv,
    int block_k, int window, float scale, float softcap) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [block_k][D]
  float* vs = ks + block_k * D;                 // [block_k][D]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int kvh = h / (Hq / Hkv);
  const int q0 = blockIdx.x * blockDim.x;
  const int t = q0 + threadIdx.x;
  const bool row_ok = t < T;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = 0.f;
    acc[d] = 0.f;
  }
  if (row_ok) {
    const __nv_bfloat162* qp =
        reinterpret_cast<const __nv_bfloat162*>(q + (((size_t)b * T + t) * Hq + h) * D);
#pragma unroll
    for (int d = 0; d < D / 2; ++d) {
      float2 f = __bfloat1622float2(qp[d]);
      qr[2 * d] = f.x;
      qr[2 * d + 1] = f.y;
    }
  }
  float m = -INFINITY;
  float l = 0.f;

  // kv range of the whole block: [window low of its first row, diagonal of its last row].
  const int hi = min(T, q0 + (int)blockDim.x);
  int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  lo = (lo / block_k) * block_k;
  const size_t row_stride = (size_t)Hkv * D;
  const __nv_bfloat16* kb = k + (size_t)b * T * row_stride + (size_t)kvh * D;
  const __nv_bfloat16* vb = v + (size_t)b * T * row_stride + (size_t)kvh * D;

  for (int k0 = lo; k0 < hi; k0 += block_k) {
    __syncthreads();  // the previous tile is consumed
    const int n_pairs = block_k * D / 2;
    for (int i = threadIdx.x; i < n_pairs; i += blockDim.x) {
      const int j = (2 * i) / D;
      const int d = (2 * i) % D;
      const int kp = k0 + j;
      float2 kf = make_float2(0.f, 0.f);
      float2 vf = make_float2(0.f, 0.f);
      if (kp < hi) {
        kf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(kb + (size_t)kp * row_stride + d));
        vf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(vb + (size_t)kp * row_stride + d));
      }
      reinterpret_cast<float2*>(ks)[i] = kf;
      reinterpret_cast<float2*>(vs)[i] = vf;
    }
    __syncthreads();
    if (!row_ok) continue;

    const int tile_end = min(k0 + block_k, hi);
    for (int c0 = k0; c0 < tile_end; c0 += CHUNK) {
      if (c0 > t) break;                                    // past this row's diagonal
      if (window > 0 && c0 + CHUNK - 1 <= t - window) continue;  // below its window
      float s[CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) s[j] = 0.f;
      const float4* k4 = reinterpret_cast<const float4*>(ks + (c0 - k0) * D);
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float a0 = qr[4 * d4], a1 = qr[4 * d4 + 1], a2 = qr[4 * d4 + 2],
                    a3 = qr[4 * d4 + 3];
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
          const float4 kk = k4[j * (D / 4) + d4];
          s[j] = fmaf(a0, kk.x, fmaf(a1, kk.y, fmaf(a2, kk.z, fmaf(a3, kk.w, s[j]))));
        }
      }
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const int kp = c0 + j;
        float x = s[j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool vis = kp <= t;
        if (window > 0 && kp <= t - window) vis = false;
        s[j] = vis ? x : -INFINITY;
        cmax = fmaxf(cmax, s[j]);
      }
      // The chunk holds at least one visible key (the two tests above), so cmax is finite.
      const float m_new = fmaxf(m, cmax);
      const float alpha = __expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        s[j] = __expf(s[j] - m_new);
        psum += s[j];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
      const float4* v4 = reinterpret_cast<const float4*>(vs + (c0 - k0) * D);
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const float p = s[j];
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 vv = v4[j * (D / 4) + d4];
          acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
          acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
          acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
          acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }

  if (row_ok) {
    const float inv = 1.f / (l == 0.f ? 1.f : l);  // as flash_attention.py:110
    __nv_bfloat162* op =
        reinterpret_cast<__nv_bfloat162*>(o + (((size_t)b * T + t) * Hq + h) * D);
#pragma unroll
    for (int d = 0; d < D / 2; ++d) {
      op[d] = __floats2bfloat162_rn(acc[2 * d] * inv, acc[2 * d + 1] * inv);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int T, int Hq, int Hkv,
           int block_q, int block_k, int window, float scale, float softcap,
           cudaStream_t stream) {
  const size_t smem = 2 * (size_t)block_k * D * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + block_q - 1) / block_q, Hq, B);
  flash_prefill_kernel<D><<<grid, block_q, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), T, Hq, Hkv,
      block_k, window, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, T, Hq, D], k/v [B, T, Hkv, D], o [B, T, Hq, D]: contiguous bf16 on the device.
// block_q (threads per block, one query row each) is a multiple of 32 in [32, 256];
// block_k (keys per shared-memory tile) is a positive multiple of 32. Returns a
// cudaError_t value: nonzero when the arguments are refused or the launch failed.
extern "C" int xot_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                        int B, int T, int Hq, int Hkv, int D, int block_q,
                                        int block_k, int window, float scale, float softcap,
                                        void* stream) {
  if (B < 1 || T < 1 || Hkv < 1 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (block_q % 32 != 0 || block_q < 32 || block_q > 256) return (int)cudaErrorInvalidValue;
  if (block_k % CHUNK != 0 || block_k < CHUNK) return (int)cudaErrorInvalidValue;
  if (Hq > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, T, Hq, Hkv, block_q, block_k, window, scale, softcap, s);
    case 32: return launch<32>(q, k, v, o, B, T, Hq, Hkv, block_q, block_k, window, scale, softcap, s);
    case 64: return launch<64>(q, k, v, o, B, T, Hq, Hkv, block_q, block_k, window, scale, softcap, s);
    case 128: return launch<128>(q, k, v, o, B, T, Hq, Hkv, block_q, block_k, window, scale, softcap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
