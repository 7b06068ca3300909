// K1: causal grouped-query flash attention over one prefill segment, for Hopper (sm_90a).
//
// Replaces xotorch_tpu/ops/flash_attention.py::_flash_kernel and its windowed twin
// _flash_kernel_windowed: a prefill that starts at position 0 attends over its own fresh
// K/V [B, T, Hkv, D]; query t sees keys [max(0, t - window + 1), t] (window 0 = all of
// [0, t]); scores are scaled, optionally tanh soft-capped, and never leave the SM.
//
// What bounds it: causal attention does about 2 * B * Hq * T^2 * D operations (two
// products, half the square) and moves q, k, v and o once, so at prefill lengths it is
// bound by operations. Both products run on the tensor cores (mma.sync, bf16 operands,
// fp32 accumulation, as the Pallas kernel's dots on the matrix unit), through the tile
// core in attention_mma.cuh.
//
// Design. The Pallas grid walks kv blocks in order and carries the online-softmax state
// in VMEM scratch; here one CUDA block owns ROWS query rows of one (batch row, kv head),
// packed as positions x groups, and loops over kv tiles itself, so each K/V tile is read
// once for all of the kv head's query heads. A contiguous loader copies the tile's rows
// (Hkv * D apart) with cp.async, double-buffered. The kv loop starts at the window's
// lower bound and stops at the block's last row, so tiles the block cannot see are never
// read; blocks run heaviest (last rows) first. The ragged edge (T need not be a multiple
// of any tile) is masked and zero-filled. At head width 256 the block takes one tile
// shape, 64 query rows by 64 keys, with Q re-read from shared memory each tile
// (attention_mma.cuh): the wrapper passes block_q = block_k = 64 there, and any other
// pair is refused.
#include "attention_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// LSE: the training forward's instantiation, which also writes each row's log-sum-exp;
// serving launches the other, whose code is that of a kernel without the output.
template <int D, int ROWS, int KT, bool LSE>
__global__ void __launch_bounds__(ROWS * 2) flash_prefill_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int T, int Hq, int Hkv, int window,
    float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const xot_mma::RowTile rt{q, o, T, Hq, Hq / Hkv, kvh, b,
                            (int)(gridDim.x - 1 - blockIdx.x) * ROWS, 0, LSE ? lse : nullptr};
  const size_t rs = (size_t)Hkv * D;  // elements between positions
  const bf16* kb = k + (size_t)b * T * rs + (size_t)kvh * D;
  const bf16* vb = v + (size_t)b * T * rs + (size_t)kvh * D;
  xot_mma::attend<D, KT, ROWS>(
      rt, smem, T, window, scale, softcap, [&](bf16* ks, bf16* vs, int k0, int hi) {
        xot_mma::stage_tile<D, KT, ROWS * 2>(ks, vs, kb, vb, k0, 0, hi,
                                             [&](int j) { return (size_t)(k0 + j) * rs; });
      });
}

template <int D, int ROWS, int KT>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int T, int Hq,
           int Hkv, int window, float scale, float softcap, cudaStream_t stream) {
  constexpr size_t smem = xot_mma::Shape<D, KT, ROWS>::SMEM;
  static_assert(smem <= 227 * 1024, "shared memory of one block");
  auto* kernel = lse != nullptr ? flash_prefill_kernel<D, ROWS, KT, true>
                                : flash_prefill_kernel<D, ROWS, KT, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)T * (Hq / Hkv);
  dim3 grid((unsigned)((rows + ROWS - 1) / ROWS), Hkv, B);
  kernel<<<grid, ROWS * 2, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), T, Hq, Hkv, window, scale, softcap);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, void* lse, int B, int T, int Hq,
             int Hkv, int block_q, int block_k, int window, float scale, float softcap,
             cudaStream_t s) {
  if constexpr (D > 128) {
    if (block_q != 64 || block_k != 64) return (int)cudaErrorInvalidValue;
    return launch<D, 64, 64>(q, k, v, o, lse, B, T, Hq, Hkv, window, scale, softcap, s);
  } else {
    switch (block_q * 1000 + block_k) {
      case 64 * 1000 + 64: return launch<D, 64, 64>(q, k, v, o, lse, B, T, Hq, Hkv, window, scale, softcap, s);
      case 64 * 1000 + 128: return launch<D, 64, 128>(q, k, v, o, lse, B, T, Hq, Hkv, window, scale, softcap, s);
      case 128 * 1000 + 64: return launch<D, 128, 64>(q, k, v, o, lse, B, T, Hq, Hkv, window, scale, softcap, s);
      case 128 * 1000 + 128: return launch<D, 128, 128>(q, k, v, o, lse, B, T, Hq, Hkv, window, scale, softcap, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
}

}  // namespace

// q [B, T, Hq, D], k/v [B, T, Hkv, D], o [B, T, Hq, D]: contiguous bf16 on the device.
// lse: null, or fp32 [B, T, Hq] that receives each row's log-sum-exp in base 2 (the
// training forward's, which K1b reads; attention_mma.cuh's epilogue states the units).
// D in {16, 32, 64, 128, 256}. block_q (query rows a block, positions x groups
// flattened; ROWS / 16 warps) and block_k (keys a shared-memory tile) are each 64 or 128,
// and both 64 at D = 256. Returns a
// cudaError_t value: nonzero when the arguments are refused or the launch failed.
extern "C" int xot_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int B, int T, int Hq, int Hkv, int D, int block_q,
                                        int block_k, int window, float scale, float softcap,
                                        void* stream) {
  if (B < 1 || T < 1 || Hkv < 1 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if ((long long)T * (Hq / Hkv) > 0x7fffffffLL - 128) return (int)cudaErrorInvalidValue;
  if (Hkv > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<16>(q, k, v, o, lse, B, T, Hq, Hkv, block_q, block_k, window, scale, softcap, s);
    case 32: return launch_d<32>(q, k, v, o, lse, B, T, Hq, Hkv, block_q, block_k, window, scale, softcap, s);
    case 64: return launch_d<64>(q, k, v, o, lse, B, T, Hq, Hkv, block_q, block_k, window, scale, softcap, s);
    case 128: return launch_d<128>(q, k, v, o, lse, B, T, Hq, Hkv, block_q, block_k, window, scale, softcap, s);
    case 256: return launch_d<256>(q, k, v, o, lse, B, T, Hq, Hkv, block_q, block_k, window, scale, softcap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
