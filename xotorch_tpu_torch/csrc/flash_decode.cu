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
// bf16 scale per (position, head), k/v_scale [B, S, Hkv]. Its loader fetches the next
// tile's codes and scales into registers while the current tile is computed, then stores
// code x scale, rounded once to bf16, into the very tiles K2's cp.async copies fill
// (attention_mma.cuh::Kv8Tile): the product of an 8-bit integer and a bf16 significand
// is exact in fp32, so this equals the bf16 multiply of JAX's _load_kv bit for bit, and
// the rest is K2's arithmetic on K2's split plan. The cache then streams half the bytes.
//
// What bounds it: a decode step must stream the visible cache once, 2 * Lvis * Hkv * D * 2
// bytes per (batch row, layer), for about 4 * Hq * Lvis * D operations: decode is bound
// by cache bytes. Chunked-prefill segments (T in the hundreds) are bound by operations.
//
// Design, by path (one C entry point per twin picks it from T):
// - T == 1, split-K flash-decoding (decode_split.cuh): each (batch row, kv head) cache
//   range is cut into `splits` fixed ranges of `kps` keys, from the static shapes and the
//   SM count alone (ops/flash_decode.py::split_plan); the grid is (splits, Hkv x row
//   blocks of up to 8 q heads, B), so a B = 1 step spreads over the card. A split past the
//   row's position or below its window writes a neutral state without reading the
//   cache, so decode cost follows occupancy, not S (the property the Pallas kernel gets
//   from DMA elision). merge_splits_kernel then combines the splits on the same stream.
// - T > 1, the tensor-core tile core (attention_mma.cuh::attend): one block holds ROWS
//   (XOT_FD_BLOCK_Q) query rows, positions x groups of one (batch row, kv head), starting
//   at q_start[b] and capped at q_start[b] + T; 64-key tiles of the cache (rows Hkv * D
//   apart) arrive by cp.async, double-buffered, as K1's, and both products run on
//   mma.sync. Blocks run heaviest (last rows) first.
// - Head width 256 (gemma-2): segments take one tile shape, 64 rows a block (the
//   wrapper passes block_q = 64; any other value is refused), with Q re-read from shared
//   memory each tile; an int8 cache is dequantized straight into the staged tile
//   (attention_mma.cuh::stage_tile_kv8) on both paths, since a tile prefetched into
//   registers would not fit beside the accumulators.
#include <type_traits>

#include "decode_split.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int MAX_GROUPS = 64;  // q heads per kv head
constexpr int KT = 64;          // T > 1: keys a tile of the tile core
static_assert(KT == xot_split::KT, "both paths stage 64-key tiles");

// Row j of the tile at position k0 of one (batch row, kv head): rows are Hkv * D apart.
struct ContiguousRows {
  int k0;
  size_t rs;
  __device__ size_t operator()(int j) const { return (size_t)(k0 + j) * rs; }
};

// The tile loader of one (batch row, kv head) of the cache: bf16 rows by cp.async
// (load lands them), int8 rows fetched into registers by load and stored by land as
// code x scale (above D = 128 stored by load at once). A row's scale sits at
// (b * S + position) * Hkv + kvh = (base + off) / D.
template <int D, int THREADS, bool KV8>
struct CacheLoader {
  static constexpr bool DIRECT = xot_mma::kv8_direct<D>();
  const void* kc;
  const void* vc;
  const bf16* k_scale;
  const bf16* v_scale;
  size_t base, rs;
  typename std::conditional<DIRECT, xot_mma::NoLand, xot_mma::Kv8Tile<D, KT, THREADS>>::type kv8;

  __device__ __forceinline__ void load(bf16* ks, bf16* vs, int k0, int lo, int hi) {
    const ContiguousRows off{k0, rs};
    if constexpr (KV8 && DIRECT) {
      xot_mma::stage_tile_kv8<D, KT, THREADS>(
          ks, vs, static_cast<const int8_t*>(kc) + base, static_cast<const int8_t*>(vc) + base,
          k_scale + base / D, v_scale + base / D, k0, lo, hi, off);
    } else if constexpr (KV8) {
      kv8.fetch(static_cast<const int8_t*>(kc) + base, static_cast<const int8_t*>(vc) + base,
                k_scale + base / D, v_scale + base / D, k0, lo, hi, off);
    } else {
      xot_mma::stage_tile<D, KT, THREADS>(ks, vs, static_cast<const bf16*>(kc) + base,
                                          static_cast<const bf16*>(vc) + base, k0, lo, hi, off);
    }
  }
  __device__ __forceinline__ void land(bf16* ks, bf16* vs) const {
    if constexpr (KV8 && !DIRECT) kv8.land(ks, vs);
  }
};

template <int D, int R, bool KV8>
__global__ void __launch_bounds__(xot_split::THREADS) flash_cached_split_kernel(
    const bf16* __restrict__ q, const void* __restrict__ kc, const void* __restrict__ vc,
    const bf16* __restrict__ k_scale, const bf16* __restrict__ v_scale,
    const int* __restrict__ q_start, float* __restrict__ part, int S, int Hq, int Hkv,
    int splits, int kps, int window, float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = Hq / Hkv;
  const int rblocks = (groups + R - 1) / R;
  const int kvh = blockIdx.y / rblocks;
  const int g0 = (blockIdx.y % rblocks) * R;
  const int b = blockIdx.z;
  const int split = blockIdx.x;
  const int h0 = kvh * groups + g0;
  const int p = q_start[b];
  const int lo = window > 0 ? max(0, p - window + 1) : 0;
  const int s0 = split * kps;
  const size_t rs = (size_t)Hkv * D;  // elements (bf16) or bytes (int8) between positions
  const size_t base = (size_t)b * S * rs + (size_t)kvh * D;
  const size_t row0 = (size_t)b * Hq + h0;
  CacheLoader<D, xot_split::THREADS, KV8> ld{kc, vc, k_scale, v_scale, base, rs};
  xot_split::attend_split<D, R>(
      q + row0 * D, min(R, groups - g0), p, lo, s0, min(S, s0 + kps), scale, softcap, part,
      xot_split::part_ml_of(part, gridDim.z * Hq, splits, D), row0 * splits + split, splits,
      smem, [&](bf16* ks, bf16* vs, int k0, int a, int e) { ld.load(ks, vs, k0, a, e); },
      [&](bf16* ks, bf16* vs) { ld.land(ks, vs); });
}

template <int D, int ROWS, bool KV8>
__global__ void __launch_bounds__(ROWS * 2) flash_cached_segment_kernel(
    const bf16* __restrict__ q, const void* __restrict__ kc, const void* __restrict__ vc,
    const bf16* __restrict__ k_scale, const bf16* __restrict__ v_scale,
    const int* __restrict__ q_start, bf16* __restrict__ o, int T, int S, int Hq, int Hkv,
    int window, float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int start = q_start[b];
  const xot_mma::RowTile rt{q, o, T, Hq, Hq / Hkv, kvh, b,
                            (int)(gridDim.x - 1 - blockIdx.x) * ROWS, start};
  const size_t rs = (size_t)Hkv * D;
  const size_t base = (size_t)b * S * rs + (size_t)kvh * D;
  CacheLoader<D, ROWS * 2, KV8> ld{kc, vc, k_scale, v_scale, base, rs};
  xot_mma::attend<D, KT, ROWS>(
      rt, smem, min(S, start + T), window, scale, softcap,
      [&](bf16* ks, bf16* vs, int k0, int hi) { ld.load(ks, vs, k0, 0, hi); },
      [&](bf16* ks, bf16* vs) { ld.land(ks, vs); });
}

template <int D, int R, bool KV8>
int launch_split(const void* q, const void* kc, const void* vc, const void* ks, const void* vs,
                 const int* q_start, void* o, float* part, int B, int S, int Hq, int Hkv,
                 int splits, int kps, int window, float scale, float softcap,
                 cudaStream_t stream) {
  constexpr size_t smem = xot_split::Smem<D>::BYTES;
  static const int attr = xot_split::smem_limit(flash_cached_split_kernel<D, R, KV8>, smem);
  if (attr != 0) return attr;
  const int rblocks = (Hq / Hkv + R - 1) / R;
  dim3 grid(splits, Hkv * rblocks, B);
  flash_cached_split_kernel<D, R, KV8><<<grid, xot_split::THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), kc, vc, static_cast<const bf16*>(ks),
      static_cast<const bf16*>(vs), q_start, part, S, Hq, Hkv, splits, kps, window, scale,
      softcap);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return xot_split::merge_splits<D>(part, o, B * Hq, splits, stream);
}

template <int D, int ROWS, bool KV8>
int launch_segment(const void* q, const void* kc, const void* vc, const void* ks,
                   const void* vs, const int* q_start, void* o, int B, int T, int S, int Hq,
                   int Hkv, int window, float scale, float softcap, cudaStream_t stream) {
  constexpr size_t smem = xot_mma::Shape<D, KT, ROWS>::SMEM;
  static_assert(smem <= 227 * 1024, "shared memory of one block");
  static const int attr = xot_split::smem_limit(flash_cached_segment_kernel<D, ROWS, KV8>, smem);
  if (attr != 0) return attr;
  const long long rows = (long long)T * (Hq / Hkv);
  dim3 grid((unsigned)((rows + ROWS - 1) / ROWS), Hkv, B);
  flash_cached_segment_kernel<D, ROWS, KV8><<<grid, ROWS * 2, smem, stream>>>(
      static_cast<const bf16*>(q), kc, vc, static_cast<const bf16*>(ks),
      static_cast<const bf16*>(vs), q_start, static_cast<bf16*>(o), T, S, Hq, Hkv, window, scale,
      softcap);
  return (int)cudaGetLastError();
}

template <int D, bool KV8>
int launch_d(const void* q, const void* kc, const void* vc, const void* ks, const void* vs,
             const int* q_start, void* o, void* part, int B, int T, int S, int Hq, int Hkv,
             int block_q, int splits, int kps, int window, float scale, float softcap,
             cudaStream_t s) {
  if (T == 1) {
    float* pt = static_cast<float*>(part);
    switch (xot_split::rows_per_block(Hq / Hkv)) {
      case 1: return launch_split<D, 1, KV8>(q, kc, vc, ks, vs, q_start, o, pt, B, S, Hq, Hkv, splits, kps, window, scale, softcap, s);
      case 2: return launch_split<D, 2, KV8>(q, kc, vc, ks, vs, q_start, o, pt, B, S, Hq, Hkv, splits, kps, window, scale, softcap, s);
      case 4: return launch_split<D, 4, KV8>(q, kc, vc, ks, vs, q_start, o, pt, B, S, Hq, Hkv, splits, kps, window, scale, softcap, s);
      default: return launch_split<D, 8, KV8>(q, kc, vc, ks, vs, q_start, o, pt, B, S, Hq, Hkv, splits, kps, window, scale, softcap, s);
    }
  }
  if constexpr (D > 128) {
    if (block_q != 64) return (int)cudaErrorInvalidValue;
    return launch_segment<D, 64, KV8>(q, kc, vc, ks, vs, q_start, o, B, T, S, Hq, Hkv, window, scale, softcap, s);
  } else {
    switch (block_q) {
      case 64: return launch_segment<D, 64, KV8>(q, kc, vc, ks, vs, q_start, o, B, T, S, Hq, Hkv, window, scale, softcap, s);
      case 128: return launch_segment<D, 128, KV8>(q, kc, vc, ks, vs, q_start, o, B, T, S, Hq, Hkv, window, scale, softcap, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
}

template <bool KV8>
int dispatch(const void* q, const void* kc, const void* vc, const void* ks, const void* vs,
             const void* q_start, void* o, void* part, int B, int T, int S, int Hq, int Hkv,
             int D, int block_q, int splits, int kps, int window, float scale, float softcap,
             void* stream) {
  if (B < 1 || T < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const int groups = Hq / Hkv;
  if (groups > MAX_GROUPS || B > 65535) return (int)cudaErrorInvalidValue;
  const int rows = xot_split::rows_per_block(groups);
  if ((long long)Hkv * ((groups + rows - 1) / rows) > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)T * groups > 0x7fffffffLL - 128) return (int)cudaErrorInvalidValue;
  if (T == 1 && (part == nullptr || splits < 1 || kps < KT || kps % KT != 0 ||
                 (long long)splits * kps < S || (long long)(splits - 1) * kps >= S)) {
    return (int)cudaErrorInvalidValue;
  }
  const int* qs = static_cast<const int*>(q_start);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<16, KV8>(q, kc, vc, ks, vs, qs, o, part, B, T, S, Hq, Hkv, block_q, splits, kps, window, scale, softcap, s);
    case 32: return launch_d<32, KV8>(q, kc, vc, ks, vs, qs, o, part, B, T, S, Hq, Hkv, block_q, splits, kps, window, scale, softcap, s);
    case 64: return launch_d<64, KV8>(q, kc, vc, ks, vs, qs, o, part, B, T, S, Hq, Hkv, block_q, splits, kps, window, scale, softcap, s);
    case 128: return launch_d<128, KV8>(q, kc, vc, ks, vs, qs, o, part, B, T, S, Hq, Hkv, block_q, splits, kps, window, scale, softcap, s);
    case 256: return launch_d<256, KV8>(q, kc, vc, ks, vs, qs, o, part, B, T, S, Hq, Hkv, block_q, splits, kps, window, scale, softcap, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, T, Hq, D], k/v cache [B, S, Hkv, D], o [B, T, Hq, D]: contiguous bf16 on the
// device; q_start [B] int32 on the device. D in {16, 32, 64, 128, 256}, Hq / Hkv <= 64.
// T == 1: `part` holds B * Hq * splits * (D + 2) floats of scratch on the device, and
// the cache positions [0, S) are cut into `splits` ranges of `kps` keys (a multiple of
// 64; the last range reaches S). T > 1: block_q (query rows a block, positions x groups
// flattened) is 64 or 128, and 64 at D = 256; part, splits and kps are not read. Returns a cudaError_t
// value: nonzero when the arguments are refused or a launch failed.
extern "C" int xot_flash_cached_attention_bf16(const void* q, const void* kc, const void* vc,
                                               const void* q_start, void* o, void* part, int B,
                                               int T, int S, int Hq, int Hkv, int D,
                                               int block_q, int splits, int kps, int window,
                                               float scale, float softcap, void* stream) {
  return dispatch<false>(q, kc, vc, nullptr, nullptr, q_start, o, part, B, T, S, Hq, Hkv, D,
                         block_q, splits, kps, window, scale, softcap, stream);
}

// K2q: as above over an int8 cache k/v [B, S, Hkv, D] with bf16 scales k/v_scale
// [B, S, Hkv], all contiguous on the device.
extern "C" int xot_flash_cached_attention_kv8(const void* q, const void* kc, const void* vc,
                                              const void* k_scale, const void* v_scale,
                                              const void* q_start, void* o, void* part, int B,
                                              int T, int S, int Hq, int Hkv, int D, int block_q,
                                              int splits, int kps, int window, float scale,
                                              float softcap, void* stream) {
  return dispatch<true>(q, kc, vc, k_scale, v_scale, q_start, o, part, B, T, S, Hq, Hkv, D,
                        block_q, splits, kps, window, scale, softcap, stream);
}
