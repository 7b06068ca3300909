// K3 and K4: grouped-query attention over the shared paged KV arena, for Hopper
// (sm_90a).
//
// The arena holds every resident request's cache as fixed-size pages, one layer at a
// time: k/v [P, page, Hkv, D] bf16 (any page of one or more positions, as JAX's pool), read IN PLACE (a head's rows are Hkv * D apart; no
// per-call transpose of the layer arena). Row b of a batch reaches logical page j of
// its context through table[b, j], a physical page id; page 0 is the pool's scratch
// page, the padding of every table row.
//
// K3 (paged_decode_split_kernel) replaces xotorch_tpu/ops/paged_attention.py::_paged_kernel:
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
// - K3: split-K flash-decoding on the core of decode_split.cuh. A row's positions
//   [0, maxp * page) are cut into `splits` ranges of whole 64-key tiles, fixed by the
//   table's width and the SM count (ops/flash_decode.py::split_plan), never by the
//   lengths, so the host reads none; the grid is (splits, Hkv, B). A long row spreads
//   over many blocks and a range past a short row's length exits at once, which ends
//   the imbalance of one block per (kv head, row). Each tile's page ids are read as
//   K4's loader reads them (below), and its K/V rows are staged coalesced by cp.async,
//   double-buffered; scoring and P.V read the tile. A kv head's q heads all score each
//   staged tile: up to 8 in one row block, and above 8 (llama-3.1-405b's 16,
//   mistral-large's 12) up to 4 row blocks of 8 in one block of 64 threads a row
//   block, the tile staged once for all of them (decode_split.cuh); only above 32
//   groups does a kv head take a second block. merge_splits_kernel combines the ranges
//   on the same stream.
// - K4: the tensor-core tile core of attention_mma.cuh (mma.sync, bf16 operands, fp32
//   accumulation, the Pallas kernel's two dots on the matrix unit) behind a paged
//   loader. One block per (row tile, kv head, batch row): 64 query rows, packed as
//   positions x groups (the JAX kernel's groups x T rows of one kv head), in 4 warps
//   of 16 rows, so one K/V tile serves every query head of its kv head (128-row
//   blocks of 8 warps ran slower on an H100 in every case measured: half the blocks,
//   one a SM). The rows are the flattened index t * groups + g, so a block's rows may
//   cross positions where groups does not divide 64 (12: five positions and a third of
//   the sixth); each row's mask is its own position's.
//   Tiles of 64 keys are aligned to 64 positions. Two loaders, by the page, a runtime
//   value: at a page that is a multiple of 64 a tile lies inside one page, whose id is
//   read once per tile and whose rows are Hkv * D apart (PagedRows<true>); at any other
//   page the row at position p reads id table[p / page] at slot p % page
//   (PagedRows<false>), so pages of 8, 16, 24 or 32 serve alike. bf16 tiles travel by
//   cp.async, double-buffered; the kv loop stops at the block's last row and starts at
//   its first row's window.
//
// K3q and K4q (KV8 = true) replace the same Pallas kernels with quant=True: the arena is
// int8 with one bf16 scale per (position, head) in scale pages [P, PAGE, Hkv], indexed by
// the same page id and slot as the payload (offset / D). Their loaders go through
// registers (attention_mma.cuh::Kv8Tile): the next tile's codes and scales are fetched
// while the current tile is computed, then stored as code x scale rounded once to bf16
// into the very shared-memory tiles K3's and K4's cp.async copies fill, so the rest
// runs K3's and K4's instructions. That equals JAX's
// bf16 multiply bit for bit (an 8-bit code times a bf16 significand is exact in fp32).
// The arena streams half the bytes. At head width 256 (gemma-2) an int8 tile is
// dequantized straight into shared memory instead (attention_mma.cuh::stage_tile_kv8):
// a tile prefetched into registers would not fit beside the accumulators; K4's Q rows
// stay in shared memory there and are re-read each tile.
//
// Built for head widths 16, 32, 64, 128 and 256, any page, up to 64 q heads a kv head.
#include <stdint.h>

#include <type_traits>

#include "decode_split.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int MAX_GROUPS = 64;  // K3, K4: q heads per kv head (K2's)
constexpr int KT = 64;         // K3, K4: keys a shared-memory tile, aligned to 64 positions
constexpr int ROWS4 = 64;      // K4: query rows (positions x groups) a block
static_assert(KT == xot_split::KT, "K3 stages the split core's tiles");

// Element offset of slot `slot` of page `id`, kv head `kvh`, in a layer arena
// [P, page, Hkv, D]. Page ids are clamped into the arena.
template <int D>
__device__ __forceinline__ size_t page_row(int id, int slot, int page, int num_pages, int Hkv,
                                           int kvh) {
  id = min(max(id, 0), num_pages - 1);
  return ((size_t)id * page + slot) * (size_t)Hkv * D + (size_t)kvh * D;
}

// Row j of the tile at position k0 (a multiple of KT) of one row's pages, through the
// row's table tb. TILE (the page a multiple of KT): the tile lies in one page, whose id
// is read once (base). Else each row reads its own page's id, tb[(k0 + j) / page].
// Read only for positions inside the table.
template <int D, bool TILE>
struct PagedRows {
  const int* tb;
  size_t base, rs;
  int k0, page, num_pages, Hkv, kvh;
  __device__ PagedRows(const int* tb_, int k0_, int page_, int num_pages_, int Hkv_, int kvh_)
      : tb(tb_), base(0), rs((size_t)Hkv_ * D), k0(k0_), page(page_), num_pages(num_pages_),
        Hkv(Hkv_), kvh(kvh_) {
    if (TILE) base = page_row<D>(tb[k0 / page], k0 % page, page, num_pages, Hkv, kvh);
  }
  __device__ size_t operator()(int j) const {
    if (TILE) return base + j * rs;
    const int p = k0 + j;
    return page_row<D>(tb[p / page], p % page, page, num_pages, Hkv, kvh);
  }
};

template <bool KV8>
using ArenaElem = typename std::conditional<KV8, int8_t, bf16>::type;

// The tile loader of one row's pages and one kv head: bf16 rows by cp.async (load
// lands them), int8 rows fetched into registers by load and stored by land as code x
// scale (scale pages indexed by offset / D; above D = 128 stored by load at once).
// Positions outside [lo, hi) are zeros.
template <int D, bool TILE, int THREADS, bool KV8>
struct PagedLoader {
  static constexpr bool DIRECT = xot_mma::kv8_direct<D>();
  const ArenaElem<KV8>* kp;
  const ArenaElem<KV8>* vp;
  const bf16* ksp;
  const bf16* vsp;
  const int* tb;
  int page, num_pages, Hkv, kvh;
  typename std::conditional<DIRECT, xot_mma::NoLand, xot_mma::Kv8Tile<D, KT, THREADS>>::type kv8;

  __device__ __forceinline__ void load(bf16* ks, bf16* vs, int k0, int lo, int hi) {
    const PagedRows<D, TILE> off(tb, k0, page, num_pages, Hkv, kvh);
    if constexpr (KV8 && DIRECT) {
      xot_mma::stage_tile_kv8<D, KT, THREADS>(ks, vs, kp, vp, ksp, vsp, k0, lo, hi, off);
    } else if constexpr (KV8) {
      kv8.fetch(kp, vp, ksp, vsp, k0, lo, hi, off);
    } else {
      xot_mma::stage_tile<D, KT, THREADS>(ks, vs, kp, vp, k0, lo, hi, off);
    }
  }
  __device__ __forceinline__ void land(bf16* ks, bf16* vs) const {
    if constexpr (KV8 && !DIRECT) kv8.land(ks, vs);
  }
};

// Block (split, kv head x row chunk, row): the chunk's q heads of the kv head (up to
// MAX_NB * RB; a kv head takes several chunks only above that), in blockDim.x / THREADS
// row blocks of R rows. Row blocks beyond the first exist only at R = RB, whose bound
// allows four.
template <int D, bool TILE, int R, bool KV8>
__global__ void __launch_bounds__(R == xot_split::RB ? xot_split::THREADS * xot_split::MAX_NB
                                                     : xot_split::THREADS)
paged_decode_split_kernel(
    const bf16* __restrict__ q, const ArenaElem<KV8>* __restrict__ kp,
    const ArenaElem<KV8>* __restrict__ vp, const bf16* __restrict__ ksp,
    const bf16* __restrict__ vsp, const int* __restrict__ table,
    const int* __restrict__ lengths, float* __restrict__ part, int maxp, int page,
    int num_pages, int Hq, int Hkv, int splits, int kps, int window, float scale,
    float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x;
  const int nb = blockDim.x / xot_split::THREADS;
  const int groups = Hq / Hkv;
  const int chunks = (groups + nb * R - 1) / (nb * R);
  const int kvh = blockIdx.y / chunks;
  const int g0 = (blockIdx.y % chunks) * nb * R;
  const int b = blockIdx.z;
  const int len = min(lengths[b], maxp * page);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int* tb = table + (size_t)b * maxp;
  const int s0 = split * kps;
  const size_t row0 = (size_t)b * Hq + (size_t)kvh * groups + g0;
  PagedLoader<D, TILE, xot_split::THREADS, KV8> ld{kp, vp, ksp, vsp, tb, page, num_pages, Hkv,
                                                   kvh};
  xot_split::attend_split<D, R>(
      q + row0 * D, min(nb * R, groups - g0), len - 1, lo, s0, min(maxp * page, s0 + kps),
      scale, softcap, part, xot_split::part_ml_of(part, gridDim.z * Hq, splits, D),
      row0 * splits + split, splits, smem,
      [&](bf16* ks, bf16* vs, int k0, int a, int e) { ld.load(ks, vs, k0, a, e); },
      [&](bf16* ks, bf16* vs) { ld.land(ks, vs); }, nb);
}

template <int D, bool TILE, bool KV8>
__global__ void __launch_bounds__(ROWS4 * 2) paged_prefill_kernel(
    const bf16* __restrict__ q, const ArenaElem<KV8>* __restrict__ kp,
    const ArenaElem<KV8>* __restrict__ vp, const bf16* __restrict__ ksp,
    const bf16* __restrict__ vsp, const int* __restrict__ table,
    const int* __restrict__ kv_valid, bf16* __restrict__ o, int T, int maxp, int page,
    int num_pages, int Hq, int Hkv, int window, float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const xot_mma::RowTile rt{q, o, T, Hq, Hq / Hkv, kvh, b,
                            (int)(gridDim.x - 1 - blockIdx.x) * ROWS4, kv_valid[b] - T};
  const int* tb = table + (size_t)b * maxp;
  PagedLoader<D, TILE, ROWS4 * 2, KV8> ld{kp, vp, ksp, vsp, tb, page, num_pages, Hkv, kvh};
  xot_mma::attend<D, KT, ROWS4>(
      rt, smem, maxp * page, window, scale, softcap,
      [&](bf16* ks, bf16* vs, int k0, int hi) { ld.load(ks, vs, k0, 0, hi); },
      [&](bf16* ks, bf16* vs) { ld.land(ks, vs); });
}

template <int D, bool TILE, int R, bool KV8>
int launch_decode_r(const void* q, const void* kp, const void* vp, const void* ksp,
                    const void* vsp, const int* table, const int* lengths, void* o, float* part,
                    int B, int maxp, int page, int num_pages, int Hq, int Hkv, int splits,
                    int kps, int window, float scale, float softcap, cudaStream_t stream) {
  const int groups = Hq / Hkv;
  const int nb = R == xot_split::RB ? xot_split::row_blocks(groups) : 1;
  const int chunks = (groups + nb * R - 1) / (nb * R);
  const size_t smem = xot_split::Smem<D>::bytes(nb);
  static const int attr = xot_split::smem_limit(
      paged_decode_split_kernel<D, TILE, R, KV8>,
      xot_split::Smem<D>::bytes(R == xot_split::RB ? xot_split::MAX_NB : 1));
  if (attr != 0) return attr;
  if ((long long)Hkv * chunks > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(splits, Hkv * chunks, B);
  paged_decode_split_kernel<D, TILE, R, KV8><<<grid, xot_split::THREADS * nb, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const ArenaElem<KV8>*>(kp),
      static_cast<const ArenaElem<KV8>*>(vp), static_cast<const bf16*>(ksp),
      static_cast<const bf16*>(vsp), table, lengths, part, maxp, page, num_pages, Hq, Hkv,
      splits, kps, window, scale, softcap);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return xot_split::merge_splits<D>(part, o, B * Hq, splits, stream);
}

// K3's kernel for the rows a row block computes (1, 2, 4 or 8; above 8 groups, row
// blocks of 8, up to MAX_NB of them a block).
template <int D, bool TILE, bool KV8>
int launch_decode(const void* q, const void* kp, const void* vp, const void* ksp,
                  const void* vsp, const int* table, const int* lengths, void* o, float* part,
                  int B, int maxp, int page, int num_pages, int Hq, int Hkv, int splits, int kps,
                  int window, float scale, float softcap, cudaStream_t stream) {
  switch (xot_split::rows_per_block(Hq / Hkv)) {
    case 1: return launch_decode_r<D, TILE, 1, KV8>(q, kp, vp, ksp, vsp, table, lengths, o, part, B, maxp, page, num_pages, Hq, Hkv, splits, kps, window, scale, softcap, stream);
    case 2: return launch_decode_r<D, TILE, 2, KV8>(q, kp, vp, ksp, vsp, table, lengths, o, part, B, maxp, page, num_pages, Hq, Hkv, splits, kps, window, scale, softcap, stream);
    case 4: return launch_decode_r<D, TILE, 4, KV8>(q, kp, vp, ksp, vsp, table, lengths, o, part, B, maxp, page, num_pages, Hq, Hkv, splits, kps, window, scale, softcap, stream);
    default: return launch_decode_r<D, TILE, 8, KV8>(q, kp, vp, ksp, vsp, table, lengths, o, part, B, maxp, page, num_pages, Hq, Hkv, splits, kps, window, scale, softcap, stream);
  }
}

template <int D, bool TILE, bool KV8>
int launch_prefill(const void* q, const void* kp, const void* vp, const void* ksp,
                   const void* vsp, const int* table, const int* kv_valid, void* o, int B, int T,
                   int maxp, int page, int num_pages, int Hq, int Hkv, int window, float scale,
                   float softcap, cudaStream_t stream) {
  constexpr size_t smem = xot_mma::Shape<D, KT, ROWS4>::SMEM;
  static_assert(smem <= 227 * 1024, "shared memory of one block");
  static const int attr = xot_split::smem_limit(paged_prefill_kernel<D, TILE, KV8>, smem);
  if (attr != 0) return attr;
  const long long rows = (long long)T * (Hq / Hkv);
  dim3 grid((unsigned)((rows + ROWS4 - 1) / ROWS4), Hkv, B);
  paged_prefill_kernel<D, TILE, KV8><<<grid, ROWS4 * 2, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const ArenaElem<KV8>*>(kp),
      static_cast<const ArenaElem<KV8>*>(vp), static_cast<const bf16*>(ksp),
      static_cast<const bf16*>(vsp), table, kv_valid, static_cast<bf16*>(o), T, maxp, page,
      num_pages, Hq, Hkv, window, scale, softcap);
  return (int)cudaGetLastError();
}

// The loader by the page (one page a tile at a multiple of KT, else page ids a row), then
// the head width.
#define XOT_DISPATCH(FN, KV8, ...)                                          \
  switch (D * 2 + (page % KT == 0 ? 1 : 0)) {                               \
    case 16 * 2: return FN<16, false, KV8>(__VA_ARGS__);                    \
    case 16 * 2 + 1: return FN<16, true, KV8>(__VA_ARGS__);                 \
    case 32 * 2: return FN<32, false, KV8>(__VA_ARGS__);                    \
    case 32 * 2 + 1: return FN<32, true, KV8>(__VA_ARGS__);                 \
    case 64 * 2: return FN<64, false, KV8>(__VA_ARGS__);                    \
    case 64 * 2 + 1: return FN<64, true, KV8>(__VA_ARGS__);                 \
    case 128 * 2: return FN<128, false, KV8>(__VA_ARGS__);                  \
    case 128 * 2 + 1: return FN<128, true, KV8>(__VA_ARGS__);               \
    case 256 * 2: return FN<256, false, KV8>(__VA_ARGS__);                  \
    case 256 * 2 + 1: return FN<256, true, KV8>(__VA_ARGS__);               \
    default: return (int)cudaErrorInvalidValue;                             \
  }

template <bool KV8>
int decode(const void* q, const void* kp, const void* vp, const void* ksp, const void* vsp,
           const void* table, const void* lengths, void* o, void* part, int B, int maxp, int P,
           int page, int Hq, int Hkv, int D, int splits, int kps, int window, float scale,
           float softcap, void* stream) {
  if (B < 1 || maxp < 1 || P < 1 || page < 1 || Hkv < 1 || Hq % Hkv != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (Hq / Hkv > MAX_GROUPS || Hkv > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const long long S = (long long)maxp * page;
  if (part == nullptr || splits < 1 || kps < KT || kps % KT != 0 || (long long)splits * kps < S ||
      (long long)(splits - 1) * kps >= S || S > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  float* pt = static_cast<float*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  XOT_DISPATCH(launch_decode, KV8, q, kp, vp, ksp, vsp, tb, ln, o, pt, B, maxp, page, P, Hq, Hkv,
               splits, kps, window, scale, softcap, s)
}

template <bool KV8>
int prefill(const void* q, const void* kp, const void* vp, const void* ksp, const void* vsp,
            const void* table, const void* kv_valid, void* o, int B, int T, int maxp, int P,
            int page, int Hq, int Hkv, int D, int block_q, int window, float scale,
            float softcap, void* stream) {
  if (B < 1 || T < 1 || maxp < 1 || P < 1 || page < 1 || Hkv < 1 || Hq % Hkv != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)maxp * page > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (Hq / Hkv > MAX_GROUPS || block_q != ROWS4) return (int)cudaErrorInvalidValue;
  if (Hkv > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(table);
  const int* kv = static_cast<const int*>(kv_valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  XOT_DISPATCH(launch_prefill, KV8, q, kp, vp, ksp, vsp, tb, kv, o, B, T, maxp, page, P, Hq, Hkv,
               window, scale, softcap, s)
}

}  // namespace

// The source is built in two parts side by side (ops/_build.py PARTS): XOT_PART 0
// holds the bf16 entry points, 1 the int8-KV ones; unset, both.

// q [B, 1, Hq, D], o [B, 1, Hq, D], k/v pages [P, page, Hkv, D]: contiguous bf16 on the
// device; table [B, maxp] and lengths [B] int32 on the device. D in {16, 32, 64, 128, 256},
// any page >= 1, Hq / Hkv <= 64. `part` holds B * Hq * splits * (D + 2) floats of scratch
// on the device; the positions [0, maxp * page) are cut into `splits` ranges of `kps`
// keys (a multiple of 64; the last range reaches the end). Returns a cudaError_t value:
// nonzero when the arguments are refused or a launch failed.
#if !defined(XOT_PART) || XOT_PART == 0
extern "C" int xot_paged_decode_attention_bf16(const void* q, const void* kp, const void* vp,
                                               const void* table, const void* lengths, void* o,
                                               void* part, int B, int maxp, int P, int page,
                                               int Hq, int Hkv, int D, int splits, int kps,
                                               int window, float scale, float softcap,
                                               void* stream) {
  return decode<false>(q, kp, vp, nullptr, nullptr, table, lengths, o, part, B, maxp, P, page, Hq,
                       Hkv, D, splits, kps, window, scale, softcap, stream);
}
#endif

// K3q: as above over an int8 arena k/v pages [P, page, Hkv, D] with bf16 scale pages
// k/v_scale_pages [P, page, Hkv], contiguous on the device.
#if !defined(XOT_PART) || XOT_PART == 1
extern "C" int xot_paged_decode_attention_kv8(const void* q, const void* kp, const void* vp,
                                              const void* ksp, const void* vsp,
                                              const void* table, const void* lengths, void* o,
                                              void* part, int B, int maxp, int P, int page,
                                              int Hq, int Hkv, int D, int splits, int kps,
                                              int window, float scale, float softcap,
                                              void* stream) {
  return decode<true>(q, kp, vp, ksp, vsp, table, lengths, o, part, B, maxp, P, page, Hq, Hkv, D,
                      splits, kps, window, scale, softcap, stream);
}
#endif

// q [B, T, Hq, D], o [B, T, Hq, D], k/v pages [P, page, Hkv, D]: contiguous bf16 on the
// device; table [B, maxp] and kv_valid [B] int32 on the device (query t of row b sits
// at kv_valid[b] - T + t). D in {16, 32, 64, 128, 256}, any page >= 1, Hq / Hkv <= 64;
// block_q, the query rows a block (positions x groups flattened), is 64. Returns a
// cudaError_t value.
#if !defined(XOT_PART) || XOT_PART == 0
extern "C" int xot_paged_prefill_attention_bf16(const void* q, const void* kp, const void* vp,
                                                const void* table, const void* kv_valid,
                                                void* o, int B, int T, int maxp, int P,
                                                int page, int Hq, int Hkv, int D, int block_q,
                                                int window, float scale, float softcap,
                                                void* stream) {
  return prefill<false>(q, kp, vp, nullptr, nullptr, table, kv_valid, o, B, T, maxp, P, page, Hq,
                        Hkv, D, block_q, window, scale, softcap, stream);
}
#endif

// K4q: as above over an int8 arena with bf16 scale pages [P, page, Hkv].
#if !defined(XOT_PART) || XOT_PART == 1
extern "C" int xot_paged_prefill_attention_kv8(const void* q, const void* kp, const void* vp,
                                               const void* ksp, const void* vsp,
                                               const void* table, const void* kv_valid, void* o,
                                               int B, int T, int maxp, int P, int page, int Hq,
                                               int Hkv, int D, int block_q, int window,
                                               float scale, float softcap, void* stream) {
  return prefill<true>(q, kp, vp, ksp, vsp, table, kv_valid, o, B, T, maxp, P, page, Hq, Hkv, D,
                       block_q, window, scale, softcap, stream);
}
#endif
