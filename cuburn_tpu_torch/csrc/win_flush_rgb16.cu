// Windowed histogram flush into a split f32-density / bf16-rgb histogram,
// for Hopper (sm_90a).
//
// Replaces cuburn_tpu/ops/pallas_hist.py::_win_kernel in mode "rgb16",
// the flush of accumulate_windowed_pallas_rgb16 (backend
// `pallas_rgb16`).  It takes packed log records (addr << cbits | q)
// already sorted ascending, sums palette row q (r, g, b, density) of
// every record of a bin in float32, and writes the bin once:
//     dens[a] += weight * sum.w
//     rgb[a]   = bf16(f32(rgb[a]) + weight * sum.rgb)
// The histogram is density (n_bins + 1,) float32 and rgb (n_bins + 1, 3)
// bfloat16.  Sentinel records (0xFFFFFFFF, the sort's power-of-two
// padding) sort last and add nothing, nor does anything above it, which
// no u32 record can be; addresses past the junk bin n_bins go onto it.
//
// The contract is ONE bf16 rounding per touched bin per flush, as the
// TPU kernel rounds once per row block at write-back.  A bf16 add per
// record, or per block that holds a piece of the bin's run, would round
// on every add: a hot bin's colour stops growing once a share is below
// half an ulp (at 256.0 for palette values below 1), the failure the JAX
// package measured in its straddle path (pallas_hist.py,
// accumulate_windowed_pallas_rgb16).  So every bin has exactly one
// writer, and no sum is formed by atomics: the same sorted records give
// the same bits on every call.
//
// What bounds it on the card: the sorted records (8 bytes each) read
// once and each touched bin's 10 bytes read and written once; random
// accesses into a histogram (86 MB at 1080p with 2x supersampling) wider
// than the 50 MB L2.
//
// What the design does about it: two launches a flush.
//   1. Tiles: a block per 2048 sorted records, tile_scan.cuh's scan_tile
//      (shared with win_flush.cu): coalesced 16-byte loads into shared
//      memory, the palette staged there, one float4 sum per run by one
//      walk over a thread's 8 records and a block-wide segmented scan.
//      (8 records a thread, not win_flush's 16: a thread then has fewer
//      read-modify-writes of three pieces each in a row, which measured
//      faster on the records of a real 1080p flush on an H100.)  A run
//      inside the tile has no record elsewhere, so the thread that holds
//      its last record writes its bin at once.  A run that crosses a
//      tile edge never touches the histogram here: the tile stores its
//      part of it with a plain store into its own slot of a small
//      scratch, `head` for the part of a run that came in from the tile
//      before, `tail` for the part of a run that starts here and goes on
//      into the tile after, and one word of flags (a tile that is one
//      piece of a longer run has a head that does not close).  Every
//      tile writes its flags, the ones that hold only padding too, so
//      the scratch is never zeroed.
//   2. Resolve: one block walks the tiles in order with the same
//      segmented scan over (head, tail) of each tile, each thread a few
//      consecutive tiles, and the tile in which a run closes writes that
//      bin once, from the sum of the parts in tile order.
// A junk run over two thousand tiles costs as many 16-byte stores and one
// write of the junk bin.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

constexpr int kPer = 8;                     // records a thread
constexpr int kTile = kThreads * kPer;      // records a block (RGB16_TILE)
constexpr int kResolveThreads = 1024;
constexpr int kResolveWarps = kResolveThreads / 32;
// a tile's flags, meta.x: its first run came in from the tile before
// (head holds its part, meta.y its bin), and it ends inside this tile
constexpr uint32_t kHead = 1u;
constexpr uint32_t kCloses = 2u;
// meta.z: 1 when the tile's last run starts here and goes on (tail)

// The one write of bin `a`: one float32 and three bf16 read, added to in
// float32 and stored, the bf16 rounded once.  A row of rgb is 6 bytes,
// so it is read and written as a 4-byte and a 2-byte piece, the 4-byte
// one where the row's parity puts a 4-byte boundary.
__device__ __forceinline__ void write_bin(float* __restrict__ dens,
                                          __nv_bfloat16* __restrict__ rgb,
                                          uint32_t a, float4 s,
                                          float weight) {
  dens[a] = __fadd_rn(dens[a], __fmul_rn(weight, s.w));
  uint16_t* c = reinterpret_cast<uint16_t*>(rgb) + static_cast<size_t>(a) * 3;
  const bool odd = a & 1u;      // an odd row starts 2 bytes past a boundary
  uint32_t* pair = reinterpret_cast<uint32_t*>(c + (odd ? 1 : 0));
  uint16_t* single = c + (odd ? 0 : 2);
  const uint32_t two = *pair;
  const uint16_t one = *single;
  const uint16_t lo = static_cast<uint16_t>(two & 0xFFFFu);
  const uint16_t hi = static_cast<uint16_t>(two >> 16);
  const uint16_t r0 = odd ? one : lo;
  const uint16_t g0 = odd ? lo : hi;
  const uint16_t b0 = odd ? hi : one;
  const auto plus = [weight](uint16_t bits, float sum) {
    const float v = __bfloat162float(__ushort_as_bfloat16(bits));
    return __bfloat16_as_ushort(
        __float2bfloat16_rn(__fadd_rn(v, __fmul_rn(weight, sum))));
  };
  const uint16_t r = plus(r0, s.x), g = plus(g0, s.y), b = plus(b0, s.z);
  *pair = odd ? (static_cast<uint32_t>(g) | static_cast<uint32_t>(b) << 16)
              : (static_cast<uint32_t>(r) | static_cast<uint32_t>(g) << 16);
  *single = odd ? r : b;
}

template <bool kSmemPalette>
__global__ void __launch_bounds__(kThreads)
rgb16_tiles_kernel(const long long* __restrict__ recs, long long n,
                   const float4* __restrict__ pal4, int cbits,
                   uint32_t n_bins, float weight, float* __restrict__ dens,
                   __nv_bfloat16* __restrict__ rgb,
                   float4* __restrict__ heads, float4* __restrict__ tails,
                   uint4* __restrict__ meta) {
  __shared__ uint32_t s_meta[4];
  const unsigned tile = blockIdx.x;
  if (threadIdx.x < 4) s_meta[threadIdx.x] = 0;
  // a tile of padding writes no bin and says so in its flags
  if (!tile_is_padding<kPer>(recs)) {
    // scan_tile synchronises the block before it calls the sink
    scan_tile<kPer, kSmemPalette>(
        recs, n, pal4, cbits, n_bins,
        [&](uint32_t bin, float4 run, bool from_before, bool into_next) {
          if (from_before) {
            heads[tile] = run;
            s_meta[0] = into_next ? kHead : (kHead | kCloses);
            s_meta[1] = bin;
          } else if (into_next) {
            tails[tile] = run;
            s_meta[2] = 1u;
          } else {
            write_bin(dens, rgb, bin, run, weight);
          }
        });
  }
  __syncthreads();
  if (threadIdx.x == 0)
    meta[tile] = make_uint4(s_meta[0], s_meta[1], s_meta[2], 0u);
}

// What a tile adds to the walk over the tiles in order: two items of a
// segmented sum.  Its head continues the open run; its tail, or the end
// of its head, starts anew.
struct TileItem {
  Seg seg;
  float4 head;
  uint32_t bin;
  bool writes;      // the open run closes in this tile, which writes `bin`
};

__device__ __forceinline__ TileItem item_of(const float4* __restrict__ heads,
                                            const float4* __restrict__ tails,
                                            const uint4* __restrict__ meta,
                                            long long t) {
  // all three loaded at once; a slot the flags do not name was never
  // written and is only selected away
  const uint4 m = meta[t];
  const float4 h = heads[t];
  const float4 tl = tails[t];
  const bool has_head = m.x & kHead;
  const bool closes = m.x & kCloses;
  const float4 head = has_head ? h : zero4();
  const Seg b = m.z      ? Seg{true, tl}
                : closes ? Seg{true, zero4()}
                         : Seg{false, zero4()};
  return TileItem{combine(Seg{false, head}, b), head, m.y,
                  has_head && closes};
}

// One block over all tiles in order, each thread ceil(tiles / 1024)
// consecutive tiles.  The exclusive scan gives each thread the sum of
// the open run's parts in the tiles before its own; it then walks its
// tiles again, and the tile whose head closes the run writes the bin.
__global__ void __launch_bounds__(kResolveThreads)
rgb16_resolve_kernel(const float4* __restrict__ heads,
                     const float4* __restrict__ tails,
                     const uint4* __restrict__ meta, long long tiles,
                     float weight, float* __restrict__ dens,
                     __nv_bfloat16* __restrict__ rgb) {
  __shared__ Seg s_warp[kResolveWarps];
  const long long per = (tiles + kResolveThreads - 1) / kResolveThreads;
  const long long lo = threadIdx.x * per;
  const long long hi = lo + per < tiles ? lo + per : tiles;
  Seg agg{false, zero4()};
  for (long long t = lo; t < hi; ++t)
    agg = combine(agg, item_of(heads, tails, meta, t).seg);
  Seg open = block_exclusive_scan<kResolveWarps>(
      agg, Seg{false, zero4()}, s_warp);
  for (long long t = lo; t < hi; ++t) {
    const TileItem it = item_of(heads, tails, meta, t);
    if (it.writes)
      write_bin(dens, rgb, it.bin, add(open.s, it.head), weight);
    open = combine(open, it.seg);
  }
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

// C entries for ctypes, one kernel each, launched in this order on the
// same stream: win_flush_rgb16_tiles, then win_flush_rgb16_resolve.
// recs: n sorted records (int64 holding u32 values), 16-byte aligned;
// pal4: (2^cbits, 4) float32 rows, 16-byte aligned; dens: (n_bins + 1,)
// float32 and rgb: (n_bins + 1, 3) bfloat16 (4-byte aligned), updated in
// place; scratch: 3 x ceil(n / 2048) x 16 bytes, 16-byte aligned, which
// needs no initial value: heads, tails, then the tiles' flags.  Each
// launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int win_flush_rgb16_tiles(const int64_t* recs, int64_t n,
                                     const float* pal4, int cbits,
                                     int64_t n_bins, float weight,
                                     float* dens, void* rgb, void* scratch,
                                     cudaStream_t stream) {
  if (n > 0) {
    const long long tiles = tiles_of(n);
    const auto* r = reinterpret_cast<const long long*>(recs);
    const auto* p = reinterpret_cast<const float4*>(pal4);
    auto* c = static_cast<__nv_bfloat16*>(rgb);
    auto* heads = static_cast<float4*>(scratch);
    auto* tails = heads + tiles;
    auto* meta = reinterpret_cast<uint4*>(tails + tiles);
    const auto bins = static_cast<uint32_t>(n_bins);
    const auto blocks = static_cast<unsigned>(tiles);
    if (cbits <= kSmemPaletteLog) {
      rgb16_tiles_kernel<true><<<blocks, kThreads, sizeof(float4) << cbits,
                                 stream>>>(r, n, p, cbits, bins, weight, dens,
                                           c, heads, tails, meta);
    } else {
      rgb16_tiles_kernel<false><<<blocks, kThreads, 0, stream>>>(
          r, n, p, cbits, bins, weight, dens, c, heads, tails, meta);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int win_flush_rgb16_resolve(const void* scratch, int64_t n,
                                       float weight, float* dens, void* rgb,
                                       cudaStream_t stream) {
  if (n > 0) {
    const long long tiles = tiles_of(n);
    const auto* heads = static_cast<const float4*>(scratch);
    const auto* tails = heads + tiles;
    const auto* meta = reinterpret_cast<const uint4*>(tails + tiles);
    rgb16_resolve_kernel<<<1, kResolveThreads, 0, stream>>>(
        heads, tails, meta, tiles, weight, dens,
        static_cast<__nv_bfloat16*>(rgb));
  }
  return static_cast<int>(cudaGetLastError());
}
