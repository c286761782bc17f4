// Windowed histogram flush for Hopper (sm_90a).
//
// Replaces cuburn_tpu/ops/pallas_hist.py::_win_kernel (in-place mode),
// the flush of accumulate_windowed_pallas.  It takes packed log records
// (addr << cbits | q) already sorted ascending and adds, for every
// record, weight * palette row q (r, g, b, density) into bin
// min(addr, n_bins) of the logical (n_bins + 1, 4) float32 histogram, in
// place.  Sentinel records (0xFFFFFFFF, the power-of-two padding of the
// sort) sort last and end the records.
//
// What bounds it on the card: the records (8 bytes each, read once) and
// one 16-byte read-modify-write per touched bin of a histogram of up to
// 138 MB (8.63 M bins at 1080p with 2x supersampling), larger than the
// 50 MB L2.  The kernel does almost no arithmetic.
//
// What the design does about it: one block per tile of 4096 sorted
// records, one launch a flush.
//   - tile_scan.cuh's scan_tile (shared with win_flush_rgb16.cu) reads
//     the tile with coalesced 16-byte loads into padded shared memory,
//     stages the palette there, and gives each run of the tile one
//     float4 sum (one walk over a thread's 16 records, then a block-wide
//     segmented scan for the runs that span threads); the thread holding
//     the run's last record adds it, times the weight, into its bin.
//   - Sorted input means a run that starts and ends inside the tile owns
//     its bin: no other block holds a record of it.  Such a run gets one
//     plain float4 read-add-write.  Only the tile's first run, when the
//     record before the tile has the same bin, and its last, when the
//     record after it does, get one sm_90 float4 atomicAdd.  A junk run
//     of 420K records costs one atomic per tile it spans.
// With a 3-column palette and weight 1.0 the density channel is a sum
// of integer counts, exact in any order.
//
// The TPU kernel's windows, tiers, one-hot matmuls, channel-planes
// layout and row-block tiling are VMEM and MXU mechanics and have no
// counterpart here.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_scan.cuh"

namespace {

using namespace tile_scan;

constexpr int kPer = 16;                    // records a thread
constexpr int kTile = kThreads * kPer;      // records a block

__device__ __forceinline__ void add_run(float4* __restrict__ hist,
                                        uint32_t bin, float4 s,
                                        float weight, bool shared) {
  const float4 w =
      make_float4(weight * s.x, weight * s.y, weight * s.z, weight * s.w);
  if (shared) {
    atomicAdd(hist + bin, w);
  } else {
    hist[bin] = add(hist[bin], w);
  }
}

template <bool kSmemPalette>
__global__ void __launch_bounds__(kThreads)
win_flush_kernel(const long long* __restrict__ recs, long long n,
                 const float4* __restrict__ pal4, int cbits,
                 uint32_t n_bins, float weight,
                 float4* __restrict__ hist) {
  if (tile_is_padding<kPer>(recs)) return;
  scan_tile<kPer, kSmemPalette>(
      recs, n, pal4, cbits, n_bins,
      [&](uint32_t bin, float4 run, bool from_before, bool into_next) {
        add_run(hist, bin, run, weight, from_before || into_next);
      });
}

}  // namespace

// C entry for ctypes.  recs: n sorted records (int64 holding u32
// values), 16-byte aligned; pal4: (2^cbits, 4) float32 palette rows,
// 16-byte aligned; hist: the (n_bins + 1, 4) float32 histogram, updated
// in place.  Launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int win_flush(const int64_t* recs, int64_t n, const float* pal4,
                         int cbits, int64_t n_bins, float weight,
                         float* hist, cudaStream_t stream) {
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kTile - 1) / kTile);
    const auto* r = reinterpret_cast<const long long*>(recs);
    const auto* p = reinterpret_cast<const float4*>(pal4);
    auto* h = reinterpret_cast<float4*>(hist);
    const auto bins = static_cast<uint32_t>(n_bins);
    if (cbits <= kSmemPaletteLog) {
      win_flush_kernel<true><<<blocks, kThreads, sizeof(float4) << cbits,
                               stream>>>(r, n, p, cbits, bins, weight, h);
    } else {
      win_flush_kernel<false><<<blocks, kThreads, 0, stream>>>(
          r, n, p, cbits, bins, weight, h);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
