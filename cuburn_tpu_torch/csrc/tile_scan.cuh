// One block's pass over a tile of sorted packed records: the part that
// win_flush.cu and win_flush_rgb16.cu share.
//
// A block of 256 threads takes a tile of 256 x kPer consecutive records
// of the sorted array (int64 holding u32 values `addr << cbits | q`;
// 0xFFFFFFFF is the sort's padding and sorts last; kPer is the kernel's
// choice).  It reads them with coalesced 16-byte loads (two records a
// thread a load) into shared memory as u32, padded one word in 32 so
// that each thread's kPer consecutive records read without bank
// conflicts; the palette (2^cbits x 16 bytes, up to 2^10 rows) is staged
// in shared memory too.  Each thread walks its records once and sums the
// palette rows of every run of equal bins.  A run that starts and ends
// inside one thread is complete there; for the others a block-wide
// segmented scan of one aggregate a thread (warp shuffles, then shared
// memory across the 8 warps) gives the sum of the run's earlier parts.
// Every sum is formed in a fixed order.  The thread that holds a run's
// last record hands the sum to the caller's sink, with two flags: the
// run continues from the record before the tile, the run continues into
// the record after it.  Sorted input means a run with neither flag has
// no record in any other tile.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tile_scan {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemPaletteLog = 10;         // palettes staged in shared memory
constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr uint32_t kNone = 0xFFFFFFFFu;     // the clamped address of a sentinel
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// A record as u32; anything that is no u32 value counts as padding.
__device__ __forceinline__ uint32_t narrow(long long rec) {
  return static_cast<unsigned long long>(rec) >= kSentinel
             ? kSentinel
             : static_cast<uint32_t>(rec);
}

__device__ __forceinline__ uint32_t bin_of(uint32_t rec, int cbits,
                                           uint32_t n_bins) {
  return rec == kSentinel ? kNone : min(rec >> cbits, n_bins);
}

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// A segmented sum: `f` says a run starts inside the segment, `s` is the
// sum of the segment's trailing run (from its last head, or all of it).
struct Seg {
  bool f;
  float4 s;
};

__device__ __forceinline__ Seg combine(Seg a, Seg b) {
  return Seg{a.f || b.f, b.f ? b.s : add(a.s, b.s)};
}

__device__ __forceinline__ Seg shfl_up(Seg x, int d) {
  return Seg{__shfl_up_sync(kFull, static_cast<int>(x.f), d) != 0,
             make_float4(__shfl_up_sync(kFull, x.s.x, d),
                         __shfl_up_sync(kFull, x.s.y, d),
                         __shfl_up_sync(kFull, x.s.z, d),
                         __shfl_up_sync(kFull, x.s.w, d))};
}

// Exclusive segmented scan of one aggregate a thread over a block of
// kBlockWarps warps, every thread of the block calling: the combination
// of `before` (what precedes the block) and the aggregates of all
// threads below this one, in thread order.  `s_warp` (kBlockWarps
// entries of shared memory) holds each warp's total afterwards; the
// caller synchronises before it is written again.
template <int kBlockWarps>
__device__ __forceinline__ Seg block_exclusive_scan(Seg agg, Seg before,
                                                    Seg* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Seg inc = agg;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg up = shfl_up(inc, d);
    if (lane >= d) inc = combine(up, inc);
  }
  if (lane == 31) s_warp[warp] = inc;
  Seg exc = shfl_up(inc, 1);
  if (lane == 0) exc = Seg{false, zero4()};
  __syncthreads();
  for (int w = 0; w < warp; ++w) before = combine(before, s_warp[w]);
  return combine(before, exc);
}

// Sentinels sort last: a tile (of kThreads x kPer records) that starts
// with one holds no record.
template <int kPer>
__device__ __forceinline__ bool tile_is_padding(
    const long long* __restrict__ recs) {
  return narrow(recs[static_cast<long long>(blockIdx.x) * kThreads * kPer]) ==
         kSentinel;
}

// The tile of blockIdx.x, which must hold a record (tile_is_padding is
// false; every thread of the block calls).  For each run of the tile
// the thread holding its last record calls
//     sink(bin, sum, from_before, into_next)
// once: `sum` the float4 sum of the run's palette rows inside the tile,
// `from_before` / `into_next` whether the record before / after the
// tile lies in the same bin.  With kSmemPalette the launch gives
// sizeof(float4) << cbits bytes of dynamic shared memory.
template <int kPer, bool kSmemPalette, typename Sink>
__device__ __forceinline__ void scan_tile(const long long* __restrict__ recs,
                                          long long n,
                                          const float4* __restrict__ pal4,
                                          int cbits, uint32_t n_bins,
                                          Sink&& sink) {
  static_assert(kPer % 2 == 0, "records are loaded in pairs");
  constexpr int kTile = kThreads * kPer;
  extern __shared__ float4 s_pal[];
  __shared__ uint32_t s_rec[kTile + kTile / 32];
  __shared__ Seg s_warp[kWarps];
  __shared__ bool s_cont[2];
  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  const int tid = threadIdx.x;
  const uint32_t qmask = (1u << cbits) - 1;

  if (kSmemPalette) {
    for (int i = tid; i <= static_cast<int>(qmask); i += kThreads)
      s_pal[i] = pal4[i];
  }
  const longlong2* pairs = reinterpret_cast<const longlong2*>(recs + t0);
#pragma unroll
  for (int m = 0; m < kPer / 2; ++m) {
    const int p = 2 * (m * kThreads + tid);
    uint32_t a = kSentinel, b = kSentinel;
    if (t0 + p + 1 < n) {
      const longlong2 v = pairs[p / 2];
      a = narrow(v.x);
      b = narrow(v.y);
    } else if (t0 + p < n) {
      a = narrow(recs[t0 + p]);
    }
    s_rec[padded(p)] = a;
    s_rec[padded(p + 1)] = b;
  }
  if (tid == 0) {
    // does the tile's first run continue from the record before it, or
    // its last run into the record after it?
    const long long te = t0 + kTile;
    const auto bin_at = [&](long long i) {
      return bin_of(narrow(recs[i]), cbits, n_bins);
    };
    s_cont[0] = t0 > 0 && bin_at(t0 - 1) == bin_at(t0);
    s_cont[1] = te < n && bin_at(te) != kNone && bin_at(te) == bin_at(te - 1);
  }
  __syncthreads();

  // this thread's kPer consecutive records, and the records on each side
  uint32_t rec[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) rec[k] = s_rec[padded(tid * kPer + k)];
  const auto bin = [&](int k) { return bin_of(rec[k], cbits, n_bins); };
  const auto row = [&](int k) {
    const uint32_t q = rec[k] & qmask;
    return rec[k] == kSentinel ? zero4()
           : kSmemPalette      ? s_pal[q]
                               : __ldg(pal4 + q);
  };
  const uint32_t prev =
      tid > 0 ? bin_of(s_rec[padded(tid * kPer - 1)], cbits, n_bins) : kNone;
  const uint32_t next =
      tid < kThreads - 1
          ? bin_of(s_rec[padded(tid * kPer + kPer)], cbits, n_bins)
          : kNone;
  // a run starts at element 0 unless it continues from the thread
  // before (the tile's first record starts no run here: s_cont[0])
  const bool head0 = tid > 0 && bin(0) != prev;

  const bool cont_prev = s_cont[0];
  const bool cont_next = s_cont[1];
  // One pass over the thread's records.  A run that starts inside the
  // thread and ends inside it needs nothing of the scan and is handed
  // over at once; the run that came in from the thread before waits for
  // the scan's sum of its earlier parts.
  bool seen_head = head0;
  float4 cur = zero4();           // the sum of the run the walk is in
  float4 open_sum = zero4();      // this thread's part of the run that came in
  uint32_t open_bin = kNone;
  bool open_ends = false, open_last = false;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (rec[k] == kSentinel) {    // padding: nothing after it is a record
      seen_head = true;
      cur = zero4();
      continue;
    }
    if (k > 0 && bin(k) != bin(k - 1)) {
      seen_head = true;
      cur = zero4();
    }
    cur = add(cur, row(k));
    const uint32_t after = k + 1 < kPer ? bin(k + 1) : next;
    if (after != bin(k)) {
      const bool tile_last = tid == kThreads - 1 && k == kPer - 1;
      if (seen_head) {
        // started at a head inside the tile, so not the tile's first run
        sink(bin(k), cur, false, tile_last && cont_next);
      } else {
        open_sum = cur;
        open_bin = bin(k);
        open_ends = true;
        open_last = tile_last;
      }
    }
  }
  // the aggregate: a run started in this thread, and the sum of its
  // trailing run (all of its records when none did)
  const Seg exc = block_exclusive_scan<kWarps>(
      Seg{seen_head, cur}, Seg{false, zero4()}, s_warp);
  // without a head in any thread before, it is the tile's first run
  if (open_ends)
    sink(open_bin, add(exc.s, open_sum), !exc.f && cont_prev,
         open_last && cont_next);
}

}  // namespace tile_scan
