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
//   - The block reads its tile with coalesced 16-byte loads (two records
//     a thread a load) into shared memory as u32, padded one word in 32
//     so that each thread's 16 consecutive records read without bank
//     conflicts; the palette (2^cbits x 16 bytes, up to 2^10 rows) is
//     staged in shared memory too.
//   - Head flags on the clamped address and a block-wide segmented scan
//     (warp shuffles, then shared memory across the 8 warps) give each
//     run of the tile one float4 sum, which the thread holding the run's
//     last record adds, times the weight, into its bin.
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

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                    // records a thread
constexpr int kTile = kThreads * kPer;      // records a block
constexpr int kPadded = kTile + kTile / 32;
constexpr int kSmemPaletteLog = 10;         // palettes staged in shared memory
constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr uint32_t kNone = 0xFFFFFFFFu;     // the clamped address of a sentinel
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__device__ __forceinline__ uint32_t bin_of(uint32_t rec, int cbits,
                                           uint32_t n_bins) {
  return rec == kSentinel ? kNone : min(rec >> cbits, n_bins);
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
  extern __shared__ float4 s_pal[];
  __shared__ uint32_t s_rec[kPadded];
  __shared__ Seg s_warp[kWarps];
  __shared__ bool s_cont[2];
  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  // sentinels sort last: a tile that starts with one holds no record
  if (static_cast<uint32_t>(recs[t0]) == kSentinel) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
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
      a = static_cast<uint32_t>(v.x);
      b = static_cast<uint32_t>(v.y);
    } else if (t0 + p < n) {
      a = static_cast<uint32_t>(recs[t0 + p]);
    }
    s_rec[padded(p)] = a;
    s_rec[padded(p + 1)] = b;
  }
  if (tid == 0) {
    // does the tile's first run continue from the record before it, or
    // its last run into the record after it?
    const long long te = t0 + kTile;
    const uint32_t first = bin_of(static_cast<uint32_t>(recs[t0]), cbits,
                                  n_bins);
    s_cont[0] = t0 > 0 &&
        bin_of(static_cast<uint32_t>(recs[t0 - 1]), cbits, n_bins) == first;
    s_cont[1] = te < n &&
        bin_of(static_cast<uint32_t>(recs[te]), cbits, n_bins) != kNone &&
        bin_of(static_cast<uint32_t>(recs[te]), cbits, n_bins) ==
            bin_of(static_cast<uint32_t>(recs[te - 1]), cbits, n_bins);
  }
  __syncthreads();

  // this thread's 16 consecutive records, and the records on each side
  uint32_t rec[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) rec[k] = s_rec[padded(tid * kPer + k)];
  const auto bin = [&](int k) { return bin_of(rec[k], cbits, n_bins); };
  const auto row = [&](int k) {
    const uint32_t q = rec[k] & qmask;
    return rec[k] == kSentinel ? make_float4(0.f, 0.f, 0.f, 0.f)
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

  Seg agg{head0, row(0)};
#pragma unroll
  for (int k = 1; k < kPer; ++k) {
    if (bin(k) != bin(k - 1)) {
      agg.f = true;
      agg.s = row(k);
    } else {
      agg.s = add(agg.s, row(k));
    }
  }
  // block-wide exclusive segmented scan of the threads' aggregates
  Seg inc = agg;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg up = shfl_up(inc, d);
    if (lane >= d) inc = combine(up, inc);
  }
  if (lane == 31) s_warp[warp] = inc;
  Seg exc = shfl_up(inc, 1);
  if (lane == 0) exc = Seg{false, make_float4(0.f, 0.f, 0.f, 0.f)};
  __syncthreads();
  Seg before{false, make_float4(0.f, 0.f, 0.f, 0.f)};
  for (int w = 0; w < warp; ++w) before = combine(before, s_warp[w]);
  exc = combine(before, exc);

  // the runs that end in this thread, each added once
  const bool cont_prev = s_cont[0];
  const bool cont_next = s_cont[1];
  bool first_run = !exc.f && !head0;     // the tile's first run is open
  float4 run = head0 ? make_float4(0.f, 0.f, 0.f, 0.f) : exc.s;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (rec[k] == kSentinel) continue;
    run = add(run, row(k));
    const uint32_t after = k + 1 < kPer ? bin(k + 1) : next;
    if (after != bin(k)) {
      const bool tile_last = tid == kThreads - 1 && k == kPer - 1;
      add_run(hist, bin(k), run, weight,
              (first_run && cont_prev) || (tile_last && cont_next));
      run = make_float4(0.f, 0.f, 0.f, 0.f);
      first_run = false;
    }
  }
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
