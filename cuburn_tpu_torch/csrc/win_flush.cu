// Windowed histogram flush for Hopper (sm_90a).
//
// Replaces cuburn_tpu/ops/pallas_hist.py::_win_kernel (in-place mode),
// the flush of accumulate_windowed_pallas.  It takes packed log records
// (addr << cbits | q) already sorted ascending and adds, for every
// record, weight * palette row q (r, g, b, density) into bin addr of the
// logical (n_bins + 1, 4) float32 histogram, in place.  Sentinel
// records (0xFFFFFFFF, the power-of-two padding of the sort) are
// skipped, and addresses are clamped to the junk bin n_bins so no write
// leaves the histogram.
//
// What bounds it on the card: random 16-byte read-modify-writes into a
// histogram of up to 138 MB (8.63 M bins at 1080p with 2x supersampling),
// which is larger than the 50 MB L2.  The kernel does almost no
// arithmetic; it is bound by L2 and device-memory traffic of the
// atomics, not by compute.
//
// What the design does about it: each thread walks a contiguous run of
// RUN sorted records and keeps a running 4-channel sum while the
// address stays the same, so a hot pixel's run of records costs one
// atomicAdd per channel instead of one per record.  The weight
// multiplies each run's sum, as the TPU kernel multiplies each window's
// sum.  With a 3-column palette and weight 1.0 the density channel is a
// sum of integer counts, so it is exact whatever order the atomics land
// in.
//
// The TPU kernel's windows, tiers, one-hot matmuls, channel-planes
// layout and row-block tiling are VMEM and MXU mechanics and have no
// counterpart here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;
constexpr long long kSentinel = 0xFFFFFFFFLL;

__device__ __forceinline__ void add_run(float* __restrict__ hist,
                                        long long addr, float4 s,
                                        float weight) {
  float* bin = hist + addr * 4;
  atomicAdd(bin + 0, weight * s.x);
  atomicAdd(bin + 1, weight * s.y);
  atomicAdd(bin + 2, weight * s.z);
  atomicAdd(bin + 3, weight * s.w);
}

__global__ void __launch_bounds__(kThreads)
win_flush_kernel(const long long* __restrict__ recs, long long n,
                 const float4* __restrict__ pal4, int cbits,
                 long long n_bins, float weight,
                 float* __restrict__ hist) {
  const long long start =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) *
      kRun;
  if (start >= n) return;
  const long long end = (start + kRun < n) ? start + kRun : n;
  const long long qmask = (1LL << cbits) - 1;

  long long cur = -1;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long i = start; i < end; ++i) {
    const long long rec = recs[i];
    if (rec == kSentinel) continue;
    long long addr = rec >> cbits;
    if (addr > n_bins) addr = n_bins;
    const float4 p = pal4[rec & qmask];
    if (addr != cur) {
      if (cur >= 0) add_run(hist, cur, sum, weight);
      cur = addr;
      sum = p;
    } else {
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
  }
  if (cur >= 0) add_run(hist, cur, sum, weight);
}

}  // namespace

// C entry for ctypes.  recs: n sorted records (int64 holding u32
// values); pal4: (2^cbits, 4) float32 palette rows; hist: the
// (n_bins + 1, 4) float32 histogram, updated in place.  Launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int win_flush(const int64_t* recs, int64_t n,
                         const float* pal4, int cbits, int64_t n_bins,
                         float weight, float* hist, cudaStream_t stream) {
  if (n > 0) {
    const long long threads = (n + kRun - 1) / kRun;
    const unsigned blocks =
        static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    win_flush_kernel<<<blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const long long*>(recs), n,
        reinterpret_cast<const float4*>(pal4), cbits, n_bins, weight,
        hist);
  }
  return static_cast<int>(cudaGetLastError());
}
