// Atomic histogram flushes for Hopper (sm_90a): unsorted and merged
// packed records.
//
// Replaces two Pallas kernels of cuburn_tpu/ops/pallas_hist.py:
//   packed_flush  <- _hist_kernel, the flush of accumulate_packed_pallas
//                    (backend `pallas`): every record adds palette row q
//                    (r, g, b, density) into bin addr, in no order;
//   merged_flush  <- _hist_kernel_counted, the flush of
//                    accumulate_merged_pallas (backend `pallas_merged`):
//                    after sort + run-merge, every unique record adds
//                    count * palette row q; count 0 is skipped.
// Both add weight * that row into the logical (n_bins + 1, 4) float32
// histogram, in place, and clamp addresses past the junk bin n_bins onto
// it.
//
// What bounds it on the card: one random 16-byte read-modify-write of a
// histogram of up to 138 MB (8.63 M bins at 1080p with 2x supersampling,
// wider than the 50 MB L2) per record; no arithmetic to speak of.  Hot
// pixels and the junk bin take many records each, and atomics on one
// address serialise in L2.
//
// What the design does about it: one thread per record, coalesced reads
// of the records, the palette row read as one float4 (the palette is a
// few KB and stays in L1/L2), and one vector float4 atomicAdd (sm_90)
// per record instead of four scalar ones.  The merged entry already
// pays one atomic per distinct (bin, colour) record rather than per
// sample, which is what merging buys on hot pixels.  Warp aggregation
// of equal addresses in the packed entry is left for a later speed
// change.  Density stays exact at weight 1.0 with a 3-column palette:
// its adds are integer counts, exact in any order.
//
// The TPU kernels' lane-packed (rows, 128) layout, SMEM record blocks and
// VMEM-resident histogram have no counterpart here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void add4(float* __restrict__ hist,
                                     long long addr, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(hist) + addr, v);
}

__device__ __forceinline__ float4 scale(float4 p, float s) {
  return make_float4(s * p.x, s * p.y, s * p.z, s * p.w);
}

__global__ void __launch_bounds__(kThreads)
packed_flush_kernel(const long long* __restrict__ recs, long long n,
                    const float4* __restrict__ pal4, int cbits,
                    long long n_bins, float weight,
                    float* __restrict__ hist) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long rec = recs[i];
  long long addr = rec >> cbits;
  if (addr > n_bins) addr = n_bins;
  add4(hist, addr, scale(pal4[rec & ((1LL << cbits) - 1)], weight));
}

__global__ void __launch_bounds__(kThreads)
merged_flush_kernel(const long long* __restrict__ uniq,
                    const int* __restrict__ counts, long long m,
                    const float4* __restrict__ pal4, int cbits,
                    long long n_bins, float weight,
                    float* __restrict__ hist) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int count = counts[i];
  if (count == 0) return;
  const long long rec = uniq[i];
  long long addr = rec >> cbits;
  if (addr > n_bins) addr = n_bins;
  // count * row first, then the weight: the plain version's rounding
  const float4 row = scale(pal4[rec & ((1LL << cbits) - 1)],
                           static_cast<float>(count));
  add4(hist, addr, scale(row, weight));
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// C entries for ctypes.  recs / uniq: int64 records holding u32 values;
// counts: int32 run counts; pal4: (2^cbits, 4) float32 rows, 16-byte
// aligned; hist: the (n_bins + 1, 4) float32 histogram, updated in place.
// Each launches on `stream` without synchronising and returns
// cudaGetLastError().
extern "C" int packed_flush(const int64_t* recs, int64_t n,
                            const float* pal4, int cbits, int64_t n_bins,
                            float weight, float* hist,
                            cudaStream_t stream) {
  if (n > 0) {
    packed_flush_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
        reinterpret_cast<const long long*>(recs), n,
        reinterpret_cast<const float4*>(pal4), cbits, n_bins, weight,
        hist);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int merged_flush(const int64_t* uniq, const int32_t* counts,
                            int64_t m, const float* pal4, int cbits,
                            int64_t n_bins, float weight, float* hist,
                            cudaStream_t stream) {
  if (m > 0) {
    merged_flush_kernel<<<blocks_for(m), kThreads, 0, stream>>>(
        reinterpret_cast<const long long*>(uniq), counts, m,
        reinterpret_cast<const float4*>(pal4), cbits, n_bins, weight,
        hist);
  }
  return static_cast<int>(cudaGetLastError());
}
