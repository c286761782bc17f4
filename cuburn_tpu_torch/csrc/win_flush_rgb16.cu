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
// padding) are skipped, and so is anything above it, which no u32 record
// can be; addresses past the junk bin n_bins go onto it.
//
// The contract is ONE bf16 rounding per touched bin per flush, as the
// TPU kernel rounds once per row block at write-back.  A bf16 atomicAdd
// per record would round on every add: a hot bin's colour stops growing
// once a record's share is below half an ulp (at 256.0 for palette
// values below 1), the failure the JAX package measured in its straddle
// path (pallas_hist.py, accumulate_windowed_pallas_rgb16).
//
// What bounds it on the card: the sorted records (8 bytes each) read
// once and each touched bin's 10 bytes read and written once; random
// accesses into a histogram (86 MB at 1080p with 2x supersampling) wider
// than the 50 MB L2.
//
// What the design does about it: the records are sorted, so a bin's
// records form one run.  Pass 1: each thread walks RUN consecutive
// records.  A run that starts and ends inside the thread's chunk has
// that thread as its only owner, which writes the bin directly, no
// atomics.  A run that crosses a chunk boundary adds each chunk's
// float32 partial sum into a carry row of the chunk where the run
// starts (found by binary search over the sorted keys); pass 2 lets the
// starting chunk's thread write the bin once from its carry row.  So
// every bin is written by exactly one thread, once, and the serial work
// of a thread is bounded by RUN records plus a binary search, however
// long the run (the junk bin may hold 10% of a flush).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;  // ops/flush.py RGB16_RUN
constexpr long long kSentinel = 0xFFFFFFFFLL;

// The bin a sorted record lands in, n_bins + 1 for a sentinel (or any
// value above it).  It is non-decreasing along the sorted records, so
// equal keys are one run.
__device__ __forceinline__ long long key_of(long long rec, int cbits,
                                            long long n_bins) {
  if (rec >= kSentinel) return n_bins + 1;
  const long long a = rec >> cbits;
  return a < n_bins ? a : n_bins;
}

// First index in [0, hi) whose key is >= k (hi if none).
__device__ long long lower_bound_key(const long long* __restrict__ recs,
                                     long long hi, long long k, int cbits,
                                     long long n_bins) {
  long long lo = 0;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (key_of(recs[mid], cbits, n_bins) < k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ void write_bin(float* __restrict__ dens,
                                          __nv_bfloat16* __restrict__ rgb,
                                          long long a, float4 s,
                                          float weight) {
  dens[a] = __fadd_rn(dens[a], __fmul_rn(weight, s.w));
  __nv_bfloat16* c = rgb + a * 3;
  c[0] = __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(c[0]), __fmul_rn(weight, s.x)));
  c[1] = __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(c[1]), __fmul_rn(weight, s.y)));
  c[2] = __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(c[2]), __fmul_rn(weight, s.z)));
}

__global__ void __launch_bounds__(kThreads)
rgb16_runs_kernel(const long long* __restrict__ recs, long long n,
                  const float4* __restrict__ pal4, int cbits,
                  long long n_bins, float weight, float* __restrict__ dens,
                  __nv_bfloat16* __restrict__ rgb,
                  float* __restrict__ carry) {
  const long long chunk =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long start = chunk * kRun;
  if (start >= n) return;
  const long long end = (start + kRun < n) ? start + kRun : n;
  const long long qmask = (1LL << cbits) - 1;

  long long i = start;
  while (i < end) {
    const long long k = key_of(recs[i], cbits, n_bins);
    if (k > n_bins) break;  // sentinels: all later records are too
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    long long j = i;
    for (; j < end; ++j) {
      const long long rec = recs[j];
      if (key_of(rec, cbits, n_bins) != k) break;
      const float4 p = pal4[rec & qmask];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    const bool from_before =
        i == start && start > 0 &&
        key_of(recs[start - 1], cbits, n_bins) == k;
    const bool into_next =
        j == end && end < n && key_of(recs[end], cbits, n_bins) == k;
    if (from_before || into_next) {
      // the run crosses a chunk boundary: its partial goes to the carry
      // row of the chunk that holds its first record
      const long long first =
          from_before ? lower_bound_key(recs, start, k, cbits, n_bins) : i;
      atomicAdd(reinterpret_cast<float4*>(carry) + first / kRun, s);
    } else {
      write_bin(dens, rgb, k, s, weight);
    }
    i = j;
  }
}

// Pass 2: a chunk whose last run starts inside it and continues into
// the next chunk writes that run's bin from its carry row.
__global__ void __launch_bounds__(kThreads)
rgb16_carry_kernel(const long long* __restrict__ recs, long long n,
                   int cbits, long long n_bins, float weight,
                   float* __restrict__ dens,
                   __nv_bfloat16* __restrict__ rgb,
                   const float4* __restrict__ carry) {
  const long long chunk =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long start = chunk * kRun;
  const long long end = start + kRun;
  if (end >= n) return;  // the last chunk's runs cannot continue
  const long long k = key_of(recs[end - 1], cbits, n_bins);
  if (k > n_bins || key_of(recs[end], cbits, n_bins) != k) return;
  if (start > 0 && key_of(recs[start], cbits, n_bins) == k &&
      key_of(recs[start - 1], cbits, n_bins) == k) {
    return;  // the run started in an earlier chunk, which owns it
  }
  write_bin(dens, rgb, k, carry[chunk], weight);
}

// Blocks of kThreads threads for one thread per kRun records.
unsigned blocks_for(long long n) {
  const long long chunks = (n + kRun - 1) / kRun;
  return static_cast<unsigned>((chunks + kThreads - 1) / kThreads);
}

}  // namespace

// C entries for ctypes, one kernel each, launched in this order on the
// same stream: win_flush_rgb16_runs, then win_flush_rgb16_carry.  recs:
// n sorted records (int64 holding u32 values); pal4: (2^cbits, 4)
// float32 rows, 16-byte aligned; dens: (n_bins + 1,) float32 and rgb:
// (n_bins + 1, 3) bfloat16, updated in place; carry: ceil(n / kRun) x 4
// float32 scratch, zeroed by the caller before the first.  Each launches
// on `stream` without synchronising and returns cudaGetLastError().
extern "C" int win_flush_rgb16_runs(const int64_t* recs, int64_t n,
                                    const float* pal4, int cbits,
                                    int64_t n_bins, float weight,
                                    float* dens, void* rgb, float* carry,
                                    cudaStream_t stream) {
  if (n <= 0) return 0;
  rgb16_runs_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      reinterpret_cast<const long long*>(recs), n,
      reinterpret_cast<const float4*>(pal4), cbits, n_bins, weight, dens,
      static_cast<__nv_bfloat16*>(rgb), carry);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int win_flush_rgb16_carry(const int64_t* recs, int64_t n,
                                     int cbits, int64_t n_bins,
                                     float weight, float* dens, void* rgb,
                                     const float* carry,
                                     cudaStream_t stream) {
  if (n <= 0) return 0;
  rgb16_carry_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      reinterpret_cast<const long long*>(recs), n, cbits, n_bins, weight,
      dens, static_cast<__nv_bfloat16*>(rgb),
      reinterpret_cast<const float4*>(carry));
  return static_cast<int>(cudaGetLastError());
}
