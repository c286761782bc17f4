// Atomic histogram flushes for Hopper (sm_90a): unsorted records with
// aggregated atomics, and sorted records merged into runs in the kernel.
//
// Replaces two Pallas kernels of cuburn_tpu/ops/pallas_hist.py:
//   packed_flush  <- _hist_kernel, the flush of accumulate_packed_pallas
//                    (backend `pallas`): every record adds palette row q
//                    (r, g, b, density) into bin addr, in no order;
//   merged_flush  <- _hist_kernel_counted, the flush of
//                    accumulate_merged_pallas (backend `pallas_merged`):
//                    after the sort, every distinct record adds
//                    count * palette row q, count its multiplicity.
// Both add weight * that row into the logical (n_bins + 1, 4) float32
// histogram, in place, and clamp addresses past the junk bin n_bins onto
// it.
//
// What bounds them on the card: the records (8 bytes each, read once)
// and one 16-byte read-modify-write per touched bin of a histogram of up
// to 138 MB (8.63 M bins at 1080p with 2x supersampling), wider than the
// 50 MB L2; no arithmetic to speak of.  What costs time beyond that is
// atomics on one address, which serialise in L2: the junk bin takes 97%
// of the records of a render's first flush.
//
// packed_flush: 512 records a block, two a thread from one 16-byte
// load, one launch a flush, and two tiers of aggregation in front of the
// sm_90 float4 atomicAdd.
//   - The junk bin, per block: records with addr >= n_bins never reach
//     an atomic of their own.  Each thread sums its junk rows, the block
//     sums its threads' (warp shuffles, then shared memory) and makes
//     one atomic: 8192 for a flush of 2^22 junk records.  A block without
//     junk records skips the reduction after one vote.
//   - Equal addresses, per warp: __match_any_sync on the address groups
//     the lanes.  A lane alone in its group adds its row; for a group of
//     several the warp sums the group's rows by shuffles and the group's
//     lowest lane adds the sum.  On a real 1080p flush a warp seldom
//     holds two records of one bin, and the match on every warp made
//     that flush slower than one atomic a record (0.090 against 0.075
//     ms of device time on an NVIDIA H100 80GB HBM3 at 700 W,
//     chip_smoke.py phase 4 and kernel_ab.py).  So a cheap vote stands
//     in front of it: each live lane writes its lane number into a
//     per-warp table of 2048 byte slots in shared memory, at a hash of
//     its address, and reads it back; the match runs only if some lane
//     read another's number.  With the vote the real flush takes 0.074
//     ms, as one atomic a record did.
//   The tail is predicated, never an early return: every lane reaches
//   every warp collective.
//
// merged_flush: the run-length merge of the JAX package's
// merge_sorted_records happens inside the kernel, and no unique-record
// or count array reaches global memory.  One block per tile of 4096
// sorted records, staged in shared memory as in win_flush.cu.
//   - A run starts where a record differs from the one before it (the
//     tile's first record looks at the last record of the tile before).
//   - A run belongs to the tile in which it starts.  Its count is the
//     distance to the next run start: a suffix minimum over the threads'
//     first starts (warp shuffles, then shared memory) gives each thread
//     the next start after its 16 records.  Only a tile's last run can
//     reach past the tile; the records are sorted, so its end is an upper
//     bound, found by a binary search over the records after the tile
//     (about 20 loads).  A tile whose first records continue a run from
//     the left does not own them and skips them.
//   - So every distinct record has one writer and one count, and the
//     arithmetic is the plain version's: count * row first, then
//     * weight, one float4 atomicAdd into bin min(addr, n_bins) (runs of
//     different colours and of different tiles share bins).
//   - The sort's padding (0xFFFFFFFF) is one run that no one writes.
//
// packed_flush_tally, the variant the chaos loop launches
// (chaos_iterate.cu's chaos_accumulate), also adds the flush's plotted
// count, its records whose address is not the junk bin n_bins, into an
// int64 slot: block 0 adds all n records and every block with junk
// subtracts its records at the junk bin, counted inside the junk
// reduction it already makes.  A block without junk adds nothing, so the
// count costs no pass over the records and no atomic of its own.
//
// Density stays exact at weight 1.0 with a 3-column palette: its adds
// are integer counts, exact in any order up to 2^24 a bin.  The packed
// flush's rgb sums are reassociated inside a group.
//
// The TPU kernels' lane-packed (rows, 128) layout, SMEM record blocks,
// VMEM-resident histogram and the XLA merge in front of the counted
// kernel have no counterpart here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;

// packed_flush: records a thread (one 16-byte load; more loads a thread
// were no faster on a real 1080p flush), records a block, and the slots
// of a warp's vote table
constexpr int kPackedPer = 2;
constexpr int kPackedTile = kThreads * kPackedPer;
constexpr int kSlots = 2048;

// merged_flush: records a thread and a block, and the tile in shared
// memory padded one word in 32 (see win_flush.cu)
constexpr int kPer = 16;
constexpr int kTile = kThreads * kPer;
constexpr int kPadded = kTile + kTile / 32;
constexpr int kNoStart = 2 * kTile;     // no run start at or after here

__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 scale(float4 p, float s) {
  return make_float4(s * p.x, s * p.y, s * p.z, s * p.w);
}

// The sum of v over the warp's 32 lanes, in every lane.
__device__ __forceinline__ float4 warp_sum(float4 v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    v.x += __shfl_xor_sync(kFull, v.x, d);
    v.y += __shfl_xor_sync(kFull, v.y, d);
    v.z += __shfl_xor_sync(kFull, v.z, d);
    v.w += __shfl_xor_sync(kFull, v.w, d);
  }
  return v;
}

// kCount: also add the number of atomics made on `hist` to *n_atomics
// (one more atomic a warp; the debug entry).  kTally: also add the
// number of records whose address is not n_bins to *plotted.
template <bool kCount, bool kTally>
__global__ void __launch_bounds__(kThreads)
packed_flush_kernel(const long long* __restrict__ recs, long long n,
                    const float4* __restrict__ pal4, int cbits,
                    uint32_t n_bins, float weight, float4* __restrict__ hist,
                    unsigned long long* __restrict__ n_atomics,
                    unsigned long long* __restrict__ plotted) {
  __shared__ float4 s_junk[kWarps];
  __shared__ int s_junk_n[kWarps];
  __shared__ unsigned char s_slot[kWarps][kSlots];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t qmask = (1u << cbits) - 1;
  // this thread's two records; the last block's tail may hold one or
  // none
  const long long p =
      static_cast<long long>(blockIdx.x) * kPackedTile + kPackedPer * tid;
  uint32_t rec[kPackedPer] = {0, 0};
  if (p + 1 < n) {
    const longlong2 v = *reinterpret_cast<const longlong2*>(recs + p);
    rec[0] = static_cast<uint32_t>(v.x);
    rec[1] = static_cast<uint32_t>(v.y);
  } else if (p < n) {
    rec[0] = static_cast<uint32_t>(recs[p]);
  }

  float4 junk = zero4();
  bool has_junk = false;
  int made = 0;
  int at_junk = 0;    // records at the junk bin itself (kTally)
  if (kTally && blockIdx.x == 0 && tid == 0)
    atomicAdd(plotted, static_cast<unsigned long long>(n));
#pragma unroll
  for (int k = 0; k < kPackedPer; ++k) {
    const bool held = p + k < n;
    const uint32_t addr = rec[k] >> cbits;
    const bool live = held && addr < n_bins;
    const float4 row = held ? __ldg(pal4 + (rec[k] & qmask)) : zero4();
    if (held && !live) {
      junk = add(junk, row);
      has_junk = true;
      if (kTally) at_junk += addr == n_bins;
    }
    // the cheap vote: every live lane writes its number into the slot
    // its address hashes to and reads it back.  Lanes with equal
    // addresses share a slot, so all but one of them read another
    // lane's number; so may lanes whose different addresses share a
    // slot, which only costs them the match.  No lane does: no two live
    // lanes share an address, and each adds its own row.
    const uint32_t slot = ((addr * 2654435761u) >> 20) & (kSlots - 1);
    if (live) s_slot[warp][slot] = static_cast<unsigned char>(lane);
    __syncwarp();
    const bool clash = live && s_slot[warp][slot] != lane;
    if (!__any_sync(kFull, clash)) {            // the same in every lane
      if (live) {
        atomicAdd(hist + addr, scale(row, weight));
        ++made;
      }
      continue;
    }
    // a lane without a live record gets a key no other lane has
    const unsigned long long key =
        live ? addr : (1ull << 32) | static_cast<unsigned>(lane);
    const unsigned group = __match_any_sync(kFull, key);
    const bool several = (group & (group - 1)) != 0;
    const bool leader = live && lane == __ffs(group) - 1;
    if (leader && !several) {
      atomicAdd(hist + addr, scale(row, weight));
      ++made;
    }
    // groups of several lanes, one after the other, the whole warp
    // summing for each
    unsigned todo = __ballot_sync(kFull, leader && several);
    while (todo) {
      const int first = __ffs(todo) - 1;
      todo &= todo - 1;
      const unsigned members = __shfl_sync(kFull, group, first);
      const float4 s = warp_sum((members >> lane) & 1u ? row : zero4());
      if (lane == first) {
        atomicAdd(hist + addr, scale(s, weight));
        ++made;
      }
    }
  }

  // the block's junk rows: one atomic, if it has any
  if (__syncthreads_or(has_junk)) {
    const float4 s = warp_sum(junk);
    if (lane == 0) s_junk[warp] = s;
    if (kTally) {
      const int c = __reduce_add_sync(kFull, at_junk);
      if (lane == 0) s_junk_n[warp] = c;
    }
    __syncthreads();
    if (tid == 0) {
      float4 total = s_junk[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) total = add(total, s_junk[w]);
      atomicAdd(hist + n_bins, scale(total, weight));
      ++made;
      if (kTally) {
        unsigned long long c = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) c += s_junk_n[w];
        // subtracted modulo 2^64: block 0's n keeps the slot's sum
        // non-negative once every block has added
        if (c) atomicAdd(plotted, 0ull - c);
      }
    }
  }
  if (kCount) {
    const int total = __reduce_add_sync(kFull, made);
    if (lane == 0 && total)
      atomicAdd(n_atomics, static_cast<unsigned long long>(total));
  }
}

__global__ void __launch_bounds__(kThreads)
merged_flush_kernel(const long long* __restrict__ recs, long long n,
                    const float4* __restrict__ pal4, int cbits,
                    uint32_t n_bins, float weight,
                    float4* __restrict__ hist) {
  __shared__ uint32_t s_rec[kPadded];
  __shared__ int s_first[kWarps];
  __shared__ bool s_head0;
  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  // sentinels sort last: a tile that starts with one holds no record
  if (static_cast<uint32_t>(recs[t0]) == kSentinel) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t qmask = (1u << cbits) - 1;

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
    // does a run start at the tile's first record, or does it continue
    // the last run of the tile before?
    s_head0 = t0 == 0 || static_cast<uint32_t>(recs[t0 - 1]) !=
                             static_cast<uint32_t>(recs[t0]);
  }
  __syncthreads();

  // this thread's 16 consecutive records; bit k of `starts`: a run
  // starts at record k
  uint32_t rec[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) rec[k] = s_rec[padded(tid * kPer + k)];
  unsigned starts =
      tid > 0 ? rec[0] != s_rec[padded(tid * kPer - 1)] : s_head0;
#pragma unroll
  for (int k = 1; k < kPer; ++k)
    starts |= static_cast<unsigned>(rec[k] != rec[k - 1]) << k;

  // the next run start after this thread's records: the minimum of the
  // later threads' first starts
  int later = starts ? tid * kPer + __ffs(starts) - 1 : kNoStart;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int other = __shfl_down_sync(kFull, later, d);
    if (lane + d < 32) later = min(later, other);
  }
  if (lane == 0) s_first[warp] = later;
  int next = __shfl_down_sync(kFull, later, 1);
  if (lane == 31) next = kNoStart;
  __syncthreads();
  for (int w = warp + 1; w < kWarps; ++w) next = min(next, s_first[w]);

  // the runs that start in this thread, last first
#pragma unroll
  for (int k = kPer - 1; k >= 0; --k) {
    if (!((starts >> k) & 1u)) continue;
    const int pos = tid * kPer + k;
    const uint32_t r = rec[k];
    if (r != kSentinel) {
      long long count = next - pos;
      if (next == kNoStart) {
        // the run reaches the tile's end (so the tile is full): it ends
        // at the first later record that differs
        long long lo = t0 + kTile;
        if (lo < n && static_cast<uint32_t>(recs[lo]) == r) {
          long long hi = n;
          ++lo;
          while (lo < hi) {
            const long long mid = (lo + hi) >> 1;
            if (static_cast<uint32_t>(recs[mid]) == r) {
              lo = mid + 1;
            } else {
              hi = mid;
            }
          }
        }
        count = lo - (t0 + pos);
      }
      // count * row first, then the weight: the plain version's rounding
      const float4 row =
          scale(__ldg(pal4 + (r & qmask)), static_cast<float>(count));
      atomicAdd(hist + min(r >> cbits, n_bins), scale(row, weight));
    }
    next = pos;
  }
}

template <bool kCount, bool kTally>
int launch_packed(const int64_t* recs, int64_t n, const float* pal4,
                  int cbits, int64_t n_bins, float weight, float* hist,
                  unsigned long long* n_atomics,
                  unsigned long long* plotted, cudaStream_t stream) {
  if (n > 0) {
    const unsigned blocks =
        static_cast<unsigned>((n + kPackedTile - 1) / kPackedTile);
    packed_flush_kernel<kCount, kTally><<<blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const long long*>(recs), n,
        reinterpret_cast<const float4*>(pal4), cbits,
        static_cast<uint32_t>(n_bins), weight,
        reinterpret_cast<float4*>(hist), n_atomics, plotted);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entries for ctypes.  recs: int64 records holding u32 values, 16-byte
// aligned (sorted ascending for merged_flush, sentinels last); pal4:
// (2^cbits, 4) float32 rows, 16-byte aligned; hist: the (n_bins + 1, 4)
// float32 histogram, updated in place.  Each launches one kernel on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int packed_flush(const int64_t* recs, int64_t n,
                            const float* pal4, int cbits, int64_t n_bins,
                            float weight, float* hist,
                            cudaStream_t stream) {
  return launch_packed<false, false>(recs, n, pal4, cbits, n_bins, weight,
                                     hist, nullptr, nullptr, stream);
}

// packed_flush that also adds its plotted count, the records whose
// address is not n_bins, to the int64 at `plotted`: the flush that
// chaos_iterate.cu's chaos_accumulate launches once a chunk, through a
// pointer to this entry.
extern "C" int packed_flush_tally(const int64_t* recs, int64_t n,
                                  const float* pal4, int cbits,
                                  int64_t n_bins, float weight, float* hist,
                                  int64_t* plotted, cudaStream_t stream) {
  return launch_packed<false, true>(
      recs, n, pal4, cbits, n_bins, weight, hist, nullptr,
      reinterpret_cast<unsigned long long*>(plotted), stream);
}

// packed_flush that also adds the atomics it makes on hist to the
// uint64 at n_atomics: a debug entry, on no render's path.
extern "C" int packed_flush_counted(const int64_t* recs, int64_t n,
                                    const float* pal4, int cbits,
                                    int64_t n_bins, float weight,
                                    float* hist,
                                    unsigned long long* n_atomics,
                                    cudaStream_t stream) {
  return launch_packed<true, false>(recs, n, pal4, cbits, n_bins, weight,
                                    hist, n_atomics, nullptr, stream);
}

extern "C" int merged_flush(const int64_t* recs, int64_t n,
                            const float* pal4, int cbits, int64_t n_bins,
                            float weight, float* hist,
                            cudaStream_t stream) {
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kTile - 1) / kTile);
    merged_flush_kernel<<<blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const long long*>(recs), n,
        reinterpret_cast<const float4*>(pal4), cbits,
        static_cast<uint32_t>(n_bins), weight,
        reinterpret_cast<float4*>(hist));
  }
  return static_cast<int>(cudaGetLastError());
}
