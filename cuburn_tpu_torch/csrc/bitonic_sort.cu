// Tiled bitonic sort of u32 keys for Hopper (sm_90a).
//
// Replaces cuburn_tpu/ops/pallas_sort.py::_tile_kernel, the tile-local
// pass of bitonic_sort_u32_tiled, together with the XLA substages that
// function runs between its passes (`_xla_substage`).  The sort is the
// ascending bitonic network over N = 2^m keys: stage s (block size 2^s)
// runs substages of stride 2^(s-1) down to 1, and element i of a
// compare-exchange pair sorts descending when i & size is set, with i
// the GLOBAL index, so every tile leaves exactly the intermediate state
// the next global stage expects.
//
// Two entries, driven pass by pass from ops/tiled_sort.py, which owns
// the schedule (one launch a pass):
//   bitonic_local_pass   one block per tile of keys: either every stage
//                        1..15 (size == 0), or, for a later stage
//                        `size`, its strides tile/2 down to 1.
//                        The first pass of a sort reads the caller's
//                        int64 keys and the last writes int64, so the
//                        narrowing and widening cost no extra kernel.
//   bitonic_global_pass  up to four consecutive strides >= TILE of one
//                        stage over the whole array, in device memory.
//
// What bounds it on the card: device-memory passes and, inside a tile,
// instruction issue (compare-exchanges, shuffles) and barriers.  Each
// pass reads and writes the array once (2^22 u32 keys: 32 MB, about 10
// microseconds at 3.35 TB/s).
//
// What the design does about it.  A thread holds 16 keys in registers:
// the keys whose indices differ only in a window of 4 index bits, the
// other bits fixed by the thread (an "orbit").  Every stride inside the
// window is a compare-exchange between two of the thread's registers;
// a stride on the 5 lane bits is a __shfl_xor_sync.  So one pass over
// the keys runs every consecutive substage whose stride falls in the
// window or on the lanes:
//   - a global pass fuses four strides (k, k/2, k/4, k/8) of a stage,
//     the lanes on index bits 0..4 so that every access is coalesced: at
//     2^22 keys 10 global passes instead of one pass a stride (28);
//   - a local pass loads its tile (TILE = 2^15 keys, 128 KB) into shared
//     memory with coalesced 16-byte loads (the first pass narrowing the
//     caller's int64 keys, the last widening them back), runs its
//     substages in groups, each one read of the orbits from shared
//     memory, the group's substages in registers and shuffles, one write
//     back and one barrier, and stores the tile.  Strides 2^8..1 use the
//     low layout (registers on index bits 0..3, lanes on 4..8), larger
//     ones a window [j - 3, j].  Stages 1..9 are one group, a later
//     stage's strides 2^14..1 are three.  Shared memory is swizzled so
//     that neither layout has bank conflicts.
//   - every group is unrolled at compile time as plain ascending
//     min/max steps: a thread complements the keys that sort descending
//     before a stage and after it (the direction is one per thread from
//     stage 4 on, and known at compile time before).
// At 2^22 keys a sort is 18 launches: 8 local passes and 10 global.  A
// sort of fewer than 2^15 keys is the first pass over one tile, padded
// in shared memory with 0xFFFFFFFF, which sorts last and is never
// stored.  The keys are u32 values: the first pass keeps the low 32
// bits of each int64 key (ops/tiled_sort.py states the contract).  The
// TPU kernel's 2^16-key tile (256 KB of VMEM) does not fit the 227 KB a
// block may use; its lane/sublane rolls have no counterpart.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileLog = 15;          // ops/tiled_sort.py TILE_LOG
constexpr int kTile = 1 << kTileLog;
constexpr int kLowStages = 9;         // one warp's 32 lanes x 16 keys
constexpr int kKeysLog = 4;           // ops/tiled_sort.py FUSE
constexpr int kKeys = 1 << kKeysLog;
constexpr int kMaxThreads = 1024;
constexpr int kGlobalThreads = 256;
constexpr uint32_t kPad = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Index of key e of orbit o, the window at bits [wlo, wlo + kKeysLog).
template <typename T>
__device__ __forceinline__ T orbit_index(T o, int wlo, int e) {
  const T low = o & ((T(1) << wlo) - 1);
  return low | (T(e) << wlo) | ((o >> wlo) << (wlo + kKeysLog));
}

// -- ascending steps on complemented keys ------------------------------------
//
// Complementing a key (x ^ 0xFFFFFFFF) reverses the order, so a pair
// that sorts descending is an ascending pair of complemented keys.
// Where every key of a thread has one direction (every stage past 9,
// and a later pass, where it is one per warp or per block), or where it
// is known at compile time (stages 1..3, whose size bit is a register
// bit), the thread complements its descending keys, runs plain min/max
// steps unrolled at compile time, and complements them back.  Both keys
// of a pair share the size bit, so they are complemented together.

__device__ __forceinline__ void complement(uint32_t (&v)[kKeys],
                                           uint32_t mask) {
#pragma unroll
  for (int e = 0; e < kKeys; ++e) v[e] ^= mask;
}

template <int B>
__device__ __forceinline__ void ascending_register_step(uint32_t (&v)[kKeys]) {
#pragma unroll
  for (int e = 0; e < kKeys; ++e) {
    if (e & (1 << B)) continue;
    const uint32_t a = v[e], b = v[e | (1 << B)];
    v[e] = min(a, b);
    v[e | (1 << B)] = max(a, b);
  }
}

template <int kLane>
__device__ __forceinline__ void ascending_shuffle_step(uint32_t (&v)[kKeys]) {
  const bool upper = (threadIdx.x >> kLane) & 1u;
#pragma unroll
  for (int e = 0; e < kKeys; ++e) {
    const uint32_t p = __shfl_xor_sync(kFull, v[e], 1u << kLane);
    v[e] = upper ? max(v[e], p) : min(v[e], p);
  }
}

// Strides 2^J down to 2^Lo, ascending, in the layout whose window starts
// at index bit W (W == 0: the low layout, lanes on bits 4..8; else lanes
// on bits 0..4).
template <int W, int J, int Lo>
__device__ __forceinline__ void ascending_steps(uint32_t (&v)[kKeys]) {
  if constexpr (J >= Lo) {
    if constexpr (J >= W && J < W + kKeysLog) {
      ascending_register_step<J - W>(v);
    } else {
      ascending_shuffle_step<J - (W == 0 ? kKeysLog : 0)>(v);
    }
    ascending_steps<W, J - 1, Lo>(v);
  }
}

// Stage S (< 10) of a tile in the low layout: strides 2^(S-1)..1.  The
// size bit is register bit S (S < 4: a direction per key, known at
// compile time) or a lane or warp bit of li0 (one per thread).
template <int S>
__device__ __forceinline__ void low_stage(uint32_t (&v)[kKeys],
                                          uint32_t li0) {
  uint32_t mask[kKeys];
#pragma unroll
  for (int e = 0; e < kKeys; ++e) {
    const bool desc = S < kKeysLog ? ((e >> S) & 1) : ((li0 >> S) & 1u);
    mask[e] = desc ? kPad : 0u;
    v[e] ^= mask[e];
  }
  ascending_steps<0, S - 1, 0>(v);
#pragma unroll
  for (int e = 0; e < kKeys; ++e) v[e] ^= mask[e];
}

template <int S>
__device__ __forceinline__ void low_stages(uint32_t (&v)[kKeys],
                                           uint32_t li0) {
  if constexpr (S >= 1) {
    low_stages<S - 1>(v, li0);
    low_stage<S>(v, li0);
  }
}

// -- the tile in shared memory ---------------------------------------------

// Shared-memory word of tile index i: bits 2..3 XORed with bits 5..6.
// A warp of a window layout touches 32 consecutive indices (one permuted
// row of banks), and a quarter-warp of the low layout eight 16-byte
// vectors 64 bytes apart (spread over all eight vector slots of a row),
// so neither layout has bank conflicts.
__device__ __forceinline__ uint32_t swizzle(uint32_t i) {
  return i ^ (((i >> 5) & 3u) << 2);
}

__device__ __forceinline__ uint32_t load_key(const void* in, bool in64,
                                             unsigned long long g,
                                             unsigned long long n) {
  if (g >= n) return kPad;
  return in64 ? static_cast<uint32_t>(static_cast<const long long*>(in)[g])
              : static_cast<const uint32_t*>(in)[g];
}

// The block's tile into shared memory, four keys a thread a step: every
// load of a warp is one coalesced 512-byte (1 KB for int64) span, and all
// are in flight before the first compare-exchange.  Keys past n (a sort
// of fewer than 2^15 keys) are 0xFFFFFFFF, which sorts last.
template <bool kIn64>
__device__ __forceinline__ void load_tile(uint32_t* s, const void* in,
                                          unsigned long long base,
                                          unsigned long long n) {
  for (uint32_t q = threadIdx.x; q < kTile / 4; q += blockDim.x) {
    const unsigned long long g = base + 4ULL * q;
    uint4 w;
    if (g + 4 > n) {
      w = make_uint4(load_key(in, kIn64, g, n), load_key(in, kIn64, g + 1, n),
                     load_key(in, kIn64, g + 2, n),
                     load_key(in, kIn64, g + 3, n));
    } else if (kIn64) {
      const longlong2* p = static_cast<const longlong2*>(in) + g / 2;
      const longlong2 a = p[0], b = p[1];
      w = make_uint4(static_cast<uint32_t>(a.x), static_cast<uint32_t>(a.y),
                     static_cast<uint32_t>(b.x), static_cast<uint32_t>(b.y));
    } else {
      w = static_cast<const uint4*>(in)[g / 4];
    }
    *reinterpret_cast<uint4*>(s + swizzle(4 * q)) = w;
  }
  __syncthreads();
}

// The tile back to device memory, as load_tile read it (keys past n are
// not stored).
template <bool kOut64>
__device__ __forceinline__ void store_tile(const uint32_t* s, void* out,
                                           unsigned long long base,
                                           unsigned long long n) {
  for (uint32_t q = threadIdx.x; q < kTile / 4; q += blockDim.x) {
    const unsigned long long g = base + 4ULL * q;
    const uint4 w = *reinterpret_cast<const uint4*>(s + swizzle(4 * q));
    if (g + 4 > n) {
      const uint32_t k[4] = {w.x, w.y, w.z, w.w};
      for (int i = 0; i < 4 && g + i < n; ++i) {
        if (kOut64) {
          static_cast<long long*>(out)[g + i] = k[i];
        } else {
          static_cast<uint32_t*>(out)[g + i] = k[i];
        }
      }
    } else if (kOut64) {
      longlong2* p = static_cast<longlong2*>(out) + g / 2;
      p[0] = make_longlong2(w.x, w.y);
      p[1] = make_longlong2(w.z, w.w);
    } else {
      static_cast<uint4*>(out)[g / 4] = w;
    }
  }
}

// An orbit's 16 keys between shared memory and registers.  wlo == 0 is
// the low layout: 16 consecutive keys, registers on index bits 0..3 and
// the lanes on bits 4..8, read as four 16-byte vectors.
__device__ __forceinline__ void load_orbit(const uint32_t* s, uint32_t li0,
                                           int wlo, uint32_t (&v)[kKeys]) {
  if (wlo == 0) {
#pragma unroll
    for (int q = 0; q < kKeys / 4; ++q) {
      const uint4 w =
          *reinterpret_cast<const uint4*>(s + swizzle(li0 + 4 * q));
      v[4 * q] = w.x;
      v[4 * q + 1] = w.y;
      v[4 * q + 2] = w.z;
      v[4 * q + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kKeys; ++e)
      v[e] = s[swizzle(li0 | (static_cast<uint32_t>(e) << wlo))];
  }
}

__device__ __forceinline__ void store_orbit(uint32_t* s, uint32_t li0,
                                            int wlo,
                                            const uint32_t (&v)[kKeys]) {
  if (wlo == 0) {
#pragma unroll
    for (int q = 0; q < kKeys / 4; ++q)
      *reinterpret_cast<uint4*>(s + swizzle(li0 + 4 * q)) =
          make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int e = 0; e < kKeys; ++e)
      s[swizzle(li0 | (static_cast<uint32_t>(e) << wlo))] = v[e];
  }
}

// -- the kernels ------------------------------------------------------------

// One group of a 2^15-key tile with the strides 2^J..2^Lo in layout W,
// where the direction is one per thread: the tile index's bit `sbit`
// (the stage's size bit, above every lane and window bit of the group),
// or `bdesc` for the whole block when sbit < 0.
template <int W, int J, int Lo>
__device__ __forceinline__ void uniform_group(uint32_t* s, int sbit,
                                              bool bdesc) {
  for (uint32_t o = threadIdx.x; o < kTile / kKeys; o += blockDim.x) {
    const uint32_t li0 = orbit_index(o, W, 0);
    uint32_t v[kKeys];
    load_orbit(s, li0, W, v);
    const uint32_t mask =
        (sbit >= 0 ? ((li0 >> sbit) & 1u) != 0 : bdesc) ? kPad : 0u;
    complement(v, mask);
    ascending_steps<W, J, Lo>(v);
    complement(v, mask);
    store_orbit(s, li0, W, v);
  }
  __syncthreads();
}

// Strides 2^14..1 of a stage in a 2^15-key tile: windows [11..14] and
// [7..10], then the low layout (2^6..2^4 on lanes, 2^3..1 in registers).
__device__ __forceinline__ void tile_strides(uint32_t* s, int sbit,
                                             bool bdesc) {
  uniform_group<11, 14, 11>(s, sbit, bdesc);
  uniform_group<7, 10, 7>(s, sbit, bdesc);
  uniform_group<0, 6, 0>(s, sbit, bdesc);
}

// The first pass: stages 1..15 inside each tile, every group unrolled
// at compile time: stages 1..9 in the low layout, then each later
// stage's windows and low layout.
template <bool kOut64>
__global__ void __launch_bounds__(kMaxThreads)
first_pass_kernel(const long long* in, void* out, unsigned long long n) {
  extern __shared__ uint4 smem[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem);
  const unsigned long long base =
      static_cast<unsigned long long>(blockIdx.x) << kTileLog;
  load_tile<true>(s, in, base, n);
  for (uint32_t o = threadIdx.x; o < kTile / kKeys; o += blockDim.x) {
    const uint32_t li0 = orbit_index(o, 0, 0);
    uint32_t v[kKeys];
    load_orbit(s, li0, 0, v);
    low_stages<kLowStages>(v, li0);
    store_orbit(s, li0, 0, v);
  }
  __syncthreads();
  uniform_group<6, 9, 6>(s, 10, false);
  uniform_group<0, 5, 0>(s, 10, false);
  uniform_group<7, 10, 7>(s, 11, false);
  uniform_group<0, 6, 0>(s, 11, false);
  uniform_group<8, 11, 8>(s, 12, false);
  uniform_group<0, 7, 0>(s, 12, false);
  uniform_group<9, 12, 9>(s, 13, false);
  uniform_group<0, 8, 0>(s, 13, false);
  uniform_group<10, 13, 10>(s, 14, false);
  uniform_group<6, 9, 6>(s, 14, false);
  uniform_group<0, 5, 0>(s, 14, false);
  tile_strides(s, -1, (base >> kTileLog) & 1ULL);
  store_tile<kOut64>(s, out, base, n);
}

// A later local pass: stage `size` > tile, so the tile base alone sets
// the direction of every key of the block.
template <bool kOut64>
__global__ void __launch_bounds__(kMaxThreads)
later_pass_kernel(const uint32_t* in, void* out, unsigned long long n,
                  unsigned long long size) {
  extern __shared__ uint4 smem[];
  uint32_t* s = reinterpret_cast<uint32_t*>(smem);
  const unsigned long long base =
      static_cast<unsigned long long>(blockIdx.x) << kTileLog;
  load_tile<false>(s, in, base, n);
  tile_strides(s, -1, (base & size) != 0);
  store_tile<kOut64>(s, out, base, n);
}

__device__ __forceinline__ void global_steps(uint32_t (&v)[kKeys], int hi,
                                             int lo) {
  const int wlo = hi - kKeysLog + 1;
  for (int j = hi; j >= lo; --j) {
    switch (j - wlo) {
      case 0: ascending_register_step<0>(v); break;
      case 1: ascending_register_step<1>(v); break;
      case 2: ascending_register_step<2>(v); break;
      default: ascending_register_step<3>(v);
    }
  }
}

// Strides 2^hi down to 2^lo (hi - lo < kKeysLog) of stage `size` over
// the whole array; the window is [hi - 3, hi], so the direction bit
// (above hi, and above the block's index bits) is one per block.
__global__ void __launch_bounds__(kGlobalThreads)
global_pass_kernel(uint32_t* __restrict__ x, unsigned long long n,
                   unsigned long long size, int hi, int lo) {
  const unsigned long long o =
      static_cast<unsigned long long>(blockIdx.x) * kGlobalThreads +
      threadIdx.x;
  if (o >= n / kKeys) return;
  const int wlo = hi - kKeysLog + 1;
  const unsigned long long i0 = orbit_index(o, wlo, 0);
  uint32_t v[kKeys];
#pragma unroll
  for (int e = 0; e < kKeys; ++e)
    v[e] = x[i0 | (static_cast<unsigned long long>(e) << wlo)];
  const uint32_t mask = (i0 & size) ? kPad : 0u;
  complement(v, mask);
  global_steps(v, hi, lo);
  complement(v, mask);
#pragma unroll
  for (int e = 0; e < kKeys; ++e)
    x[i0 | (static_cast<unsigned long long>(e) << wlo)] = v[e];
}

// Raise a kernel's dynamic shared-memory limit to the full tile; the
// callers do it once per process and kernel.
template <typename Kernel>
cudaError_t allow_full_tile(Kernel kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTile * static_cast<int>(sizeof(uint32_t)));
}

template <bool kOut64>
cudaError_t launch_first(const void* in, void* out, int64_t n,
                         cudaStream_t stream) {
  static const cudaError_t raised =
      allow_full_tile(first_pass_kernel<kOut64>);
  if (raised != cudaSuccess) return raised;
  // a sort of fewer than 2^15 keys is one padded tile
  const unsigned blocks =
      static_cast<unsigned>(n > kTile ? n >> kTileLog : 1);
  first_pass_kernel<kOut64><<<blocks, kMaxThreads, kTile * sizeof(uint32_t),
                              stream>>>(static_cast<const long long*>(in),
                                        out,
                                        static_cast<unsigned long long>(n));
  return cudaGetLastError();
}

template <bool kOut64>
cudaError_t launch_later(const void* in, void* out, int64_t n,
                         uint64_t size, cudaStream_t stream) {
  static const cudaError_t raised =
      allow_full_tile(later_pass_kernel<kOut64>);
  if (raised != cudaSuccess) return raised;
  later_pass_kernel<kOut64><<<static_cast<unsigned>(n >> kTileLog),
                              kMaxThreads, kTile * sizeof(uint32_t),
                              stream>>>(static_cast<const uint32_t*>(in),
                                        out,
                                        static_cast<unsigned long long>(n),
                                        size);
  return cudaGetLastError();
}

}  // namespace

// C entries for ctypes.  Each launches one kernel on `stream` without
// synchronising and returns cudaGetLastError() (or the error of raising
// the shared-memory limit).
//
// bitonic_local_pass: n keys, a power of two.  size == 0: the first pass
// (n below 2^15, one padded tile: the whole sort; or a multiple of 2^15)
// over the caller's int64 keys.  size > 2^15: a later pass over u32
// keys.  `out` receives int64 (out64) or u32; in == out is allowed.
extern "C" int bitonic_local_pass(const void* in, void* out, int64_t n,
                                  uint64_t size, int out64,
                                  cudaStream_t stream) {
  cudaError_t err;
  if (size != 0) {
    err = out64 ? launch_later<true>(in, out, n, size, stream)
                : launch_later<false>(in, out, n, size, stream);
  } else {
    err = out64 ? launch_first<true>(in, out, n, stream)
                : launch_first<false>(in, out, n, stream);
  }
  return static_cast<int>(err);
}

// bitonic_global_pass: strides 2^log_hi down to 2^log_lo of stage `size`
// over n u32 keys in place; log_hi - log_lo < 4, 2^log_hi >= 2^15.
extern "C" int bitonic_global_pass(uint32_t* x, int64_t n, uint64_t size,
                                   int log_hi, int log_lo,
                                   cudaStream_t stream) {
  const unsigned long long orbits = static_cast<unsigned long long>(n) / kKeys;
  global_pass_kernel<<<static_cast<unsigned>(
                           (orbits + kGlobalThreads - 1) / kGlobalThreads),
                       kGlobalThreads, 0, stream>>>(
      x, static_cast<unsigned long long>(n), size, log_hi, log_lo);
  return static_cast<int>(cudaGetLastError());
}
