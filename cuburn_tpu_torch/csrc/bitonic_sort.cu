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
// the schedule:
//   bitonic_local_pass     one block per TILE of keys, loaded into shared
//                          memory; either every stage 1..log2(TILE)
//                          (size == 0), or, for a later stage `size`,
//                          its substages of stride TILE/2 down to 1.
//   bitonic_global_substage one compare-exchange substage of stride
//                          >= TILE over the whole array, one thread per
//                          pair, in device memory.
//
// What bounds it on the card: device-memory passes.  Each global
// substage and each local pass reads and writes the whole array once
// (2^22 keys: 16 MB, about 10 microseconds a pass at 3.35 TB/s), so the
// count of passes sets the time; the compare-exchanges inside a tile run
// from shared memory.
//
// What the design does about it: TILE = 2^15 keys (128 KB of shared
// memory, above the 48 KB default, so the entry raises the kernel's
// dynamic shared-memory limit first) fuses the 120 substages of stages
// 1..15 into one pass and the last 15 substages of every later stage
// into one pass.  The TPU kernel's 2^16-key tile (256 KB of VMEM) does
// not fit the 227 KB a block may use.  Keys are u32, half the bytes of
// the port's int64 records.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileLog = 15;  // ops/tiled_sort.py TILE_LOG
constexpr int kTile = 1 << kTileLog;
constexpr int kThreads = 1024;

__device__ __forceinline__ void compare_exchange(uint32_t& a, uint32_t& b,
                                                 bool ascending) {
  if ((a > b) == ascending) {
    const uint32_t t = a;
    a = b;
    b = t;
  }
}

// One substage over the tile in shared memory: pair p holds elements i
// and i + k, i with its k-bit clear.
__device__ __forceinline__ void tile_substage(uint32_t* s,
                                              unsigned long long base,
                                              unsigned long long size,
                                              int log_k) {
  const int k = 1 << log_k;
  for (int p = threadIdx.x; p < kTile / 2; p += kThreads) {
    const int i = ((p >> log_k) << (log_k + 1)) | (p & (k - 1));
    compare_exchange(s[i], s[i + k], ((base + i) & size) == 0);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
local_pass_kernel(uint32_t* __restrict__ x, unsigned long long size) {
  extern __shared__ uint32_t s[];
  const unsigned long long base =
      static_cast<unsigned long long>(blockIdx.x) * kTile;
  for (int t = threadIdx.x; t < kTile; t += kThreads) s[t] = x[base + t];
  __syncthreads();
  if (size == 0) {
    for (int stage = 1; stage <= kTileLog; ++stage) {
      for (int sub = stage - 1; sub >= 0; --sub) {
        tile_substage(s, base, 1ULL << stage, sub);
      }
    }
  } else {
    for (int sub = kTileLog - 1; sub >= 0; --sub) {
      tile_substage(s, base, size, sub);
    }
  }
  for (int t = threadIdx.x; t < kTile; t += kThreads) x[base + t] = s[t];
}

__global__ void __launch_bounds__(256)
global_substage_kernel(uint32_t* __restrict__ x, unsigned long long half,
                       unsigned long long size, int log_k) {
  const unsigned long long p =
      static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
      threadIdx.x;
  if (p >= half) return;
  const unsigned long long k = 1ULL << log_k;
  const unsigned long long i = ((p >> log_k) << (log_k + 1)) | (p & (k - 1));
  uint32_t a = x[i];
  uint32_t b = x[i + k];
  compare_exchange(a, b, (i & size) == 0);
  x[i] = a;
  x[i + k] = b;
}

}  // namespace

// C entries for ctypes.  x: n u32 keys in device memory, sorted in
// place; n a power of two and a multiple of kTile.  Each launches on
// `stream` without synchronising and returns cudaGetLastError() (or the
// error of raising the shared-memory limit).
extern "C" int bitonic_local_pass(uint32_t* x, int64_t n, uint64_t size,
                                  cudaStream_t stream) {
  const int smem = kTile * static_cast<int>(sizeof(uint32_t));
  const cudaError_t err = cudaFuncSetAttribute(
      local_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  local_pass_kernel<<<static_cast<unsigned>(n / kTile), kThreads, smem,
                      stream>>>(x, size);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bitonic_global_substage(uint32_t* x, int64_t n,
                                       uint64_t size, int log_k,
                                       cudaStream_t stream) {
  const unsigned long long half = static_cast<unsigned long long>(n) / 2;
  global_substage_kernel<<<static_cast<unsigned>((half + 255) / 256), 256,
                           0, stream>>>(x, half, size, log_k);
  return static_cast<int>(cudaGetLastError());
}
