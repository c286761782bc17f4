// bf16 staging through shared memory, and the rgb16 write-back
// skeleton, on Hopper's bulk-copy engine (sm_90a).
//
// Replaces bench/bf16probe.py's Pallas kernels:
//   bf16_roundtrip_kernel<kMulti>     _kernel_multi      (run, :94)
//   bf16_roundtrip_kernel<kPerPlane>  _kernel_per_plane  (run, :94)
//   bf16_roundtrip_kernel<kF32>       _kernel_f32        (run, :94)
//   rgb16_skeleton_kernel             _kernel_skeleton   (run_skeleton,
//                                                         :202)
// probes/bf16probe.py holds their plain versions and the contracts.
//
// The TPU kernels stage through VMEM with pltpu.make_async_copy and a
// DMA semaphore.  Their counterpart here is the bulk-copy (TMA) engine:
// one thread issues cp.async.bulk loads into shared memory, completed
// on an mbarrier that the block waits on, and cp.async.bulk stores back
// after a proxy fence.  Every copy is one contiguous run of a plane
// (the rows of a tile, 128 elements a row), so no tensor map is needed.
//
// What bounds them on the card: device-memory bytes.  The roundtrip
// reads and writes its (3, rows, 128) array once; the skeleton reads
// and writes density (f32) and rgb (bf16) once where it visits a block,
// and `add` (512 KB) stays in L2.
//
// What the design does about it.  The TPU walks its grid in order with
// one VMEM buffer; the card runs independent blocks at once:
//   - bf16_roundtrip_kernel: persistent blocks, one a SM (the wrapper
//     sizes the grid from the SM count), each walking the tiles of
//     kRoundRows rows of all 3 planes blockIdx.x, + gridDim.x, ...
//     through a ring of kRoundStages tiles in shared memory (96 KB of
//     bf16, 192 KB for the f32 control): the
//     bulk loads of the next kRoundAhead tiles are in flight while a
//     tile converts and stores, and a stage is loaded again only once
//     the stores of its last tile have read it (wait_group.read).  A
//     block once a tile, as before, loaded, waited, stored and exited
//     with nothing overlapped inside it, and lost its waves' tails.
//     kMulti waits once a tile for its three plane copies, the
//     counterpart of one DMA and one semaphore wait; kPerPlane waits a
//     plane at a time, each plane on an mbarrier of its own (one phase a
//     plane a tile); kF32 converts nothing.  The bf16 variants turn every
//     element bf16 -> f32 -> bf16 (round to nearest even) in registers,
//     back into the stage, which is stored plane by plane.  A ragged
//     last tile copies fewer rows.
//   - rgb16_skeleton_kernel: the grid is (rows / kBlockRows blocks) x
//     (kBlockRows / kSkelRows tiles).  Block (rb, t) counts the visits
//     of its rb in the schedule with __syncthreads_count, a strided
//     share of the schedule a thread.  The host has checked that each
//     block's visits form one contiguous run, so the run's first visit
//     loads the tile (density f32, the three rgb planes bf16 and the
//     tile's rows of `add`) on one mbarrier, every visit adds `add` to
//     a float32 accumulator of 4 planes held in registers (32 floats a
//     thread), one add a visit, in order, and the last visit rounds rgb
//     to bf16 once and stores density and rgb in place.  No atomics:
//     one block writes a row.  Built without --use_fast_math, so the
//     adds are not reassociated and the result equals the plain
//     version's bit for bit.
//
// Every global address and size of a bulk copy is a multiple of 16
// bytes: the tile offsets are, and probes/bf16probe.py refuses base
// pointers that are not.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPlanes = 3;            // rgb
constexpr int kAccPlanes = 4;         // rgb + density
constexpr int kLanes = 128;           // elements a row
constexpr int kThreads = 256;
constexpr int kRoundRows = 32;        // rows of a roundtrip tile
// roundtrip tiles in shared memory a block, and of them the loads kept
// in flight ahead of the tile being converted (the rest: the one whose
// stores drain).  96 KB a block in bf16, 192 KB in f32.  Other shapes
// timed on the card in turns (tiles of 8-64 rows, 3-8 stages, 1-4
// blocks a SM, L2 evict-first hints) were no faster.
constexpr int kRoundStages = 4;
constexpr int kRoundAhead = 2;
static_assert(kRoundAhead >= 1 && kRoundAhead + 2 <= kRoundStages,
              "a stage converting, one draining, the rest loading");
constexpr int kBlockRows = 256;       // probes/bf16probe.py BR
constexpr int kSkelRows = 16;         // rows of a skeleton tile
constexpr int kTileElems = kSkelRows * kLanes;
// float4 groups of one skeleton plane tile a thread
constexpr int kGroups = kTileElems / 4 / kThreads;
static_assert(kGroups * 4 * kThreads == kTileElems, "whole groups");

enum Variant { kMulti = 0, kPerPlane = 1, kF32 = 2 };

// ---- bulk-copy primitives: cp.async.bulk, mbarrier, proxy fence -------
// (kept here until a second kernel needs them; a new csrc/*.cuh would
// rename every library, see kernels/build.py)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: an mbarrier expecting one arrival, made visible to the
// other threads (after a __syncthreads) and to the async proxy.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The one arrival of the current phase, which then completes once
// `bytes` have landed.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` from global `src` into this block's shared `dst`, counted on
// the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Every thread that wrote shared memory, before the barrier that
// precedes a bulk store of it: orders the generic proxy's writes before
// the async proxy's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// The stores have read shared memory (it may be reused or freed).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// The stores are complete in global memory.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---- end of the bulk-copy primitives -----------------------------------

template <int kVariant>
using Elem = typename std::conditional<kVariant == kF32, float,
                                       __nv_bfloat16>::type;

// shared memory of a roundtrip block: kRoundStages tiles of 3 planes
template <int kVariant>
constexpr int stage_bytes() {
  return kRoundStages * kPlanes * kRoundRows * kLanes *
         sizeof(Elem<kVariant>);
}

// bf16 -> f32 -> bf16 of 8 bf16 values in place.
__device__ __forceinline__ void round_trip8(uint4* p) {
  uint4 v = *p;
  auto* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    h[k] = __floats2bfloat162_rn(f.x, f.y);
  }
  *p = v;
}

// One thread: the stores it committed before the newest kPending
// groups have read shared memory (their stages may be reused).
template <int kPending>
__device__ __forceinline__ void bulk_wait_read_but() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kPending)
               : "memory");
}

// A persistent block walks the tiles blockIdx.x, + gridDim.x, ... with
// kRoundStages tiles in shared memory: the loads of its next
// kRoundAhead tiles are in flight while it converts and stores one, and
// the stores of the one before drain.  At the start of step i thread 0
// waits until the stores of tile i - 2 have read their stage (all but
// the newest group, tile i - 1's), then loads tile i + 2 into it.
// kMulti and kF32 count a tile's three plane copies on one mbarrier a
// stage; kPerPlane gives each plane its own (one phase a plane a use).
template <int kVariant>
__global__ void __launch_bounds__(kThreads)
    bf16_roundtrip_kernel(const Elem<kVariant>* __restrict__ x,
                          Elem<kVariant>* __restrict__ out, int64_t rows,
                          int n_tiles) {
  extern __shared__ __align__(128) unsigned char stage[];
  constexpr int kBars = kVariant == kPerPlane ? kPlanes : 1;
  __shared__ __align__(8) uint64_t bars[kRoundStages][kBars];
  using T = Elem<kVariant>;
  constexpr uint32_t kStagePlane = kRoundRows * kLanes * sizeof(T);
  constexpr uint32_t kStageBytes = kPlanes * kStagePlane;
  const int mine = n_tiles > static_cast<int>(blockIdx.x)
                       ? (n_tiles - 1 - blockIdx.x) / gridDim.x + 1
                       : 0;
  const uint32_t s0 = smem_u32(stage);
  // rows and plane bytes of the block's i-th tile
  const auto tile_rows = [&](int i, int64_t& r0) {
    r0 = (int64_t(blockIdx.x) + int64_t(i) * gridDim.x) * kRoundRows;
    const int64_t left = rows - r0;
    return left < kRoundRows ? static_cast<int>(left) : kRoundRows;
  };
  // thread 0: the i-th tile's plane copies into stage i % kRoundStages
  const auto load = [&](int i) {
    int64_t r0;
    const uint32_t plane_bytes = tile_rows(i, r0) * kLanes * sizeof(T);
    const int st = i % kRoundStages;
    if (kBars == 1)
      mbar_expect_tx(smem_u32(&bars[st][0]), kPlanes * plane_bytes);
    for (int c = 0; c < kPlanes; ++c) {
      const uint32_t bar = smem_u32(&bars[st][kBars == 1 ? 0 : c]);
      if (kBars != 1) mbar_expect_tx(bar, plane_bytes);
      bulk_load(s0 + st * kStageBytes + c * kStagePlane,
                x + (int64_t(c) * rows + r0) * kLanes, plane_bytes, bar);
    }
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < kRoundStages; ++st)
      for (int b = 0; b < kBars; ++b) mbar_init(smem_u32(&bars[st][b]));
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < kRoundAhead && i < mine; ++i) load(i);

  for (int i = 0; i < mine; ++i) {
    const int st = i % kRoundStages;
    const uint32_t parity = (i / kRoundStages) & 1;
    if (threadIdx.x == 0 && i + kRoundAhead < mine) {
      bulk_wait_read_but<kRoundStages - kRoundAhead - 1>();
      load(i + kRoundAhead);
    }
    int64_t r0;
    const int n = tile_rows(i, r0);
    const uint32_t plane_bytes = n * kLanes * sizeof(T);
    unsigned char* tile = stage + st * kStageBytes;
    for (int c = 0; c < kPlanes; ++c) {
      if (kBars != 1 || c == 0)
        mbar_wait(smem_u32(&bars[st][kBars == 1 ? 0 : c]), parity);
      if constexpr (kVariant != kF32) {
        auto* p = reinterpret_cast<uint4*>(tile + c * kStagePlane);
        const int vecs = n * kLanes / 8;    // 8 bf16 (16 bytes) a vector
        for (int v = threadIdx.x; v < vecs; v += kThreads)
          round_trip8(p + v);
      }
    }
    fence_async_shared();
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int c = 0; c < kPlanes; ++c)
        bulk_store(out + (int64_t(c) * rows + r0) * kLanes,
                   s0 + st * kStageBytes + c * kStagePlane, plane_bytes);
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait_read();   // the stages live until read
}

// shared memory of a skeleton block: add (4 planes), density, rgb (3)
constexpr int kSkelAddBytes = kAccPlanes * kTileElems * 4;
constexpr int kSkelDensBytes = kTileElems * 4;
constexpr int kSkelRgbBytes = kPlanes * kTileElems * 2;
constexpr int kSkelBytes = kSkelAddBytes + kSkelDensBytes + kSkelRgbBytes;

__global__ void __launch_bounds__(kThreads)
    rgb16_skeleton_kernel(float* __restrict__ dens,
                          __nv_bfloat16* __restrict__ rgb,
                          const float* __restrict__ add,
                          const int32_t* __restrict__ sched, int n_steps,
                          int64_t rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const int rb = blockIdx.x;
  const int t = blockIdx.y;

  // the visits of block rb: one contiguous run of the schedule
  int visits = 0;
  for (int g0 = 0; g0 < n_steps; g0 += kThreads) {
    const int g = g0 + threadIdx.x;
    visits += __syncthreads_count(g < n_steps && sched[g] == rb);
  }
  if (visits == 0) return;            // the same for every thread

  auto* s_add = reinterpret_cast<float*>(smem);
  auto* s_dens = reinterpret_cast<float*>(smem + kSkelAddBytes);
  auto* s_rgb = reinterpret_cast<__nv_bfloat16*>(smem + kSkelAddBytes +
                                                 kSkelDensBytes);
  const uint32_t b = smem_u32(&bar);
  const int64_t row0 = int64_t(rb) * kBlockRows + int64_t(t) * kSkelRows;
  float* g_dens = dens + row0 * kLanes;
  const auto g_rgb = [&](int c) {
    return rgb + (int64_t(c) * rows + row0) * kLanes;
  };

  // first visit: the tile of density, rgb and add on one mbarrier
  if (threadIdx.x == 0) mbar_init(b);
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(b, kSkelBytes);
    for (int p = 0; p < kAccPlanes; ++p)
      bulk_load(smem_u32(s_add + p * kTileElems),
                add + (int64_t(p) * kBlockRows + t * kSkelRows) * kLanes,
                kTileElems * 4, b);
    bulk_load(smem_u32(s_dens), g_dens, kSkelDensBytes, b);
    for (int c = 0; c < kPlanes; ++c)
      bulk_load(smem_u32(s_rgb + c * kTileElems), g_rgb(c), kTileElems * 2,
                b);
  }
  mbar_wait(b, 0);

  // the accumulator, planes r, g, b, density: kGroups float4 a plane
  float4 acc[kAccPlanes][kGroups], inc[kAccPlanes][kGroups];
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int q = threadIdx.x + k * kThreads;
#pragma unroll
    for (int p = 0; p < kAccPlanes; ++p)
      inc[p][k] = reinterpret_cast<const float4*>(s_add + p * kTileElems)[q];
    acc[kPlanes][k] = reinterpret_cast<const float4*>(s_dens)[q];
#pragma unroll
    for (int c = 0; c < kPlanes; ++c) {
      const uint2 v =
          reinterpret_cast<const uint2*>(s_rgb + c * kTileElems)[q];
      const float2 lo =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
      const float2 hi =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
      acc[c][k] = make_float4(lo.x, lo.y, hi.x, hi.y);
    }
  }
  // every visit: one float32 add of `add`, in order
  for (int v = 0; v < visits; ++v) {
#pragma unroll
    for (int p = 0; p < kAccPlanes; ++p) {
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        acc[p][k].x = acc[p][k].x + inc[p][k].x;
        acc[p][k].y = acc[p][k].y + inc[p][k].y;
        acc[p][k].z = acc[p][k].z + inc[p][k].z;
        acc[p][k].w = acc[p][k].w + inc[p][k].w;
      }
    }
  }
  // last visit: rgb rounded to bf16 once, density as it is, in place
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int q = threadIdx.x + k * kThreads;
    reinterpret_cast<float4*>(s_dens)[q] = acc[kPlanes][k];
#pragma unroll
    for (int c = 0; c < kPlanes; ++c) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[c][k].x,
                                                      acc[c][k].y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[c][k].z,
                                                      acc[c][k].w);
      uint2 v;
      v.x = *reinterpret_cast<const uint32_t*>(&lo);
      v.y = *reinterpret_cast<const uint32_t*>(&hi);
      reinterpret_cast<uint2*>(s_rgb + c * kTileElems)[q] = v;
    }
  }
  fence_async_shared();
  __syncthreads();
  if (threadIdx.x == 0) {
    bulk_store(g_dens, smem_u32(s_dens), kSkelDensBytes);
    for (int c = 0; c < kPlanes; ++c)
      bulk_store(g_rgb(c), smem_u32(s_rgb + c * kTileElems),
                 kTileElems * 2);
    bulk_commit();
    bulk_wait();              // written, not only read, before the exit
  }
}

// Dynamic shared memory above 48 KB for `kernel`, asked once a process.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) cudaGetLastError();    // not sticky
  return err;
}

template <int kVariant>
int launch_roundtrip(const void* x, void* out, int64_t rows, int grid,
                     cudaStream_t stream) {
  constexpr int kBytes = stage_bytes<kVariant>();
  static const cudaError_t attr =
      allow_smem(bf16_roundtrip_kernel<kVariant>, kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int64_t n_tiles = (rows + kRoundRows - 1) / kRoundRows;
  if (n_tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  bf16_roundtrip_kernel<kVariant><<<grid, kThreads, kBytes, stream>>>(
      static_cast<const Elem<kVariant>*>(x), static_cast<Elem<kVariant>*>(out),
      rows, static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One bf16_roundtrip_kernel launch of `grid` persistent blocks: out = x
// through the shared-memory stages, x and out contiguous (3, rows, 128),
// bf16 for variants 0 (multi) and 1 (per_plane), float32 for 2 (f32).
extern "C" int bf16_roundtrip(const void* x, void* out, int64_t rows,
                              int variant, int grid, cudaStream_t stream) {
  if (rows <= 0 || grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case kMulti:
      return launch_roundtrip<kMulti>(x, out, rows, grid, stream);
    case kPerPlane:
      return launch_roundtrip<kPerPlane>(x, out, rows, grid, stream);
    case kF32:
      return launch_roundtrip<kF32>(x, out, rows, grid, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One rgb16_skeleton_kernel launch: dens (1, rows, 128) f32 and rgb (3,
// rows, 128) bf16 updated in place by the schedule `sched` (n_steps
// int32 block indices, each block's visits one contiguous run), `add`
// (4, 256, 128) f32 added once a visit.
extern "C" int rgb16_skeleton(float* dens, void* rgb, const float* add,
                              const int32_t* sched, int64_t n_steps,
                              int64_t rows, cudaStream_t stream) {
  if (rows <= 0 || rows % kBlockRows || n_steps < 0 || n_steps > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = allow_smem(rgb16_skeleton_kernel,
                                             kSkelBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(rows / kBlockRows),
                  kBlockRows / kSkelRows);
  rgb16_skeleton_kernel<<<grid, kThreads, kSkelBytes, stream>>>(
      dens, static_cast<__nv_bfloat16*>(rgb), add, sched,
      static_cast<int>(n_steps), rows);
  return static_cast<int>(cudaGetLastError());
}
