// Double-buffered tile staging for the persistent, sum-factorised DG
// kernels (ldg_chain.cu's K1-K3, volume_vm.cu), on Hopper (sm_90a).
//
// A block walks tiles of TE consecutive elements.  Every per-element
// input is contiguous over a tile, so one thread stages a tile with one
// TMA bulk copy per input (cp.async.bulk, global -> shared), all
// completing on the stage's mbarrier; while the block computes on one
// stage, the next tile's copies land in the other.  A bulk copy moves a
// multiple of 16 bytes from and to 16-byte aligned addresses: with TE
// times an element's floats a multiple of 4 every full tile's run is such
// a multiple (TE = 4 at any order; at p4 chunks of 400, 500, 1200, 1600,
// 2000, 3000 or 6000 bytes an element; at p5, Np = 216, every chunk is a multiple of
// 16 bytes and TE = 2 also does), and the last, partial tile copies the
// run's 16-byte floor and its threads load the <= 3 floats left over
// (fill_tail).  Rows that sit at a stride whose start is only 8-byte
// aligned (nu's first lane, 8 Np bytes apart: at odd Np) take one copy
// per element from the 16-byte boundary below the row, into a slot of
// their own; the reader adds the row's shift (row_shift).  An output tile
// staged in shared memory can leave the same way, as one bulk copy to
// global memory (bulk_store), which runs while the block goes on.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tile {

// One input staged per tile: `floats` per element from `src` (element e
// at src + e * floats) to `off` floats into the stage.
struct Segment {
  const float* src;
  int floats;
  int off;
};

// One row per element at a stride (element e's row at src + e * stride),
// into slots of `slot` floats from `off`; slot * 4 >= the row's bytes +
// 12, rounded up to 16.
struct Rows {
  const float* src;
  int stride;
  int floats;
  int off;
  int slot;
};

// The node stride of each direction's lines (dg/line_ops.py), read
// without indexing the kernel's parameters at a run-time position.
struct Strides {
  int s[3];
  __host__ __device__ __forceinline__ int at(int a) const {
    return a == 0 ? s[0] : a == 1 ? s[1] : s[2];
  }
};

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem(bar)) : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this thread's generic-proxy accesses to shared memory before
// later bulk copies into it (run by every thread before the barrier that
// hands a stage back to the copy engine).
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Waits for the phase of `bar` with this parity to complete.  A copy that
// never lands is a fault of the kernel: after ~2^24 tries (seconds) the
// block traps, and the launch fails instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem(dst)), "l"(src), "r"(bytes), "r"(smem(bar)) : "memory");
}

// One thread: a bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from shared to global memory, committed as its own group.
// The writers of `src` run fence_async_proxy() and a barrier before it.
__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n"
      :: "l"(dst), "r"(smem(src)), "r"(bytes) : "memory");
}

// Run by the thread that issued the bulk stores: waits until they have
// read their shared memory (which may then be written again), or (at the
// block's end) until they are done.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t floor16(uint32_t bytes) {
  return bytes & ~15u;
}

__device__ __forceinline__ int row_shift(const Rows& r, int e) {
  return (int)((reinterpret_cast<uintptr_t>(r.src + (size_t)e * r.stride)
                & 15u) / 4);
}

// Issued by one thread: the copies of elements [e0, e0 + ne) into `stage`,
// completing on `bar`.
template <int NSEG>
__device__ __forceinline__ void issue(float* stage, uint64_t* bar,
                                      const Segment (&seg)[NSEG],
                                      const Rows* rows, int e0, int ne) {
  uint32_t total = 0;
#pragma unroll
  for (int i = 0; i < NSEG; ++i) total += floor16(4u * ne * seg[i].floats);
  if (rows) total += 4u * ne * rows->slot;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem(bar)), "r"(total) : "memory");
#pragma unroll
  for (int i = 0; i < NSEG; ++i) {
    const uint32_t bytes = floor16(4u * ne * seg[i].floats);
    if (bytes)
      bulk_load(stage + seg[i].off, seg[i].src + (size_t)e0 * seg[i].floats,
                bytes, bar);
  }
  if (rows)
    for (int te = 0; te < ne; ++te) {
      const int e = e0 + te;
      bulk_load(stage + rows->off + te * rows->slot,
                rows->src + (size_t)e * rows->stride - row_shift(*rows, e),
                4u * rows->slot, bar);
    }
}

// Run by every thread after the stage's wait: the floats of each run past
// its 16-byte floor (none on a full tile).
template <int NSEG>
__device__ __forceinline__ void fill_tail(float* stage,
                                          const Segment (&seg)[NSEG],
                                          int e0, int ne) {
#pragma unroll
  for (int i = 0; i < NSEG; ++i) {
    const int n = ne * seg[i].floats;
    for (int j = (int)floor16(4u * n) / 4 + threadIdx.x; j < n;
         j += blockDim.x)
      stage[seg[i].off + j] = __ldg(seg[i].src + (size_t)e0 * seg[i].floats
                                    + j);
  }
}

// The line orders the sum-factorised kernels are built for: Nq = 2..6
// nodes a line (p1-p5; every Np <= 256 that the one-thread-per-node
// kernels before them covered).  Calls f(std::integral_constant<int, Nq>)
// for the Nq with Nq^3 == Np and returns its result; any other Np gives
// cudaErrorInvalidValue.
template <typename F>
int by_order(int Np, F&& f) {
  switch (Np) {
    case 8: return f(std::integral_constant<int, 2>());
    case 27: return f(std::integral_constant<int, 3>());
    case 64: return f(std::integral_constant<int, 4>());
    case 125: return f(std::integral_constant<int, 5>());
    case 216: return f(std::integral_constant<int, 6>());
  }
  return (int)cudaErrorInvalidValue;
}

// The persistent grid of `kernel` on the current device: the blocks of it
// that fit on all SMs at once with `smem` dynamic shared memory, at most
// `tiles`.  Raises the kernel's dynamic shared memory limit and queries
// the occupancy once per device and size (cache: [16] entries).
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem_bytes,
                            int tiles, int2* cache, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 16) return cudaErrorInvalidDevice;
  int2& c = cache[dev];
  if (c.x != (int)smem_bytes || c.y == 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem_bytes);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
    c = make_int2((int)smem_bytes, per_sm * sms);
  }
  *grid = c.y < tiles ? c.y : tiles;
  return cudaSuccess;
}

}  // namespace tile
