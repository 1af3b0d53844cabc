// Helpers shared by the port's CUDA kernels for Hopper (sm_90a): f32
// conversions, 16-byte cp.async copies from global to shared memory (one
// chunk, or whole tiles of rows), mbarriers and the bulk copies of the TMA
// engine that complete them, and the opt-in to more than 48 KB of dynamic
// shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as torch's cast
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; reads nothing and writes zeros when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies tiles of kTileRows rows of kRowBytes each (a multiple of 16) from
// global to shared memory in 16-byte cp.async copies.  Thread i copies the
// same chunks of every tile -- chunk i % kChunks of rows i / kChunks + j *
// kStep -- so its addresses are fixed but for the tile's offset.  Rows at
// or past `end` are zero-filled (a source size of 0).
template <int kThreads, int kTileRows, int kRowBytes>
struct TileCopy {
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr int kStep = kThreads / kChunks;
  static_assert(kThreads % kChunks == 0 && kTileRows % kStep == 0,
                "whole chunks a thread");
  int r0, c0;
  __device__ TileCopy()
      : r0(threadIdx.x / kChunks), c0(threadIdx.x % kChunks) {}
  // rows first .. first + kTileRows - 1 of a matrix whose row 0 is at src,
  // rows `stride` bytes apart, into shared rows `dst_stride` bytes apart
  __device__ __forceinline__ void operator()(char* dst, int dst_stride,
                                             const char* src, size_t stride,
                                             int first, int end) const {
    const char* from = src + (first + r0) * stride + c0 * 16;
    char* to = dst + r0 * dst_stride + c0 * 16;
#pragma unroll
    for (int j = 0; j < kTileRows / kStep; ++j) {
      const bool full = first + r0 + j * kStep < end;
      cp_async16(to + j * kStep * dst_stride,
                 full ? from + j * kStep * stride : src, full);
    }
  }
};

// An mbarrier whose phase completes after `count` arrivals (and the bytes
// of copy they announce).  One thread initialises the block's barriers and
// then calls fence_barrier_init(); a block barrier precedes any use.
__device__ __forceinline__ void barrier_init(uint64_t* bar, int count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival on the barrier that also announces `bytes` of copies (TMA)
// which must complete before its phase does.
__device__ __forceinline__ void barrier_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One arrival on the barrier.
__device__ __forceinline__ void barrier_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One bulk copy (the TMA engine) of `bytes` contiguous bytes, a multiple of
// 16 at 16-byte aligned addresses, which completes the barrier's phase.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  barrier_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void barrier_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Raise a kernel's dynamic shared memory limit when a block needs more
// than the default 48 KB; returns a cudaError_t as int.
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}
