// The asynchronous global-to-shared copies of the tiled pair passes (K1,
// K2, K3) and the neighbour build: the only inline PTX of the port's
// kernels, kept in one place.
//
// cp.async (sm_80 and later) moves a word from device memory straight into
// shared memory without passing through a register, and a thread may have
// many in flight; cp.async.wait_all waits for every copy the thread issued.
// A __syncthreads() (or, within one warp, __syncwarp()) after the wait makes
// every thread's copies visible to the others. The neighbour build commits
// its copies in groups and waits for all but the newest group, so one
// group is in flight while the previous one is read.

#pragma once

#include <cuda_runtime.h>

namespace pair_tile {

// Copy 4 bytes from device memory to shared memory, asynchronously.
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

// Copy 16 bytes (both addresses 16-byte aligned), asynchronously, through
// L2 alone (.cg: the copy does not fill L1).
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

// Close the group of the cp.async this thread started since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are still
// in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Wait for every cp.async this thread issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace pair_tile
