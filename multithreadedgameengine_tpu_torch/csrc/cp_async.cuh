// The asynchronous global-to-shared copies of the tiled pair passes (K2,
// K3): the only inline PTX of the port's kernels, kept in one place.
//
// cp.async (sm_80 and later) moves a word from device memory straight into
// shared memory without passing through a register, and a thread may have
// many in flight; cp.async.wait_all waits for every copy the thread issued.
// A __syncthreads() after the wait makes every thread's copies visible to
// the whole block.

#pragma once

#include <cuda_runtime.h>

namespace pair_tile {

// Copy 4 bytes from device memory to shared memory, asynchronously.
__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

// Wait for every cp.async this thread issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace pair_tile
