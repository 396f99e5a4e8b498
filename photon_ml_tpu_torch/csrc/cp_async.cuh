// The cp.async ring helpers of the staged bodies (kernels 1, 3 and 4):
// 16- and 4-byte copies from device to shared memory, the group commit,
// the wait that keeps a ring of 2-4 stages in flight, and the shared
// memory of a block such that two fit an SM.
// ops/fused_glm.py::TWO_BLOCK_SMEM_BYTES mirrors kTwoBlockSmemBytes.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace photon {

// shared memory of a block such that two fit an SM (228 KiB an SM, 1 KiB
// of it reserved per block)
constexpr size_t kTwoBlockSmemBytes = 233472 / 2 - 1024;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most stages - 2 groups are pending (stages in 2..4)
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages >= 4)
    asm volatile("cp.async.wait_group 2;\n" ::);
  else if (stages == 3)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 0;\n" ::);
}

}  // namespace photon
