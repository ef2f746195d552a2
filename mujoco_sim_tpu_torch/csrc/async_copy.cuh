// Asynchronous global -> shared copies (cp.async, sm_80 and later), shared
// by the kernels that stage an instance's tables before they compute: a
// thread issues every copy it owns without waiting on any, then waits once.
#pragma once
#include <cuda_runtime.h>

namespace asynccopy {

// One float from global memory to shared memory, in flight until wait_all().
__device__ __forceinline__ void copy_f32(float* dst_shared,
                                         const float* src_global) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src_global)
               : "memory");
}

// Four floats at once; both addresses 16-byte aligned.
__device__ __forceinline__ void copy_f32x4(float* dst_shared,
                                           const float* src_global) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src_global)
               : "memory");
}

// Issue the copy of `count` contiguous floats, split over the 32 lanes of a
// warp: 16 bytes a copy where count and both addresses allow it, else 4.
__device__ __forceinline__ void copy_warp(float* dst_shared,
                                          const float* src_global, int count,
                                          int lane) {
  const bool wide =
      count % 4 == 0 &&
      (reinterpret_cast<unsigned long long>(src_global) % 16 == 0) &&
      (__cvta_generic_to_shared(dst_shared) % 16 == 0);
  if (wide) {  // uniform over the warp
    for (int t = 4 * lane; t < count; t += 4 * 32)
      copy_f32x4(dst_shared + t, src_global + t);
  } else {
    for (int t = lane; t < count; t += 32)
      copy_f32(dst_shared + t, src_global + t);
  }
}

// Wait for every copy this thread issued.  Other threads see the data after
// the barrier that follows (__syncwarp / __syncthreads).
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Close the group of the copies issued since the last commit (a double
// buffer commits one group per stage).
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `Pending` of this thread's committed groups are still
// in flight (1: every stage but the newest has landed).
template <int Pending>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

}  // namespace asynccopy
