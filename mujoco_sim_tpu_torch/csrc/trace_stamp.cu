// A stage stamp of the recorder (runtime/profiler.py): one thread writes
// the card's %globaltimer (ns) into its slot of the step's row of a ring
// of (rows x slots) int64 on the card, and adds one to its own launch
// count in the recorder's table.
//
// Replaces no TPU kernel: the JAX package has no stage timeline inside its
// jitted step.  Added because a CUDA graph's replay hides which stage ran
// when (the profiler records no kernel inside a conditional WHILE body),
// and a host clock sees only the launch.  The row is the table's step
// count, read on the card at each launch, so every replay of a captured
// step writes a row of its own, the way StepGraph's trajectory row does.
//
// Bound: 16 bytes read and 16 written, so the kernel costs its launch (a
// device-side launch of one thread inside a graph, ~1-2 us); the design
// keeps it to one thread and no synchronisation, and puts the count in
// the same thread instead of a second kernel.
//
// The plain C interface is bound with ctypes (ops/trace_stamp.py); the
// entry returns the launch's cudaError_t.

#include <cuda_runtime.h>

namespace {

__global__ void trace_stamp_kernel(long long* __restrict__ ring,
                                   long long* __restrict__ table, int rows,
                                   int slots, int slot, int step_slot,
                                   int count_slot) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long row = table[step_slot] % rows;
  ring[row * slots + slot] = (long long)now;
  table[count_slot] += 1;
}

}  // namespace

extern "C" {

int trace_stamp(void* ring, void* table, int rows, int slots, int slot,
                int step_slot, int count_slot, void* stream) {
  trace_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (long long*)ring, (long long*)table, rows, slots, slot, step_slot,
      count_slot);
  return cudaGetLastError();
}

}  // extern "C"
