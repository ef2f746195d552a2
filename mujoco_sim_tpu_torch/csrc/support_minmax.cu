// Support extents of a vertex cloud along many axes on Hopper (sm_90a):
// mn[i, c] = min_v axes[i, c] . w[i, v],  mx[i, c] = max_v of the same.
//
// Replaces the Pallas TPU kernel mujoco_sim_tpu/ops/pallas_support.py
// `_make_kernel` (public `support_minmax`).  Same function, natural (N, C, 3)
// / (N, V, 3) layouts: the TPU kernel's lane-major transposes, its padding
// of the instance axis to 128 lanes and its chunking for scoped VMEM are not
// carried over.
//
// What bounds it on this card: bytes.  Per instance it reads 12 (C + V)
// bytes and writes 8 C, against 6 C V flops; at C = 256, V = 24 that is
// 5.4 KB and 37 kFLOP, 6.8 flop/byte, below the card's ~20 flop/byte f32
// balance.  What the design does about it: the (C, V) product never leaves
// registers (the plain version writes it to device memory and reads it back
// twice), the instance's vertices are staged once in shared memory and read
// from there as broadcasts by every lane, and each lane owns one axis, so
// the axis loads and the two result stores are coalesced across the warp.
//
// Built with -fmad=false (see support.cuh); loaded with ctypes by
// ops/support_minmax.py.
#include "support.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void support_minmax_kernel(const float* __restrict__ axes,
                                      const float* __restrict__ w,
                                      float* __restrict__ mn,
                                      float* __restrict__ mx, int C, int V) {
  extern __shared__ float sw[];  // V * 3
  const long long inst = blockIdx.x;
  const float* wi = w + inst * V * 3;
  for (int t = threadIdx.x; t < V * 3; t += blockDim.x) sw[t] = wi[t];
  __syncthreads();
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float* a = axes + (inst * C + c) * 3;
  float lo, hi;
  hullk::support_scan(sw, V, a[0], a[1], a[2], lo, hi);
  mn[inst * C + c] = lo;
  mx[inst * C + c] = hi;
}

}  // namespace

// axes (N, C, 3), w (N, V, 3) -> mn, mx (N, C): contiguous float32 on the
// device.  Returns the cudaError_t of the launch (0 = cudaSuccess); 1 for
// sizes the kernel does not take.
extern "C" int support_minmax_f32(const float* axes, const float* w, float* mn,
                                  float* mx, int N, int C, int V,
                                  void* stream) {
  if (N < 0 || C < 1 || V < 1 || V * 3 * sizeof(float) > 48 * 1024) return 1;
  if (N == 0) return 0;
  const dim3 grid(N, (C + kThreads - 1) / kThreads);
  support_minmax_kernel<<<grid, kThreads, V * 3 * sizeof(float),
                          static_cast<cudaStream_t>(stream)>>>(axes, w, mn, mx,
                                                               C, V);
  return static_cast<int>(cudaGetLastError());
}
