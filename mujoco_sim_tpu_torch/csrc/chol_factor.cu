// Batched small SPD factor L = chol(A) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel benchmarks/pallas_chol_proto.py
// `make_chol_kernel` (a right-looking factor with the pivot floored at
// 1e-30 and zeros written above the diagonal).  It computes the same thing
// and keeps none of the TPU layout: no (n, n, 128) lane tiles, no transposes
// and no padding of the batch to 128; any N.
//
// The step's one consumer is the noslip pass, which needs the factor of the
// mass matrix itself (a matrix right-hand side M^-1 J^T), once per step.
//
// What bounds it on this card: nominally bytes (each matrix read once and
// the factor written once, 8 n^2 bytes per system against ~n^3 / 3 flops:
// 14 kB and 25 kFLOP at n = 42).  In practice, like chol_solve, the serial
// column loop: n steps, each ending in a warp barrier, over shared memory.
// What this simple design does about that is chol_solve's: one warp per
// system (every barrier a __syncwarp), the matrix staged once in shared
// memory with an odd row stride, several systems per block.  The factor
// loop is the very code chol_solve runs (chol_factor.cuh).
//
// Build (no PyTorch headers; loaded with ctypes by ops/chol_factor.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
#include "chol_factor.cuh"

namespace {

using namespace cholk;

__global__ void chol_factor_kernel(const float* __restrict__ A,
                                   float* __restrict__ L, int N, int n,
                                   int ld) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int sys = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (sys >= N) return;  // whole warp leaves together

  float* a = smem + warp * (n * ld);
  load_matrix(a, A + static_cast<long long>(sys) * n * n, n, ld, lane);
  __syncwarp();

  factor_warp<false>(a, nullptr, n, ld, lane);

  // the factor's lower triangle, zeros above the diagonal (coalesced)
  float* Ls = L + static_cast<long long>(sys) * n * n;
  for (int t = lane; t < n * n; t += kWarp) {
    const int i = t / n, k = t % n;
    Ls[t] = k <= i ? a[i * ld + k] : 0.0f;
  }
}

}  // namespace

// A (N, n, n) -> L (N, n, n): contiguous float32 on the device.  Returns the
// cudaError_t of the launch (0 = cudaSuccess); 1 for n out of range.
extern "C" int chol_factor_f32(const float* A, float* L, int N, int n,
                               void* stream) {
  if (n < 1 || n > kMaxN || N < 0) return 1;
  if (N == 0) return 0;
  const int ld = row_stride(n);
  const int per_warp = n * ld * static_cast<int>(sizeof(float));
  const int warps = warps_per_block(per_warp);
  const int blocks = (N + warps - 1) / warps;
  chol_factor_kernel<<<blocks, warps * kWarp, warps * per_warp,
                       static_cast<cudaStream_t>(stream)>>>(A, L, N, n, ld);
  return static_cast<int>(cudaGetLastError());
}
