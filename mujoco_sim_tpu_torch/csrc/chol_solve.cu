// Batched small SPD solve x = A^-1 b on Hopper (sm_90a): column Cholesky
// fused with the forward substitution, then the backward substitution.
//
// Replaces the Pallas TPU kernel mujoco_sim_tpu/ops/pallas_chol.py
// `_make_kernel` (public `chol_solve`).  It computes the same thing: for
// each system, L L^T = A with the pivot floored as sqrt(max(a_jj, 1e-30)),
// y = L^-1 b folded into the factor loop, then x = L^-T y.  It does not copy
// the TPU layout (batch on the 128 lanes of an (n, n, 128) VMEM tile).
//
// What bounds it on this card:
//  * n = 6 (one free body): each system is ~100 flops and 168 bytes, so a
//    call over a few thousand envs is bound by launch latency, not by the
//    SMs or HBM.
//  * n ~ 49 (a humanoid-class tree): shared-memory traffic of the trailing
//    update (~n^3/3 reads and writes per system) and the serial column
//    loop, whose n steps each end in a warp barrier.
// What this simple design does about that: one warp per system, so a
// barrier is a __syncwarp() and never a block barrier; A is copied once
// into shared memory with coalesced loads (row stride padded to an odd
// count so the lanes of a column update hit distinct banks); lanes run over
// the rows below the pivot; several systems share a block so small-n calls
// still fill the SMs.  Arithmetic is plain f32 FMA: no tensor cores, no
// TF32 — the Newton Hessian carries stiff rows (efc_D ~ 1e9) that lose the
// factor in reduced precision, the reason the TPU kernel stays on the VPU.
//
// Build (no PyTorch headers; loaded with ctypes by ops/chol.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
//
// The factor loop lives in chol_factor.cuh, shared with chol_factor.cu.
#include "chol_factor.cuh"

namespace {

using namespace cholk;

__global__ void chol_solve_kernel(const float* __restrict__ A,
                                  const float* __restrict__ b,
                                  float* __restrict__ x, int N, int n,
                                  int ld) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int sys = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (sys >= N) return;  // whole warp leaves together

  float* a = smem + warp * (n * ld + n);  // factor in progress, row stride ld
  float* y = a + n * ld;                  // forward-substituted rhs
  const float* As = A + static_cast<long long>(sys) * n * n;
  const float* bs = b + static_cast<long long>(sys) * n;
  float* xs = x + static_cast<long long>(sys) * n;

  load_matrix(a, As, n, ld, lane);
  for (int t = lane; t < n; t += kWarp) y[t] = bs[t];
  __syncwarp();

  // right-looking column Cholesky fused with the forward substitution
  factor_warp<true>(a, y, n, ld, lane);

  // backward substitution L^T x = y (column-oriented, descending)
  for (int j = n - 1; j >= 0; --j) {
    const float xj = y[j] / a[j * ld + j];
    if (lane == 0) xs[j] = xj;
    __syncwarp();
    for (int i = lane; i < j; i += kWarp) y[i] -= a[j * ld + i] * xj;
    __syncwarp();
  }
}

}  // namespace

// A (N, n, n), b (N, n), x (N, n): contiguous float32 on the device.
// Returns the cudaError_t of the launch (0 = cudaSuccess); 1 for n out of
// range.
extern "C" int chol_solve_f32(const float* A, const float* b, float* x, int N,
                              int n, void* stream) {
  if (n < 1 || n > kMaxN || N < 0) return 1;
  if (N == 0) return 0;
  const int ld = row_stride(n);
  const int per_warp = (n * ld + n) * static_cast<int>(sizeof(float));
  const int warps = warps_per_block(per_warp);
  const int blocks = (N + warps - 1) / warps;
  chol_solve_kernel<<<blocks, warps * kWarp, warps * per_warp,
                      static_cast<cudaStream_t>(stream)>>>(A, b, x, N, n, ld);
  return static_cast<int>(cudaGetLastError());
}
