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
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxN = 64;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kSmemBudget = 48 * 1024;  // no opt-in attribute needed

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

  for (int t = lane; t < n * n; t += kWarp) a[(t / n) * ld + t % n] = As[t];
  for (int t = lane; t < n; t += kWarp) y[t] = bs[t];
  __syncwarp();

  // right-looking column Cholesky fused with the forward substitution
  for (int j = 0; j < n; ++j) {
    const float piv = sqrtf(fmaxf(a[j * ld + j], 1e-30f));
    const float inv = 1.0f / piv;
    const float yj = y[j] * inv;
    __syncwarp();
    for (int i = j + lane; i < n; i += kWarp) a[i * ld + j] *= inv;
    if (lane == 0) y[j] = yj;
    __syncwarp();
    // trailing update of the lower triangle: a[i][k] -= l_ij * l_kj
    for (int i = j + 1 + lane; i < n; i += kWarp) {
      const float lij = a[i * ld + j];
      for (int k = j + 1; k <= i; ++k) a[i * ld + k] -= lij * a[k * ld + j];
      y[i] -= lij * yj;
    }
    __syncwarp();
  }

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
  const int ld = (n % 2 == 0) ? n + 1 : n;
  const int per_warp = (n * ld + n) * static_cast<int>(sizeof(float));
  int warps = kSmemBudget / per_warp;
  if (warps > kMaxWarpsPerBlock) warps = kMaxWarpsPerBlock;
  if (warps < 1) warps = 1;
  const int blocks = (N + warps - 1) / warps;
  chol_solve_kernel<<<blocks, warps * kWarp, warps * per_warp,
                      static_cast<cudaStream_t>(stream)>>>(A, b, x, N, n, ld);
  return static_cast<int>(cudaGetLastError());
}
