// Shared device code of the batched small-SPD kernels (sm_90a): one warp
// factors one matrix held in shared memory.  chol_solve.cu (factor fused
// with the substitutions) and chol_factor.cu (the factor alone, written
// out) both call factor_warp, so the two factors cannot drift apart.
//
// The factor is the right-looking column Cholesky L L^T = A with the pivot
// floored as sqrt(max(a_jj, 1e-30)); column j is scaled by 1 / pivot and the
// trailing lower triangle updated, lanes striding the rows below the pivot.
// With kWithRhs the forward substitution y = L^-1 b rides the same loop.
// Arithmetic is plain f32 FMA: no tensor cores, no TF32 (stiff rows,
// efc_D ~ 1e9, lose the factor in reduced precision).
#pragma once
#include <cuda_runtime.h>

namespace cholk {

constexpr int kWarp = 32;
constexpr int kMaxN = 64;
constexpr int kMaxWarpsPerBlock = 8;
constexpr int kSmemBudget = 48 * 1024;  // no opt-in attribute needed

// Row stride of the matrix in shared memory: padded to an odd count so the
// lanes of a column update hit distinct banks.
__host__ __device__ inline int row_stride(int n) {
  return (n % 2 == 0) ? n + 1 : n;
}

// Warps (systems) per block for `per_warp` bytes of shared memory each.
inline int warps_per_block(int per_warp) {
  int warps = kSmemBudget / per_warp;
  if (warps > kMaxWarpsPerBlock) warps = kMaxWarpsPerBlock;
  if (warps < 1) warps = 1;
  return warps;
}

// Coalesced copy of one contiguous (n, n) matrix into shared memory.
__device__ __forceinline__ void load_matrix(float* a, const float* As, int n,
                                            int ld, int lane) {
  for (int t = lane; t < n * n; t += kWarp) a[(t / n) * ld + t % n] = As[t];
}

// In-place factor of the lower triangle of a (row stride ld); the strict
// upper triangle is left as it was.  y (n) is forward-substituted along
// when kWithRhs.  The caller has synchronised the warp after loading.
template <bool kWithRhs>
__device__ __forceinline__ void factor_warp(float* a, float* y, int n, int ld,
                                            int lane) {
  for (int j = 0; j < n; ++j) {
    const float piv = sqrtf(fmaxf(a[j * ld + j], 1e-30f));
    const float inv = 1.0f / piv;
    float yj = 0.0f;
    if (kWithRhs) yj = y[j] * inv;
    __syncwarp();
    for (int i = j + lane; i < n; i += kWarp) a[i * ld + j] *= inv;
    if (kWithRhs && lane == 0) y[j] = yj;
    __syncwarp();
    // trailing update of the lower triangle: a[i][k] -= l_ij * l_kj
    for (int i = j + 1 + lane; i < n; i += kWarp) {
      const float lij = a[i * ld + j];
      for (int k = j + 1; k <= i; ++k) a[i * ld + k] -= lij * a[k * ld + j];
      if (kWithRhs) y[i] -= lij * yj;
    }
    __syncwarp();
  }
}

}  // namespace cholk
