// Batched small SPD solve x = A^-1 b on Hopper (sm_90a): column Cholesky
// fused with the forward substitution, then the backward substitution.
//
// Replaces the Pallas TPU kernel mujoco_sim_tpu/ops/pallas_chol.py
// `_make_kernel` (public `chol_solve`).  It computes the same thing: for
// each system, L L^T = A with the pivot floored as sqrt(max(a_jj, 1e-30)),
// y = L^-1 b folded into the factor loop, then x = L^-T y.  It does not copy
// the TPU layout (batch on the 128 lanes of an (n, n, 128) VMEM tile).
//
// What bounds it on this card: nominally bytes (a system is read once:
// 4 n (n + 2) bytes against ~n^3 / 3 flops), in practice latency.  A solve
// is a chain of n dependent column steps and n dependent substitution
// steps, and the step's batches are small (1024 systems of n = 42, 4096 of
// n = 6): there is about one warp of work per scheduler, so nothing hides a
// step that waits on memory.  The first version kept the matrix in shared
// memory and paid two loads and a store per multiply-add of the trailing
// update, three barriers a column and a division per substitution step.
//
// What this design does about it (the factor itself is chol_factor.cuh,
// shared with chol_factor.cu; its note describes the register layout):
//  * the matrix lives in registers, a row (two above n = 32) per lane, the
//    kernel templated on the padded size 8 / 16 / 32 / 48 / 64; a column
//    step exchanges one shuffle for the pivot and one column of n floats
//    through shared memory (16-byte broadcast reads, one barrier), and the
//    trailing update is independent register FMAs;
//  * the reciprocal pivots are kept (an approximate reciprocal square root
//    and one Newton step, not a square root and a division), so both
//    substitutions multiply, and the next column's entries and pivot go
//    ahead by shuffle so the column chain never waits on shared memory; the
//    backward substitution needs row i of L^T in lane i, which is what the
//    symmetric update leaves right of the diagonal, so its step is one
//    shuffle and one FMA per row with no memory access;
//  * n <= 16 packs two systems into a warp and n <= 8 four, with sub-warp
//    shuffles: the box scene's (4096, 6) fills its lanes;
//  * the matrix is staged with coalesced cp.async copies that are all in
//    flight before the one wait, with no division per element; four warps
//    a block, so 1024 systems are 256 blocks over the 132 SMs and every
//    warp is resident at once.
// Arithmetic is plain f32 FMA: no tensor cores, no TF32 -- the Newton
// Hessian carries stiff rows (efc_D ~ 1e9) that lose the factor in reduced
// precision, the reason the TPU kernel stays on the VPU.
//
// Build (no PyTorch headers; loaded with ctypes by ops/chol.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
#include "chol_factor.cuh"

namespace {

using namespace cholk;

template <int NP>
__global__ void __launch_bounds__(kMaxWarpsPerBlock* kWarp)
    chol_solve_kernel(const float* __restrict__ A, const float* __restrict__ b,
                      float* __restrict__ x, int N, int n, int ld,
                      unsigned magic) {
  using T = Tile<NP>;
  extern __shared__ __align__(16) float smem[];
  const Place<NP> at(smem, n, ld);
  const bool live = at.sys < N;
  const int l = at.l;

  if (live) stage_matrix<NP>(at.stage, A + at.sys * n * n, n, ld, magic, l);
  float y[T::kRows];
#pragma unroll
  for (int r = 0; r < T::kRows; ++r) {
    const int i = l + kWarp * r;
    y[r] = (live && i < n) ? b[at.sys * n + i] : 0.0f;
  }
  asynccopy::wait_all();
  __syncwarp();

  float a[T::kRows][NP];
  float inv[T::kRows], diag[T::kRows];
  load_rows<NP>(a, at.stage, n, ld, l, live);
  factor_rows<NP, true>(a, inv, diag, y, at.col, n, l);

  // backward substitution L^T x = y, descending.  Lane i holds column i of
  // L below the diagonal, unscaled (a[j] = L[j][i] / inv_i for j > i), so
  // x_i = (y_i - inv_i * sum_{j > i} a[j] x_j) / L[i][i].  1 / L[i][i] is
  // inv_i itself unless the pivot was floored (L[i][i] = a_ii * inv_i).
  float s[T::kRows], xi[T::kRows], binv[T::kRows];
#pragma unroll
  for (int r = 0; r < T::kRows; ++r) {
    s[r] = xi[r] = 0.0f;
    binv[r] = inv[r];
    if (inv[r] > 0.0f && diag[r] < 1e-30f)
      binv[r] = 1.0f / (diag[r] * inv[r]);
  }
#pragma unroll
  for (int j = NP - 1; j >= 0; --j) {
    if (j < n) {  // uniform over the warp
      const int rj = j / kWarp;
      const float t = fmaf(-inv[rj], s[rj], y[rj]) * binv[rj];
      const float xj = __shfl_sync(kFull, t, j % kWarp, T::kLanes);
#pragma unroll
      for (int r = 0; r < T::kRows; ++r) {
        if (l + kWarp * r == j) xi[r] = xj;
        s[r] = fmaf(a[r][j], xj, s[r]);  // read again only by rows above j
      }
    }
  }
#pragma unroll
  for (int r = 0; r < T::kRows; ++r) {
    const int i = l + kWarp * r;
    if (live && i < n) x[at.sys * n + i] = xi[r];
  }
}

template <int NP>
int launch(const float* A, const float* b, float* x, int N, int n,
           cudaStream_t stream) {
  const int per_warp = warp_floats<NP>(n) * static_cast<int>(sizeof(float));
  const int warps = warps_per_block(per_warp);
  const int per_block = warps * Tile<NP>::kSystems;
  chol_solve_kernel<NP>
      <<<(N + per_block - 1) / per_block, warps * kWarp, warps * per_warp,
         stream>>>(A, b, x, N, n, row_stride(n), div_magic(n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A (N, n, n), b (N, n), x (N, n): contiguous float32 on the device.
// Returns the cudaError_t of the launch (0 = cudaSuccess); 1 for n out of
// range.
extern "C" int chol_solve_f32(const float* A, const float* b, float* x, int N,
                              int n, void* stream) {
  if (n < 1 || n > kMaxN || N < 0) return 1;
  if (N == 0) return 0;
  return CHOLK_DISPATCH(n, launch, A, b, x, N, n,
                        static_cast<cudaStream_t>(stream));
}
