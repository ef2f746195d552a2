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
// Above the size classes (n > 64: every free body adds 6 dofs, so a pile
// of 11 boxes or a hand goes over) the same function runs as
// chol_solve_panel_kernel, one block a system, the matrix in dynamic
// shared memory (n <= 236 on the H100).  What bounds it there is latency:
// at the pile scene's (1024, 66) every system is resident at once and
// the chains of dependent steps set the time, not the 18 MB it reads.  The
// first version (the column loop below, one block of 128 threads a
// system) paid two block barriers a column, a shared load, a load and a
// store per multiply-add of its trailing update, and one barrier and a
// division a row of the backward substitution: 0.117 ms at (1024, 66),
// 21x its bound.  What this design does about it (chol_factor.cuh,
// factor_panels and backward_panels):
//  * panels of 32 columns: warp 0 factors the panel's diagonal block with
//    the register classes' own column step (factor_rows<32>: shuffles and
//    a warp-local column, no block barrier) with the forward substitution
//    fused; the block's threads then solve the panel's rows below it, a
//    row each in registers with 16-byte broadcast loads of L11^T, and
//    update the trailing triangle in 4 x 4 register tiles (8 16-byte loads
//    to 64 multiply-adds); three block barriers a panel, not two a column;
//  * the backward substitution inverts every diagonal block at once, a
//    warp a block and a lane a column (no exchange between lanes), then
//    takes each panel's x as one dot product a row: the n dependent steps
//    of a substitution become one 32-step inversion, two barriers a panel;
//  * 64 threads a system up to n = 96 (128 to 160, 256 above) and 80
//    registers, so nine systems fit an SM at n = 66 by shared memory and
//    by registers: the step's 1024 systems are all resident at once;
//  * the matrix is staged with cp.async (16 bytes a copy where n allows),
//    all in flight before the one wait, into rows of an odd multiple of 4
//    floats, so 16-byte accesses of 8 rows hit distinct banks;
//  * the reciprocal pivots are kept, so the substitutions multiply; a
//    floored pivot is divided by as stored (binv), as the references do.
// Every entry of L sees the column factor's multiply-adds in the column
// factor's order, plain f32 FMA (no tensor cores, no TF32).  Past the
// card's shared memory (n > 236) the system takes chol_solve_work_kernel:
// the column loop of the first version on a device-memory workspace the
// wrapper allocates; no step launches it.
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

// x = L^-T y over the factor at S (row j of L at S[j * ld + i], i < j),
// one barrier a step: x_j = y_j / L_jj, then y_i -= L_ji x_j for i < j.
__device__ void backward_block(const float* S, int ld, float* y, float* x,
                               int n) {
  for (int j = n - 1; j >= 0; --j) {
    const float xj = y[j] / S[j * ld + j];
    for (int i = threadIdx.x; i < j; i += blockDim.x)
      y[i] = fmaf(-S[j * ld + i], xj, y[i]);
    if (threadIdx.x == 0) x[j] = xj;
    __syncthreads();
  }
}

// One system a block (n > kMaxN), the matrix in dynamic shared memory with
// row stride ld: the panel factor with the forward substitution, then the
// backward substitution by panels.
__global__ void __launch_bounds__(256)
    chol_solve_panel_kernel(const float* __restrict__ A,
                            const float* __restrict__ b,
                            float* __restrict__ x, int n, int ld) {
  extern __shared__ __align__(16) float smem[];
  const long long sys = blockIdx.x;
  const Panels p(smem, n, ld);
  stage_panels(p, A + sys * n * n);
  for (int t = threadIdx.x; t < n; t += blockDim.x) p.y[t] = b[sys * n + t];
  asynccopy::wait_all();
  __syncthreads();
  factor_panels<true>(p);
  backward_panels(p);
  for (int t = threadIdx.x; t < n; t += blockDim.x) x[sys * n + t] = p.y[t];
}

// One system a block past the card's shared memory: the matrix in `work`
// (N n n floats of device memory), the right-hand side and the column
// buffer in shared memory; the column loop (factor_block).
__global__ void __launch_bounds__(256)
    chol_solve_work_kernel(const float* __restrict__ A,
                           const float* __restrict__ b, float* __restrict__ x,
                           float* __restrict__ work, int n) {
  extern __shared__ __align__(16) float smem[];
  const long long sys = blockIdx.x;
  float* y = smem;
  float* col = smem + n;
  float* S = work + sys * n * n;
  load_lower(S, n, A + sys * n * n, n);
  for (int t = threadIdx.x; t < n; t += blockDim.x) y[t] = b[sys * n + t];
  __syncthreads();
  factor_block<true>(S, n, y, col, n);
  backward_block(S, n, y, x + sys * n, n);
}

int launch_big(const float* A, const float* b, float* x, float* work, int N,
               int n, cudaStream_t stream) {
  const int ld = panel_fit_ld(n);
  if (ld == 0) {
    if (work == nullptr) return 1;
    chol_solve_work_kernel<<<N, block_threads(n), 2 * n * sizeof(float),
                             stream>>>(A, b, x, work, n);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t bytes = panel_floats(n, ld) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chol_solve_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  chol_solve_panel_kernel<<<N, panel_threads(n), bytes, stream>>>(A, b, x,
                                                                   n, ld);
  return static_cast<int>(cudaGetLastError());
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

// Floats of device-memory workspace a system needs: 0 where the kernel
// holds it in registers or shared memory, n n past the card's shared memory
// (n > 236 on the H100).
extern "C" long long chol_solve_work_floats(int n) {
  if (n <= kMaxN || panel_fit_ld(n) != 0) return 0;
  return static_cast<long long>(n) * n;
}

// A (N, n, n), b (N, n), x (N, n): contiguous float32 on the device; work:
// N chol_solve_work_floats(n) floats on the device, or null where that is 0.
// Returns the cudaError_t of the launch (0 = cudaSuccess); 1 for n out of
// range (n < 1, or n n past 2^31 - 1) or a missing workspace.
extern "C" int chol_solve_f32(const float* A, const float* b, float* x,
                              float* work, int N, int n, void* stream) {
  if (n < 1 || n > 46340 || N < 0) return 1;
  if (N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > kMaxN) return launch_big(A, b, x, work, N, n, s);
  return CHOLK_DISPATCH(n, launch, A, b, x, N, n, s);
}
