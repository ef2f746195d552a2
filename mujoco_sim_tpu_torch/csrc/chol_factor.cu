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
// 14 kB and 25 kFLOP at n = 42).  In practice, like chol_solve, the chain
// of n dependent column steps on a batch too small to hide it.  The design
// is chol_solve's with no work of its own: the factor is the very device
// function chol_solve runs (factor_rows in chol_factor.cuh: rows in
// registers, one shuffle, one shared column and one barrier per column
// step, size classes 8..64, several systems a warp below n = 16, cp.async
// staging).  What this file adds is the way out: each lane writes its row
// of L (zeros above the diagonal) into the staged matrix's place in shared
// memory, and the warp copies that out with coalesced stores.
//
// Above the size classes (n > 64) chol_factor_panel_kernel runs the panel
// factor of chol_solve.cu (factor_panels in chol_factor.cuh: one block a
// system, panels of 32 columns, warp 0 on the diagonal block with the
// register classes' column step, the panel's rows and the trailing update
// in register tiles on the block's threads, three barriers a panel), then
// writes L with zeros above the diagonal, coalesced.  Its bound is bytes
// (8 n^2 a system), its time the panel chain's latency, as for
// chol_solve.  Past the card's shared memory (n > 236) it factors in
// place in the output with the column loop (chol_factor_work_kernel); no
// step launches it.
//
// Build (no PyTorch headers; loaded with ctypes by ops/chol_factor.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
#include "chol_factor.cuh"

namespace {

using namespace cholk;

template <int NP>
__global__ void __launch_bounds__(kMaxWarpsPerBlock* kWarp)
    chol_factor_kernel(const float* __restrict__ A, float* __restrict__ L,
                       int N, int n, int ld, unsigned magic) {
  using T = Tile<NP>;
  extern __shared__ __align__(16) float smem[];
  const Place<NP> at(smem, n, ld);
  const bool live = at.sys < N;
  const int l = at.l;

  if (live) stage_matrix<NP>(at.stage, A + at.sys * n * n, n, ld, magic, l);
  asynccopy::wait_all();
  __syncwarp();

  float a[T::kRows][NP];
  float inv[T::kRows], diag[T::kRows], unused[T::kRows];
  load_rows<NP>(a, at.stage, n, ld, l, live);
  __syncwarp();  // every lane has read the staged matrix: it is free now
  factor_rows<NP, false>(a, inv, diag, unused, at.col, n, l);

  // the lane's rows of L into shared memory: L[i][k] left of the diagonal,
  // the pivot over its floored square root on it, zeros right of it
#pragma unroll
  for (int r = 0; r < T::kRows; ++r) {
    const int i = l + kWarp * r;
    if (live && i < n) {
      const float lii = diag[r] * inv[r];
#pragma unroll
      for (int k = 0; k < NP; ++k)
        if (k < n)
          at.stage[i * ld + k] = k < i ? a[r][k] : (k == i ? lii : 0.0f);
    }
  }
  __syncwarp();
  if (live) {
    float* Ls = L + at.sys * n * n;
    for (unsigned t = l; t < static_cast<unsigned>(n * n); t += T::kLanes) {
      const unsigned r = __umulhi(t, magic);
      Ls[t] = at.stage[r * ld + (t - r * n)];
    }
  }
}

// One system a block (n > kMaxN), the matrix in dynamic shared memory with
// row stride ld: the panel factor, then L with zeros above the diagonal,
// coalesced.
__global__ void __launch_bounds__(256)
    chol_factor_panel_kernel(const float* __restrict__ A,
                             float* __restrict__ L, int n, int ld) {
  extern __shared__ __align__(16) float smem[];
  const long long sys = blockIdx.x;
  const Panels p(smem, n, ld);
  stage_panels(p, A + sys * n * n);
  asynccopy::wait_all();
  __syncthreads();
  factor_panels<false>(p);
  float* Ls = L + sys * n * n;
  const unsigned magic = div_magic(n);
  for (unsigned t = threadIdx.x; t < static_cast<unsigned>(n * n);
       t += blockDim.x) {
    const unsigned r = __umulhi(t, magic), c = t - r * n;
    Ls[t] = c <= r ? p.S[r * ld + c] : 0.0f;
  }
}

// One system a block past the card's shared memory: factored in place in
// its slot of L (stride n) by the column loop, the column buffer in shared
// memory, then zeros written above the diagonal (each thread reads only
// the entries it writes).
__global__ void __launch_bounds__(256)
    chol_factor_work_kernel(const float* __restrict__ A,
                            float* __restrict__ L, int n) {
  extern __shared__ __align__(16) float smem[];
  const long long sys = blockIdx.x;
  float* Ls = L + sys * n * n;
  load_lower(Ls, n, A + sys * n * n, n);
  __syncthreads();
  factor_block<false>(Ls, n, nullptr, smem, n);
  for (int t = threadIdx.x; t < n * n; t += blockDim.x) {
    const int r = t / n, c = t - r * n;
    if (c > r) Ls[t] = 0.0f;
  }
}

int launch_big(const float* A, float* L, int N, int n, cudaStream_t stream) {
  const int ld = panel_fit_ld(n);
  if (ld == 0) {
    chol_factor_work_kernel<<<N, block_threads(n), n * sizeof(float),
                              stream>>>(A, L, n);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t bytes = panel_floats(n, ld) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        chol_factor_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  chol_factor_panel_kernel<<<N, panel_threads(n), bytes, stream>>>(A, L, n,
                                                                    ld);
  return static_cast<int>(cudaGetLastError());
}

template <int NP>
int launch(const float* A, float* L, int N, int n, cudaStream_t stream) {
  const int per_warp = warp_floats<NP>(n) * static_cast<int>(sizeof(float));
  const int warps = warps_per_block(per_warp);
  const int per_block = warps * Tile<NP>::kSystems;
  chol_factor_kernel<NP>
      <<<(N + per_block - 1) / per_block, warps * kWarp, warps * per_warp,
         stream>>>(A, L, N, n, row_stride(n), div_magic(n));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// A (N, n, n) -> L (N, n, n): contiguous float32 on the device.  Returns the
// cudaError_t of the launch (0 = cudaSuccess); 1 for n out of range (n < 1,
// or n n past 2^31 - 1).
extern "C" int chol_factor_f32(const float* A, float* L, int N, int n,
                               void* stream) {
  if (n < 1 || n > 46340 || N < 0) return 1;
  if (N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > kMaxN) return launch_big(A, L, N, n, s);
  return CHOLK_DISPATCH(n, launch, A, L, N, n, s);
}
