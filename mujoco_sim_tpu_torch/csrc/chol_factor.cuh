// Shared device code of the batched small-SPD kernels (sm_90a): the factor
// L L^T = A of one matrix, held in the registers of the lanes that own its
// rows.  chol_solve.cu (factor fused with the substitutions) and
// chol_factor.cu (the factor alone, written out) both call factor_rows, so
// the two factors cannot drift apart.
//
// Layout.  The kernels are templated on a padded size class NP (8, 16, 32,
// 48, 64; the launcher takes the smallest that holds n).  A system is owned
// by kLanes = min(NP, 32) lanes; lane l of the group holds rows l and, above
// 32, l + 32, each as NP registers.  Below 32 a warp carries 32 / NP systems
// side by side (four at n <= 8), so small systems still fill the lanes.
// Every loop over rows and columns is unrolled at compile time: the matrix
// never leaves the register file during the factor.
//
// The factor is the right-looking column Cholesky with the pivot floored as
// sqrt(max(a_jj, 1e-30)).  At column j every lane reads the pivot from its
// owner with one shuffle, scales its own entry a_ij by the reciprocal pivot,
// publishes it in a double-buffered column of NP floats in shared memory
// (one store, one __syncwarp), and the lanes below the pivot subtract
// l_ij * l_kj from their whole row with 16-byte broadcast reads of that
// column: independent FMAs on registers, not a read-modify-write chain
// through memory.  Column j + 1 and the next pivot go ahead by shuffle, so
// the chain from column to column never waits on shared memory.  Rows are
// updated on both sides of the diagonal (the matrix is loaded as the mirror
// of its lower triangle, so the update stays exactly symmetric); a row
// stops changing once it has been the pivot row.  Lane i therefore ends with
//     a[k] = L[i][k]            for k < i,
//     a[i] = the pivot a_ii before its square root (L[i][i] = a[i] * inv_i),
//     a[k] = L[k][i] / inv_i    for k > i: column i of L, unscaled,
// and inv_i = 1 / sqrt(max(a_ii, 1e-30)).  The part right of the diagonal
// is what the backward substitution needs (row i of L^T), already in the
// right lane.
// With kWithRhs the forward substitution y = L^-1 b rides the same loop.
// Rows and columns n..NP-1 are zeros and take no part: a padded row scales
// to 0, never becomes a pivot, and no shuffle reads it.
// Arithmetic is plain f32 FMA: no tensor cores, no TF32 (stiff rows,
// efc_D ~ 1e9, lose the factor in reduced precision).
//
// Systems above the classes (n > kMaxN) take factor_block below instead:
// one block a system, the matrix in dynamic shared memory while it fits
// (n <= 239 on the H100), else in device memory.
#pragma once
#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace cholk {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxN = 64;
constexpr int kMaxWarpsPerBlock = 4;
constexpr int kSmemBudget = 48 * 1024;  // no opt-in attribute needed

template <int NP>
struct Tile {
  static constexpr int kLanes = NP < kWarp ? NP : kWarp;  // lanes a system
  static constexpr int kRows = (NP + kWarp - 1) / kWarp;  // rows a lane
  static constexpr int kSystems = kWarp / kLanes;         // systems a warp
};

// Row stride of the staged matrix in shared memory: odd, so the lanes of a
// row-wise and of a column-wise access hit distinct banks.
__host__ __device__ inline int row_stride(int n) { return n | 1; }

// ceil(2^32 / n): __umulhi(t, magic) == t / n for every t < n * n <= 4096.
inline unsigned div_magic(int n) {
  return n == 1 ? 0u : 0xffffffffu / static_cast<unsigned>(n) + 1u;
}

// Floats of shared memory one warp needs: the column buffers of its
// systems, then their staged matrices (a multiple of 4 floats in all, so
// every warp's column buffers stay 16-byte aligned).
template <int NP>
__host__ __device__ inline int warp_floats(int n) {
  const int f = Tile<NP>::kSystems * (2 * NP + n * row_stride(n));
  return (f + 3) & ~3;
}

// Warps per block for `per_warp` bytes of shared memory each.
inline int warps_per_block(int per_warp) {
  int warps = kSmemBudget / per_warp;
  if (warps > kMaxWarpsPerBlock) warps = kMaxWarpsPerBlock;
  return warps;
}

// Where one lane stands: its warp's systems, its own system and its rows.
template <int NP>
struct Place {
  int l;        // lane within the system's group
  long long sys;  // system index (may be >= N in the last warp)
  float* col;   // the system's two column buffers, 2 * NP floats
  float* stage; // the system's staged matrix, n rows of stride ld

  __device__ __forceinline__ Place(float* smem, int n, int ld) {
    using T = Tile<NP>;
    const int lane = threadIdx.x % kWarp;
    const int warp = threadIdx.x / kWarp;
    const int g = lane / T::kLanes;
    l = lane % T::kLanes;
    sys = (static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp) *
              T::kSystems + g;
    float* base = smem + warp * warp_floats<NP>(n);
    col = base + g * 2 * NP;
    stage = base + T::kSystems * 2 * NP + g * n * ld;
  }
};

// Issue the copy of one contiguous (n, n) matrix into the staged layout:
// coalesced 4-byte cp.async, all in flight at once, no division (magic =
// div_magic(n)).  The caller waits (asynccopy::wait_all + __syncwarp).
template <int NP>
__device__ __forceinline__ void stage_matrix(float* stage, const float* As,
                                             int n, int ld, unsigned magic,
                                             int l) {
  for (unsigned t = l; t < static_cast<unsigned>(n * n);
       t += Tile<NP>::kLanes) {
    const unsigned r = __umulhi(t, magic);
    asynccopy::copy_f32(stage + r * ld + (t - r * n), As + t);
  }
}

// The lane's rows from the staged matrix, as the mirror of the lower
// triangle: a[k] = A[max(i, k)][min(i, k)]; zeros outside n (and for a
// system that is not live).
template <int NP>
__device__ __forceinline__ void load_rows(
    float (&a)[Tile<NP>::kRows][NP], const float* stage, int n, int ld, int l,
    bool live) {
#pragma unroll
  for (int r = 0; r < Tile<NP>::kRows; ++r) {
    const int i = l + kWarp * r;
    const bool row = live && i < n;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      float v = 0.0f;
      if (row && k < n) v = stage[k <= i ? i * ld + k : k * ld + i];
      a[r][k] = v;
    }
  }
}

// 1 / sqrt(max(d, 1e-30)): the reciprocal of the floored pivot.  The
// hardware's approximate reciprocal square root and one Newton step replace
// an IEEE square root followed by an IEEE division, which were half of a
// column step's dependent latency; the result is within an ulp of theirs.
__device__ __forceinline__ float pivot_rsqrt(float d) {
  const float x = fmaxf(d, 1e-30f);
  const float r = rsqrtf(x);
  const float e = fmaf(-x * r, r, 1.0f);
  return fmaf(0.5f * r, e, r);
}

// Column step J of the factor; d and pinv come in as the pivot a_JJ and its
// floored reciprocal square root and go out as those of column J + 1.  J is
// a template parameter, not a loop variable, so every register index and
// the trip count of the trailing update are constants where the step is
// written.
//
// The chain from one column to the next is kept off shared memory: column
// J + 1 is updated first, with l_{J+1,J} taken by shuffle from its lane,
// and the next pivot is read and inverted before the barrier, so its
// latency hides behind the rest of the trailing update, which reads the
// published column.
template <int NP, bool kWithRhs, int J>
__device__ __forceinline__ void column_step(
    float (&a)[Tile<NP>::kRows][NP], float (&inv)[Tile<NP>::kRows],
    float (&diag)[Tile<NP>::kRows], float (&y)[Tile<NP>::kRows], float* col,
    int l, float& d, float& pinv) {
  using T = Tile<NP>;
  constexpr int kOwnerRow = J / kWarp, kOwnerLane = J % kWarp;
  constexpr int kNextRow = (J + 1) / kWarp, kNextLane = (J + 1) % kWarp;
  float* cb = col + (J & 1) * NP;
  float yj = 0.0f;
  if (kWithRhs)
    yj = __shfl_sync(kFull, y[kOwnerRow], kOwnerLane, T::kLanes) * pinv;
  // m = -l_ij for a row below the pivot, 0 for the others: their FMAs add
  // -0 * l_kj and leave the row as it is, with no select per element
  float lij[T::kRows], m[T::kRows];
#pragma unroll
  for (int r = 0; r < T::kRows; ++r) {
    const int i = l + kWarp * r;
    lij[r] = a[r][J] * pinv;
    if (i < NP) cb[i] = lij[r];
    m[r] = i > J ? -lij[r] : 0.0f;
    if (i == J) {
      inv[r] = pinv;
      diag[r] = d;
      if (kWithRhs) y[r] = yj;
    }
    if (i > J) a[r][J] = lij[r];
    if (kWithRhs) y[r] = fmaf(m[r], yj, y[r]);
  }
  if constexpr (J + 1 < NP) {
    const float cn = __shfl_sync(kFull, lij[kNextRow], kNextLane, T::kLanes);
#pragma unroll
    for (int r = 0; r < T::kRows; ++r)
      if (kWarp * r + kWarp - 1 > J) a[r][J + 1] = fmaf(m[r], cn, a[r][J + 1]);
    d = __shfl_sync(kFull, a[kNextRow][J + 1], kNextLane, T::kLanes);
    pinv = pivot_rsqrt(d);
  }
  // one barrier a column: the buffer written now was last read two columns
  // ago, before the barrier of the column between
  __syncwarp();
  // trailing update of the rows below the pivot, both sides of the
  // diagonal: a[i][k] -= l_ij * l_kj for k > J + 1
#pragma unroll
  for (int k4 = (J + 2) / 4 * 4; k4 < NP; k4 += 4) {
    const float4 c4 = *reinterpret_cast<const float4*>(cb + k4);
    const float c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (k4 + q > J + 1) {
#pragma unroll
        for (int r = 0; r < T::kRows; ++r)
          // (rows l + 32 r all lie above the pivot once J >= 32 r + 31)
          if (kWarp * r + kWarp - 1 > J)
            a[r][k4 + q] = fmaf(m[r], c[q], a[r][k4 + q]);
      }
    }
  }
}

template <int NP, bool kWithRhs, int J>
__device__ __forceinline__ void columns_from(
    float (&a)[Tile<NP>::kRows][NP], float (&inv)[Tile<NP>::kRows],
    float (&diag)[Tile<NP>::kRows], float (&y)[Tile<NP>::kRows], float* col,
    int n, int l, float& d, float& pinv) {
  if constexpr (J < NP) {
    if (J < n)  // uniform over the warp
      column_step<NP, kWithRhs, J>(a, inv, diag, y, col, l, d, pinv);
    columns_from<NP, kWithRhs, J + 1>(a, inv, diag, y, col, n, l, d, pinv);
  }
}

// The factor, in place in the lanes' registers (see the note above for what
// each lane holds afterwards).  For each of the lane's rows inv gets the
// reciprocal of the floored pivot, 1 / sqrt(max(a_ii, 1e-30)), and diag the
// pivot a_ii itself, so L[i][i] = diag * inv as the references store it (a
// pivot below the floor is not its own square root); both 0 for a padded
// row.  y holds the lane's entries of the right-hand side and is
// forward-substituted along when kWithRhs.  col is the system's column
// buffers.
template <int NP, bool kWithRhs>
__device__ __forceinline__ void factor_rows(
    float (&a)[Tile<NP>::kRows][NP], float (&inv)[Tile<NP>::kRows],
    float (&diag)[Tile<NP>::kRows], float (&y)[Tile<NP>::kRows], float* col,
    int n, int l) {
#pragma unroll
  for (int r = 0; r < Tile<NP>::kRows; ++r) inv[r] = diag[r] = 0.0f;
  float d = __shfl_sync(kFull, a[0][0], 0, Tile<NP>::kLanes);
  float pinv = pivot_rsqrt(d);
  columns_from<NP, kWithRhs, 0>(a, inv, diag, y, col, n, l, d, pinv);
}

// ---- systems above the size classes (n > kMaxN) --------------------------
//
// One block of block_threads(n) threads a system.  The matrix sits at S with
// row stride ld: dynamic shared memory (ld = n | 1, so the threads of a
// column access hit distinct banks) or, past the card's shared memory, a
// device-memory workspace (chol_solve) or the output itself (chol_factor).
// The scaled column of each step and the right-hand side sit in `col` and
// `y`, n floats each of shared memory.  It is a simple kernel that is right
// for any n: the register classes above carry the step's own sizes.

__host__ __device__ inline int block_threads(int n) { return n <= 128 ? 128 : 256; }

// The right-looking column factor of the lower triangle of the n x n matrix
// at S, fused with the forward substitution y = L^-1 y when kWithRhs.  At
// column j every thread reads the pivot and takes inv = 1 / sqrt(max(a_jj,
// 1e-30)) (IEEE square root and division: the references' formula); the
// threads scale the column below the diagonal into S and into col; a
// barrier; each thread then updates whole rows i > j of the trailing lower
// triangle, a[i][k] -= l_ij l_kj for j < k <= i, and y_i -= l_ij y_j; a
// barrier.  The row update reads the column from col, which no thread
// writes in that phase, four entries at a time: the loads of a row are
// independent, so they overlap (with one array the compiler must assume
// every store may feed the next load, and each multiply-add waited a full
// shared-memory round trip).  The diagonal becomes L_jj = a_jj * inv, as
// the references store it (for a floored pivot that is not the square root
// of a_jj).  The upper triangle is neither read nor written.
template <bool kWithRhs>
__device__ void factor_block(float* S, int ld, float* __restrict__ y,
                             float* __restrict__ col, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int j = 0; j < n; ++j) {
    const float d = S[j * ld + j];
    const float inv = 1.0f / sqrtf(fmaxf(d, 1e-30f));
    const float yj = kWithRhs ? y[j] * inv : 0.0f;
    for (int i = j + 1 + tid; i < n; i += nt) {
      const float l = S[i * ld + j] * inv;
      S[i * ld + j] = l;
      col[i] = l;
    }
    __syncthreads();
    // nobody reads the pivot's own entries until the next barrier
    if (tid == 0) {
      S[j * ld + j] = d * inv;
      if (kWithRhs) y[j] = yj;
    }
    for (int i = j + 1 + tid; i < n; i += nt) {
      float* row = S + i * ld;
      const float m = -col[i];
      int k = j + 1;
      for (; k + 3 <= i; k += 4) {
        const float c0 = col[k], c1 = col[k + 1], c2 = col[k + 2],
                    c3 = col[k + 3];
        const float r0 = row[k], r1 = row[k + 1], r2 = row[k + 2],
                    r3 = row[k + 3];
        row[k] = fmaf(m, c0, r0);
        row[k + 1] = fmaf(m, c1, r1);
        row[k + 2] = fmaf(m, c2, r2);
        row[k + 3] = fmaf(m, c3, r3);
      }
      for (; k <= i; ++k) row[k] = fmaf(m, col[k], row[k]);
      if (kWithRhs) y[i] = fmaf(m, yj, y[i]);
    }
    __syncthreads();
  }
}

// The n x n lower triangle of the row-major As into S (stride ld), with
// coalesced reads; the caller places a barrier after it.
__device__ __forceinline__ void load_lower(float* S, int ld, const float* As,
                                           int n) {
  for (int t = threadIdx.x; t < n * n; t += blockDim.x) {
    const int r = t / n, c = t - r * n;
    if (c <= r) S[r * ld + c] = As[t];
  }
}

}  // namespace cholk

// FN<NP>(args...) for the smallest size class NP that holds n.
#define CHOLK_DISPATCH(n, FN, ...)          \
  ((n) <= 8    ? FN<8>(__VA_ARGS__)         \
   : (n) <= 16 ? FN<16>(__VA_ARGS__)        \
   : (n) <= 32 ? FN<32>(__VA_ARGS__)        \
   : (n) <= 48 ? FN<48>(__VA_ARGS__)        \
               : FN<64>(__VA_ARGS__))
