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
// Systems above the classes (n > kMaxN) take factor_panels below: one
// block a system, the matrix in dynamic shared memory (n <= 236 on the
// H100), factored in panels of 32 columns whose diagonal blocks run
// factor_rows<32>; past the card's shared memory, factor_block, the
// column loop in device memory.
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

// ceil(2^32 / n): __umulhi(t, magic) == t / n for every t < 2^32 / n (so
// for every t < n * n while n < 1625).
__host__ __device__ inline unsigned div_magic(int n) {
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
// One block a system, the matrix in dynamic shared memory (n <= 236 on the
// H100), factored in panels of kPanel = 32 columns (factor_panels below).
// What bounds it is the chain of dependent steps: a column of the
// diagonal factor (~150-300 cycles a column on the H100, shuffles and the
// pivot's reciprocal square root), a row of a substitution.  The design
// keeps that chain on one warp and off block barriers (three a panel),
// puts the bulk of the multiply-adds (the panel's rows, the trailing
// update, the inverted blocks) on every thread with register tiles and
// 16-byte loads, and fits the pile scene's 1024 systems on the card at
// once (64 threads and 80 registers a system at n = 66).  Past the card's
// shared memory the matrix sits in a device-memory workspace (chol_solve)
// or in the output itself (chol_factor) and takes factor_block, the
// column loop at the end of this file.

constexpr int kPanel = 32;        // columns a panel: one warp's factor
constexpr int kUld = kPanel + 4;  // row stride of a panel's L11^T

// Threads a system for the panel kernels: enough for the trailing update's
// 4 x 4 tiles and the panel's rows, few enough that at n = 66 nine systems
// fit an SM by shared memory and by registers (the step's 1024 systems are
// resident at once).
__host__ __device__ inline int panel_threads(int n) {
  return n <= 96 ? 64 : (n <= 160 ? 128 : 256);
}

// Row stride of the panel layout: a multiple of 4 (16-byte rows), an odd
// multiple of 4 where `odd` (rows 4 banks apart, so the 8 threads of a
// 16-byte access phase that read 8 rows hit distinct banks).
__host__ __device__ inline int panel_ld(int n, bool odd) {
  const int ld = (n + 3) & ~3;
  return odd && ld % 8 == 0 ? ld + 4 : ld;
}

// Floats of dynamic shared memory of the panel kernels at n and ld: the
// matrix, a panel's L11^T, the factor's column buffers, then y, the
// reciprocal pivots and the substitution's reciprocal diagonal (n each,
// rounded to 4 so every part stays 16-byte aligned).
__host__ __device__ inline int panel_floats(int n, int ld) {
  return n * ld + kPanel * kUld + 2 * kPanel + 3 * ((n + 3) & ~3);
}

// The row stride the panel kernels take at n on the current device
// (bank-spread where that fits), or 0 where the matrix does not fit its
// shared memory and the column loop in device memory takes it.
inline int panel_fit_ld(int n) {
  const size_t optin = static_cast<size_t>(asynccopy::smem_optin());
  for (const bool odd : {true, false}) {
    const int ld = panel_ld(n, odd);
    if (static_cast<size_t>(panel_floats(n, ld)) * sizeof(float) <= optin)
      return ld;
  }
  return 0;
}

// Where a system's parts sit in the block's shared memory.
struct Panels {
  float* S;     // the matrix, row-major, row stride ld; lower triangle
  float* U;     // the current panel's L11^T, row stride kUld
  float* col;   // factor_rows' two column buffers
  float* y;     // right-hand side, then y = L^-1 b, then x
  float* pinv;  // 1 / sqrt(max(a_jj, 1e-30)) a column
  float* binv;  // 1 / L_jj a column, for the backward substitution
  int n, ld;

  __device__ __forceinline__ Panels(float* smem, int n_, int ld_)
      : n(n_), ld(ld_) {
    const int n4 = (n_ + 3) & ~3;
    S = smem;
    U = S + n_ * ld_;
    col = U + kPanel * kUld;
    y = col + 2 * kPanel;
    pinv = y + n4;
    binv = pinv + n4;
  }
};

// Issue the copy of the row-major (n, n) matrix As into S (row stride ld):
// coalesced cp.async, 16 bytes a copy where n and As allow it, all in
// flight at once.  The whole matrix is copied; only its lower triangle is
// read.  The caller waits (asynccopy::wait_all + __syncthreads).
__device__ __forceinline__ void stage_panels(const Panels& p,
                                             const float* As) {
  const int n = p.n;
  if ((n & 3) == 0 && (reinterpret_cast<unsigned long long>(As) & 15) == 0) {
    const int q = n / 4;                      // 16-byte chunks a row
    const unsigned magic = 0xffffffffu / q + 1u;
    for (unsigned t = threadIdx.x; t < static_cast<unsigned>(n * q);
         t += blockDim.x) {
      const unsigned r = q == 1 ? t : __umulhi(t, magic);
      asynccopy::copy_f32x4(p.S + r * p.ld + 4 * (t - r * q), As + 4 * t);
    }
  } else {
    const unsigned magic = div_magic(n);
    for (unsigned t = threadIdx.x; t < static_cast<unsigned>(n * n);
         t += blockDim.x) {
      const unsigned r = __umulhi(t, magic);
      asynccopy::copy_f32(p.S + r * p.ld + (t - r * n), As + t);
    }
  }
}

// The diagonal block of the panel at column j0 (w <= kPanel columns), by
// warp 0 in registers: factor_rows<kPanel>, the register classes' own
// column factor (lane l holds row j0 + l; only the lower triangle is
// loaded, the rest is zero and what the symmetric update leaves there is
// not read).  L11 goes back into S and, transposed, into U for the panel's
// rows below; the pivots' reciprocals into pinv and binv, y's entries of
// the panel forward-substituted when kWithRhs.
template <bool kWithRhs>
__device__ __forceinline__ void diag_block(const Panels& p, int j0, int w,
                                           int l) {
  float a[1][kPanel], inv[1], diag[1], y[1];
#pragma unroll
  for (int k = 0; k < kPanel; ++k) a[0][k] = 0.0f;
  if (l < w) {  // the row 16 bytes at a time, then only k <= l kept
    const float* row = p.S + (j0 + l) * p.ld + j0;
#pragma unroll
    for (int k = 0; k < kPanel; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(row + k);
      a[0][k] = k <= l ? v.x : 0.0f;
      a[0][k + 1] = k + 1 <= l ? v.y : 0.0f;
      a[0][k + 2] = k + 2 <= l ? v.z : 0.0f;
      a[0][k + 3] = k + 3 <= l ? v.w : 0.0f;
    }
  }
  y[0] = (kWithRhs && l < w) ? p.y[j0 + l] : 0.0f;
  factor_rows<kPanel, kWithRhs>(a, inv, diag, y, p.col, w, l);
  if (l < w) {
    float* out = p.S + (j0 + l) * p.ld + j0;
#pragma unroll
    for (int k = 0; k < kPanel; ++k) {
      if (k < l) {
        out[k] = a[0][k];
        p.U[k * kUld + l] = a[0][k];
      }
    }
    const float lii = diag[0] * inv[0];
    out[l] = lii;
    p.U[l * kUld + l] = lii;
    p.pinv[j0 + l] = inv[0];
    if (kWithRhs) {
      p.y[j0 + l] = y[0];
      p.binv[j0 + l] = diag[0] < 1e-30f ? 1.0f / lii : inv[0];
    }
  }
}

// The panel's rows below its diagonal block (rows j1.. of columns j0..j1,
// j1 = j0 + kPanel): L21 = A21 L11^-T, a thread a row, the row's 32 entries
// in registers and L11's columns read from U with 16-byte broadcast loads
// (the same multiply-adds, in the same order, as the column factor makes on
// those entries).  y_i -= L21 y_1 rides along when kWithRhs.
template <bool kWithRhs>
__device__ __forceinline__ void panel_rows(const Panels& p, int j0, int j1) {
  for (int i = j1 + threadIdx.x; i < p.n; i += blockDim.x) {
    float* row = p.S + i * p.ld + j0;
    float x[kPanel], pv[kPanel];
#pragma unroll
    for (int m = 0; m < kPanel; m += 4) {
      const float4 v = *reinterpret_cast<const float4*>(row + m);
      x[m] = v.x;
      x[m + 1] = v.y;
      x[m + 2] = v.z;
      x[m + 3] = v.w;
      const float4 q = *reinterpret_cast<const float4*>(p.pinv + j0 + m);
      pv[m] = q.x;
      pv[m + 1] = q.y;
      pv[m + 2] = q.z;
      pv[m + 3] = q.w;
    }
#pragma unroll
    for (int k = 0; k < kPanel; ++k) {
      x[k] *= pv[k];
      const float* u = p.U + k * kUld;
#pragma unroll
      for (int m4 = (k + 1) / 4 * 4; m4 < kPanel; m4 += 4) {
        const float4 c4 = *reinterpret_cast<const float4*>(u + m4);
        const float c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (m4 + q > k) x[m4 + q] = fmaf(-x[k], c[q], x[m4 + q]);
      }
    }
#pragma unroll
    for (int m = 0; m < kPanel; m += 4)
      *reinterpret_cast<float4*>(row + m) =
          make_float4(x[m], x[m + 1], x[m + 2], x[m + 3]);
    if (kWithRhs) {
      float yi = p.y[i];
#pragma unroll
      for (int m = 0; m < kPanel; ++m) yi = fmaf(-x[m], p.y[j0 + m], yi);
      p.y[i] = yi;
    }
  }
}

// The trailing update A22 -= L21 L21^T of the lower triangle past j1, in
// 4 x 4 tiles, a thread a tile (the diagonal tiles whole): each tile keeps
// its 16 sums in registers and reads L21 four columns at a time, 16-byte
// loads of 4 rows of each side: 8 loads to 64 multiply-adds.  Rows and
// columns past n are clamped to row n - 1 on the way in and not stored.
__device__ __forceinline__ void trailing_update(const Panels& p, int j0,
                                                int j1) {
  const int n = p.n, ld = p.ld;
  const int T = (n - j1 + 3) / 4, tiles = T * (T + 1) / 2;
  for (int q = threadIdx.x; q < tiles; q += blockDim.x) {
    // q -> (bi, bk), bk <= bi, row by row over the lower tile triangle
    int bi = static_cast<int>((sqrtf(8.0f * q + 1.0f) - 1.0f) * 0.5f);
    while (bi * (bi + 1) / 2 > q) --bi;
    while ((bi + 1) * (bi + 2) / 2 <= q) ++bi;
    const int bk = q - bi * (bi + 1) / 2;
    const int i0 = j1 + 4 * bi, k0 = j1 + 4 * bk;
    const float* li[4];
    const float* lk[4];
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      li[r] = p.S + min(i0 + r, n - 1) * ld + j0;
      lk[r] = p.S + min(k0 + r, n - 1) * ld + j0;
      const float4 v =
          *reinterpret_cast<const float4*>(p.S + min(i0 + r, n - 1) * ld + k0);
      acc[r][0] = v.x;
      acc[r][1] = v.y;
      acc[r][2] = v.z;
      acc[r][3] = v.w;
    }
#pragma unroll
    for (int m = 0; m < kPanel; m += 4) {
      float a[4][4], b[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 va = *reinterpret_cast<const float4*>(li[r] + m);
        const float4 vb = *reinterpret_cast<const float4*>(lk[r] + m);
        a[r][0] = va.x; a[r][1] = va.y; a[r][2] = va.z; a[r][3] = va.w;
        b[r][0] = vb.x; b[r][1] = vb.y; b[r][2] = vb.z; b[r][3] = vb.w;
      }
#pragma unroll
      for (int mm = 0; mm < 4; ++mm)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = fmaf(-a[r][mm], b[c][mm], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (i0 + r < n)
        *reinterpret_cast<float4*>(p.S + (i0 + r) * ld + k0) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// The blocked right-looking factor of S's lower triangle, with the forward
// substitution y = L^-1 y when kWithRhs: per panel of kPanel columns, warp
// 0 factors the diagonal block (diag_block), the block's threads then
// solve the panel's rows below it (panel_rows) and update the trailing
// triangle (trailing_update); a block barrier after each, three a panel.
// Every entry sees the column factor's multiply-adds in the column
// factor's order, so only the pivots' reciprocal square roots (within an
// ulp of IEEE's) set it apart from the plain right-looking loop.  S ends
// with L in its lower triangle and L_jj = a_jj * inv_j on the diagonal.
template <bool kWithRhs>
__device__ void factor_panels(const Panels& p) {
  for (int j0 = 0; j0 < p.n; j0 += kPanel) {
    const int w = min(kPanel, p.n - j0), j1 = j0 + w;
    if (threadIdx.x < kWarp) diag_block<kWithRhs>(p, j0, w, threadIdx.x);
    __syncthreads();
    if (j1 < p.n) {
      panel_rows<kWithRhs>(p, j0, j1);
      __syncthreads();
      trailing_update(p, j0, j1);
      __syncthreads();
    }
  }
}

// X = L11^-1 of the diagonal block at column j0 (w columns), by one warp:
// lane l computes column l, row by row, X[i][l] = (delta_il - sum_{k<i}
// L[i][k] X[k][l]) / L[i][i], with row i of L read by 16-byte broadcast
// loads and the sum split over four accumulators (the chain a row is a
// quarter of its length), no exchange between lanes.  The diagonal X[l][l]
// is binv itself; the rest goes into the block's upper triangle, which the
// factor leaves unused: X[i][l] at S[(j0 + l) ld + j0 + i], i > l, so lane
// l's column is one row of S.
__device__ __forceinline__ void invert_diag_block(const Panels& p, int j0,
                                                  int w, int l) {
  float X[kPanel];
  float* out = p.S + (j0 + l) * p.ld + j0;
#pragma unroll
  for (int i = 0; i < kPanel; ++i) {
    X[i] = 0.0f;
    if (i < w) {  // uniform over the warp
      const float* row = p.S + (j0 + i) * p.ld + j0;  // L[i][k], k < i
      float acc[4] = {i == l ? 1.0f : 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k4 = 0; k4 < i; k4 += 4) {
        const float4 v = *reinterpret_cast<const float4*>(row + k4);
        const float r[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (k4 + q < i) acc[q] = fmaf(-r[q], X[k4 + q], acc[q]);
      }
      X[i] = ((acc[0] + acc[1]) + (acc[2] + acc[3])) * p.binv[j0 + i];
      if (i > l && l < w) out[i] = X[i];
    }
  }
}

// x = L^-T y over the factor in S, in place in y.  First every diagonal
// block is inverted (invert_diag_block, a warp a block, all at once), then
// by panels from the last: warp 0 takes x_panel = L11^-T y_panel, a lane a
// row as one dot product of its column of L11^-1 with y (no chain across
// rows), a barrier, then the block's threads take x_panel off the rows
// above it (a thread a row), a barrier.  The substitution's n dependent
// steps become one block's inversion chain.
__device__ void backward_panels(const Panels& p) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int panels = (p.n + kPanel - 1) / kPanel;
  for (int q = warp; q < panels; q += blockDim.x / kWarp)
    invert_diag_block(p, q * kPanel, min(kPanel, p.n - q * kPanel), lane);
  __syncthreads();
  for (int j0 = (panels - 1) * kPanel; j0 >= 0; j0 -= kPanel) {
    const int w = min(kPanel, p.n - j0);
    if (warp == 0) {
      // lane l < w: x_l = X[l][l] y_l + sum_{i > l} X[i][l] y_i, its
      // column of X and y read 16 bytes at a time (what lies past the
      // block or below the lane's row is read and not used)
      float x = 0.0f;
      if (lane < w) {
        const float* col = p.S + (j0 + lane) * p.ld + j0;  // X[.][lane]
        x = p.binv[j0 + lane] * p.y[j0 + lane];
#pragma unroll
        for (int i4 = 0; i4 < kPanel; i4 += 4) {
          const float4 c4 = *reinterpret_cast<const float4*>(col + i4);
          const float4 y4 = *reinterpret_cast<const float4*>(p.y + j0 + i4);
          const float c[4] = {c4.x, c4.y, c4.z, c4.w};
          const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (i4 + q > lane && i4 + q < w) x = fmaf(c[q], yv[q], x);
        }
      }
      __syncwarp();  // every lane has read y before any writes it
      if (lane < w) p.y[j0 + lane] = x;
    }
    __syncthreads();
    if (j0 == 0) break;
    for (int i = threadIdx.x; i < j0; i += blockDim.x) {
      float yi = p.y[i];
#pragma unroll
      for (int m = 0; m < kPanel; ++m)
        if (m < w) yi = fmaf(-p.S[(j0 + m) * p.ld + i], p.y[j0 + m], yi);
      p.y[i] = yi;
    }
    __syncthreads();
  }
}

// ---- past the card's shared memory: the column loop in device memory ----
//
// One block of block_threads(n) threads a system, the matrix at S with row
// stride ld in a device-memory workspace (chol_solve) or in the output
// itself (chol_factor); the scaled column of each step and the right-hand
// side sit in `col` and `y`, n floats each of shared memory.  No step of
// the engine launches it (n > 236): it is the simple loop, right for any n.

__host__ __device__ inline int block_threads(int n) { return n <= 128 ? 128 : 256; }

// The right-looking column factor of the lower triangle of the n x n matrix
// at S, fused with the forward substitution y = L^-1 y when kWithRhs.  At
// column j every thread reads the pivot and takes inv = 1 / sqrt(max(a_jj,
// 1e-30)) (IEEE square root and division: the references' formula); the
// threads scale the column below the diagonal into S and into col; a
// barrier; each thread then updates whole rows i > j of the trailing lower
// triangle, a[i][k] -= l_ij l_kj for j < k <= i, and y_i -= l_ij y_j; a
// barrier.  The diagonal becomes L_jj = a_jj * inv, as the references store
// it (for a floored pivot that is not the square root of a_jj).  The upper
// triangle is neither read nor written.
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
