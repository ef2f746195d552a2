// Exact minimum-translation-vector query of two convex hulls on Hopper
// (sm_90a): coarse face-normal SAT + edge-cross refinement rounds.
//
// Replaces the Pallas TPU kernel mujoco_sim_tpu/ops/pallas_refine.py
// `_make_kernel` (public `mtv_query`).  Per instance (one hull pair):
//
//   coarse pass: axes = A's world face normals, then B's negated; for each
//   valid axis u the support gap fwd = max_A(u.a) - min_B(u.b) along +u and
//   rev = max_B - min_A along -u; depth = the first minimum of
//   min(fwd, rev) by axis index, n = +u unless rev < fwd.
//   `rounds` refinement rounds: the K edges of each hull nearest its support
//   plane along the current n (scored in the hull's local frame, K serial
//   argmin passes with lowest-index ties; a masked edge scores +inf and a
//   pass that finds only +inf gives a zero direction), the K x K table of
//   normalised cross products (norm <= 1e-12: invalid), the same gap scan
//   over it, and a strict `<` update of (depth, n).
//   A hull flagged as a cylinder (cyl[0] > 0.5: radius cyl[1], half-height
//   cyl[2], axis = third column of R, centre p) takes its analytic support
//   instead of the scan of its prism vertices.
//
// It computes what the TPU kernel computes and keeps none of its layout
// (instances on 128 lanes, component-major tables, vertex chunks, 2-D
// carries).  Vertices come repeat-padded and are scanned unmasked; edge
// and face slots are masked by hm / fm.
//
// What bounds it on this card: operations, and within them latency.  An
// instance reads 4 (6 V + 14 E + 8 F + 30) bytes (4.6 KB at V = 24,
// E = 56, F = 34) and does about 6 V (2 F + rounds K^2) multiply-adds for
// the scans (0.1 MFLOP) plus 2 K serial selection passes per round; the
// flops over the f32 peak exceed the bytes over the memory rate, and the
// selection passes are chains of dependent shuffles.  The plain version
// launches some hundred small tensor ops per query and writes the
// (N, K^2, V) products to device memory.  What this design does about it:
// one block per instance holds both hulls' tables in shared memory (5 KB
// at the sizes above, 19 KB at V = 80, E = 216, F = 144); threads stride
// over the axes and each scans the vertices from shared memory as
// broadcasts; the pick is one block reduction on (value, index); the two
// hulls' edge selections run concurrently on two warps with shuffle
// reductions only.  Many small blocks per SM hide the serial passes of one
// behind the scans of another.
//
// Built with -fmad=false (see support.cuh): every pick is a float
// comparison.  Loaded with ctypes by ops/mtv_query.py.
#include <climits>

#include "support.cuh"

namespace {

using namespace hullk;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;

struct Hull {
  const float* w;    // V * 3 world vertices
  const float* he;   // E * 6 local edge endpoints
  const float* hm;   // E edge mask
  const float* nf;   // F * 3 world face normals
  const float* fm;   // F face mask
  const float* R;    // 9 rotation, row-major
  const float* p;    // 3 world position
  const float* cyl;  // [flag, radius, half-height]
  float* score;      // E scratch
  float* dir;        // K * 3 selected world edge directions
};

__device__ __forceinline__ void hull_extent(const Hull& h, int V, float ux,
                                            float uy, float uz, float& mn,
                                            float& mx) {
  if (h.cyl[0] > 0.5f) {
    const float aw[3] = {h.R[2], h.R[5], h.R[8]};
    cyl_extent(ux, uy, uz, aw, h.p, h.cyl[1], h.cyl[2], mn, mx);
  } else {
    support_scan(h.w, V, ux, uy, uz, mn, mx);
  }
}

// Block-wide argmin with lowest-index ties; every thread gets the result.
__device__ __forceinline__ void block_argmin(float& v, int& i, float* rv,
                                             int* ri) {
  warp_argmin(v, i);
  __syncthreads();  // the scratch may still be read from the last call
  if (threadIdx.x % kWarp == 0) {
    rv[threadIdx.x / kWarp] = v;
    ri[threadIdx.x / kWarp] = i;
  }
  __syncthreads();
  v = rv[0];
  i = ri[0];
  for (int w = 1; w < kWarps; ++w)
    if (less_vi(rv[w], ri[w], v, i)) {
      v = rv[w];
      i = ri[w];
    }
}

// One thread's running best over the axes it visits (ascending index).
struct Best {
  float v = INFINITY;
  int c = INT_MAX;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
};

__device__ __forceinline__ void consider(Best& b, const Hull& A, const Hull& B,
                                         int V, int c, float ux, float uy,
                                         float uz, bool valid) {
  float mnA, mxA, mnB, mxB;
  hull_extent(A, V, ux, uy, uz, mnA, mxA);
  hull_extent(B, V, ux, uy, uz, mnB, mxB);
  const float fwd = mxA - mnB;  // penetration along +u
  const float rev = mxB - mnA;  // penetration along -u
  const float comb = valid ? fminf(fwd, rev) : INFINITY;
  if (less_vi(comb, c, b.v, b.c)) {
    const float sgn = (!valid || fwd <= rev) ? 1.0f : -1.0f;
    b.v = comb;
    b.c = c;
    b.nx = sgn * ux;
    b.ny = sgn * uy;
    b.nz = sgn * uz;
  }
}

// Reduce the threads' bests; res = [depth, nx, ny, nz] of the winner.
__device__ __forceinline__ void publish(const Best& b, float* res, float* rv,
                                        int* ri) {
  float v = b.v;
  int c = b.c;
  block_argmin(v, c, rv, ri);
  if (c != INT_MAX && c == b.c) {
    res[0] = b.v;
    res[1] = b.nx;
    res[2] = b.ny;
    res[3] = b.nz;
  }
  __syncthreads();
}

// One warp: the K edges of hull h nearest its support plane along n
// (sign > 0: the hull supports at its max, else at its min).
__device__ void select_edges(const Hull& h, int V, int E, int K,
                             const float* n, float sign) {
  const int lane = threadIdx.x % kWarp;
  // support extent of the hull along n
  float s;
  if (h.cyl[0] > 0.5f) {
    const float aw[3] = {h.R[2], h.R[5], h.R[8]};
    float mn, mx;
    cyl_extent(n[0], n[1], n[2], aw, h.p, h.cyl[1], h.cyl[2], mn, mx);
    s = sign > 0.0f ? mx : mn;
  } else {
    float loc = sign > 0.0f ? -INFINITY : INFINITY;
    for (int v = lane; v < V; v += kWarp) {
      const float pr =
          dot3(n[0], n[1], n[2], h.w[3 * v], h.w[3 * v + 1], h.w[3 * v + 2]);
      loc = sign > 0.0f ? fmaxf(loc, pr) : fminf(loc, pr);
    }
    s = sign > 0.0f ? warp_max(loc) : warp_min(loc);
  }
  // score in the local frame: nloc = R^T n, pe = he . nloc + p . n
  const float* R = h.R;
  const float l0 = R[0] * n[0] + R[3] * n[1] + R[6] * n[2];
  const float l1 = R[1] * n[0] + R[4] * n[1] + R[7] * n[2];
  const float l2 = R[2] * n[0] + R[5] * n[1] + R[8] * n[2];
  const float pn = dot3(h.p[0], h.p[1], h.p[2], n[0], n[1], n[2]);
  for (int e = lane; e < E; e += kWarp) {
    const float* q = h.he + 6 * e;
    const float pe0 = dot3(q[0], q[1], q[2], l0, l1, l2) + pn;
    const float pe1 = dot3(q[3], q[4], q[5], l0, l1, l2) + pn;
    const float d0 = sign > 0.0f ? s - pe0 : pe0 - s;
    const float d1 = sign > 0.0f ? s - pe1 : pe1 - s;
    h.score[e] = h.hm[e] > 0.5f ? fmaxf(d0, d1) : INFINITY;
  }
  __syncwarp();
  for (int k = 0; k < K; ++k) {
    float bv = INFINITY;
    int bi = INT_MAX;
    for (int e = lane; e < E; e += kWarp)
      if (less_vi(h.score[e], e, bv, bi)) {
        bv = h.score[e];
        bi = e;
      }
    warp_argmin(bv, bi);
    if (lane == 0) {
      float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
      if (bi != INT_MAX && isfinite(bv)) {
        const float* q = h.he + 6 * bi;
        const float x = q[3] - q[0], y = q[4] - q[1], z = q[5] - q[2];
        d0 = R[0] * x + R[1] * y + R[2] * z;
        d1 = R[3] * x + R[4] * y + R[5] * z;
        d2 = R[6] * x + R[7] * y + R[8] * z;
      }
      h.dir[3 * k] = d0;
      h.dir[3 * k + 1] = d1;
      h.dir[3 * k + 2] = d2;
      if (bi != INT_MAX) h.score[bi] = INFINITY;
    }
    __syncwarp();
  }
}

__global__ void mtv_query_kernel(
    const float* __restrict__ wA, const float* __restrict__ wB,
    const float* __restrict__ heA, const float* __restrict__ heB,
    const float* __restrict__ hmA, const float* __restrict__ hmB,
    const float* __restrict__ nfA, const float* __restrict__ nfB,
    const float* __restrict__ fmA, const float* __restrict__ fmB,
    const float* __restrict__ RA, const float* __restrict__ RB,
    const float* __restrict__ pA, const float* __restrict__ pB,
    const float* __restrict__ cylA, const float* __restrict__ cylB,
    float* __restrict__ depth_out, float* __restrict__ n_out, int V, int E,
    int F, int K, int rounds) {
  extern __shared__ float smem[];
  __shared__ float rv[kWarps];
  __shared__ int ri[kWarps];
  __shared__ float cur[4];  // running [depth, n]
  __shared__ float res[4];  // a pass's [depth, n]
  const long long inst = blockIdx.x;
  const int tid = threadIdx.x;

  // carve shared memory and stage both hulls
  float* ptr = smem;
  auto stage = [&](const float* src, int count) {
    float* dst = ptr;
    ptr += count;
    const float* g = src + inst * count;
    for (int t = tid; t < count; t += kThreads) dst[t] = g[t];
    return dst;
  };
  Hull A, B;
  A.w = stage(wA, 3 * V);
  B.w = stage(wB, 3 * V);
  A.he = stage(heA, 6 * E);
  B.he = stage(heB, 6 * E);
  A.hm = stage(hmA, E);
  B.hm = stage(hmB, E);
  A.nf = stage(nfA, 3 * F);
  B.nf = stage(nfB, 3 * F);
  A.fm = stage(fmA, F);
  B.fm = stage(fmB, F);
  A.R = stage(RA, 9);
  B.R = stage(RB, 9);
  A.p = stage(pA, 3);
  B.p = stage(pB, 3);
  A.cyl = stage(cylA, 3);
  B.cyl = stage(cylB, 3);
  A.score = ptr;
  ptr += E;
  B.score = ptr;
  ptr += E;
  A.dir = ptr;
  ptr += 3 * K;
  B.dir = ptr;
  if (tid < 4) res[tid] = tid == 0 ? INFINITY : 0.0f;
  __syncthreads();

  // ---- coarse pass: A's face normals, then B's negated
  {
    Best b;
    for (int c = tid; c < 2 * F; c += kThreads) {
      const bool fromA = c < F;
      const float* nf = fromA ? A.nf + 3 * c : B.nf + 3 * (c - F);
      const float sg = fromA ? 1.0f : -1.0f;
      const bool valid = (fromA ? A.fm[c] : B.fm[c - F]) > 0.5f;
      consider(b, A, B, V, c, sg * nf[0], sg * nf[1], sg * nf[2], valid);
    }
    publish(b, res, rv, ri);
    if (tid < 4) cur[tid] = res[tid];
    __syncthreads();
  }

  // ---- refinement rounds
  for (int r = 0; r < rounds; ++r) {
    if (tid / kWarp == 0) select_edges(A, V, E, K, cur + 1, 1.0f);
    if (tid / kWarp == 1) select_edges(B, V, E, K, cur + 1, -1.0f);
    __syncthreads();
    Best b;
    for (int c = tid; c < K * K; c += kThreads) {
      const float* a = A.dir + 3 * (c / K);
      const float* d = B.dir + 3 * (c % K);
      const float cx = a[1] * d[2] - a[2] * d[1];
      const float cy = a[2] * d[0] - a[0] * d[2];
      const float cz = a[0] * d[1] - a[1] * d[0];
      const float crn = sqrtf(cx * cx + cy * cy + cz * cz);
      const float den = fmaxf(crn, 1e-12f);
      consider(b, A, B, V, c, cx / den, cy / den, cz / den, crn > 1e-12f);
    }
    publish(b, res, rv, ri);
    const bool better = res[0] < cur[0];  // strict: a tie keeps the old axis
    __syncthreads();
    if (tid < 4 && better) cur[tid] = res[tid];
    __syncthreads();
  }

  if (tid == 0) depth_out[inst] = cur[0];
  if (tid < 3) n_out[inst * 3 + tid] = cur[1 + tid];
}

}  // namespace

// Per instance: wA/wB (V, 3), heA/heB (E, 2, 3), hmA/hmB (E,), nfA/nfB
// (F, 3), fmA/fmB (F,), RA/RB (3, 3), pA/pB (3,), cylA/cylB (3,) -> depth
// (), n (3,); every array contiguous float32 on the device with a leading
// instance axis N.  Returns the cudaError_t of the launch (0 =
// cudaSuccess); 1 for sizes the kernel does not take (the tables of one
// instance must fit 48 KB of shared memory).
extern "C" int mtv_query_f32(const float* wA, const float* wB,
                             const float* heA, const float* heB,
                             const float* hmA, const float* hmB,
                             const float* nfA, const float* nfB,
                             const float* fmA, const float* fmB,
                             const float* RA, const float* RB, const float* pA,
                             const float* pB, const float* cylA,
                             const float* cylB, float* depth, float* n, int N,
                             int V, int E, int F, int K, int rounds,
                             void* stream) {
  const size_t bytes =
      (6 * V + 16 * E + 8 * F + 6 * K + 36) * sizeof(float);
  if (N < 0 || V < 1 || E < 1 || F < 1 || K < 1 || rounds < 0 ||
      bytes > 47 * 1024)
    return 1;
  if (N == 0) return 0;
  mtv_query_kernel<<<N, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      wA, wB, heA, heB, hmA, hmB, nfA, nfB, fmA, fmB, RA, RB, pA, pB, cylA,
      cylB, depth, n, V, E, F, K, rounds);
  return static_cast<int>(cudaGetLastError());
}
