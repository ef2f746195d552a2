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
//   plane along the current n (scored in the hull's local frame, taken in
//   (score, index) order; a masked edge scores +inf, and a slot whose edge
//   has no finite score gets a zero direction), the K x K table of
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
// What bounds it on this card: operations.  An instance reads
// 4 (6 V + 14 E + 8 F + 30) bytes (4.6 KB at V = 24, E = 56, F = 34) and
// scans 2 V vertices along 2 F + rounds K^2 axes (580 at K = 16, 2 rounds:
// 0.14 MFLOP).  Built without FMA contraction (every pick is a float
// comparison that must tie where the plain version ties) an axis-vertex
// product is 3 multiplies, 2 adds, a min and a max: 7 issue slots for the 5
// flops the bound counts, and min, max and every compare run on the SM's
// half-rate ALU pipe.  The first version (one block of 128 threads per
// instance) spent most of its time elsewhere: three scalar shared loads per
// axis-vertex product, K serial argmin passes per hull per round on one
// warp each while the other warps waited at a block barrier, five block
// barriers per pick.
//
// What this design does about it:
//  * one warp per instance, several instances a block: no block barrier
//    anywhere; the running (depth, n) is replicated in registers, a pick is
//    one shuffle reduction on (value, index) and one ballot;
//  * vertices are staged as float4 and a lane scans kAxes = 4 axes per
//    16-byte broadcast load (support_scan_block): a twelfth of the shared
//    loads per product, so the scan issues arithmetic, not loads;
//  * the K nearest edges come from one parallel ranking instead of K
//    dependent passes: (score, index) becomes one 64-bit key of the same
//    order, an edge's rank is the number of keys below its own, counted
//    against 16-byte broadcast reads of the key table with no dependence
//    between edges and no branch, and rank r < K writes direction r.  It
//    is the twin's total order, so the same picks: masked edges (+inf)
//    rank last by index and write zeros, slots K - E.. of a small hull
//    stay zero;
//  * a round that finds no better axis ends the instance: the next round
//    would repeat it exactly (face contacts stop after one round);
//  * every global load of an instance is a cp.async issued before the one
//    wait (16 bytes a copy where the table's size allows); ~6 KB of shared
//    memory and no block-wide state per instance keep 16-20 warps resident
//    per SM.  More residency does not help: the SM's issue slots are full.
//
// Built with -fmad=false (see support.cuh): every pick is a float
// comparison.  Loaded with ctypes by ops/mtv_query.py.
#include <climits>

#include "async_copy.cuh"
#include "support.cuh"

namespace {

using namespace hullk;

constexpr int kMaxWarps = 4;             // instances per block, at most
constexpr int kAxes = 4;                 // axes a lane scans per vertex load
constexpr int kRankEdges = 2;            // edges a lane ranks per sweep
constexpr int kSmemBudget = 47 * 1024;   // per block, no opt-in attribute

struct Hull {
  const float4* w;   // V world vertices (x, y, z, unused)
  const float* he;   // E * 6 local edge endpoints
  const float* hm;   // E edge mask
  const float* nf;   // F * 3 world face normals
  const float* fm;   // F face mask
  const float* R;    // 9 rotation, row-major
  const float* p;    // 3 world position
  const float* cyl;  // [flag, radius, half-height]
  float* dir;        // K * 3 selected world edge directions
};

// Floats of shared memory per instance (a multiple of 4).
__host__ __device__ inline int warp_floats(int V, int E, int F, int K) {
  const int Ep = (E + 3) & ~3;
  return (8 * V + 2 * Ep + 14 * E + 8 * F + 30 + 6 * K + 3) & ~3;
}

// (min, max) of the hull along kAxes unit axes.
__device__ __forceinline__ void hull_extents(
    const Hull& h, int V, const float (&ux)[kAxes], const float (&uy)[kAxes],
    const float (&uz)[kAxes], float (&mn)[kAxes], float (&mx)[kAxes]) {
  if (h.cyl[0] > 0.5f) {  // uniform over the warp
    const float aw[3] = {h.R[2], h.R[5], h.R[8]};
#pragma unroll
    for (int t = 0; t < kAxes; ++t)
      cyl_extent(ux[t], uy[t], uz[t], aw, h.p, h.cyl[1], h.cyl[2], mn[t],
                 mx[t]);
  } else {
    support_scan_block<kAxes>(h.w, V, ux, uy, uz, mn, mx);
  }
}

// One lane's running best over the axes it visits.
struct Best {
  float v = INFINITY;
  int c = INT_MAX;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
};

// Scan kAxes axes of this lane (index c[t], < 0: no axis) and fold them
// into its best: the smaller gap, then the lower axis index.
__device__ __forceinline__ void consider(
    Best& b, const Hull& A, const Hull& B, int V, const int (&c)[kAxes],
    const float (&ux)[kAxes], const float (&uy)[kAxes],
    const float (&uz)[kAxes], const bool (&valid)[kAxes]) {
  float mnA[kAxes], mxA[kAxes], mnB[kAxes], mxB[kAxes];
  hull_extents(A, V, ux, uy, uz, mnA, mxA);
  hull_extents(B, V, ux, uy, uz, mnB, mxB);
#pragma unroll
  for (int t = 0; t < kAxes; ++t) {
    if (c[t] < 0) continue;
    const float fwd = mxA[t] - mnB[t];  // penetration along +u
    const float rev = mxB[t] - mnA[t];  // penetration along -u
    const float comb = valid[t] ? fminf(fwd, rev) : INFINITY;
    if (less_vi(comb, c[t], b.v, b.c)) {
      const float sgn = (!valid[t] || fwd <= rev) ? 1.0f : -1.0f;
      b.v = comb;
      b.c = c[t];
      b.nx = sgn * ux[t];
      b.ny = sgn * uy[t];
      b.nz = sgn * uz[t];
    }
  }
}

// Reduce the lanes' bests; every lane gets [depth, n] of the winner.
__device__ __forceinline__ void pick(const Best& b, float& d, float& nx,
                                     float& ny, float& nz) {
  float v = b.v;
  int c = b.c;
  warp_argmin(v, c);
  const unsigned own = __ballot_sync(kFull, c != INT_MAX && b.c == c);
  const int src = own ? __ffs(own) - 1 : 0;  // one owner: indices are unique
  d = v;
  nx = __shfl_sync(kFull, b.nx, src);
  ny = __shfl_sync(kFull, b.ny, src);
  nz = __shfl_sync(kFull, b.nz, src);
}

// (score, index) as one unsigned key whose order is "smaller score, then
// lower index": the float's bits made monotone, above the index.  -0 is
// folded into +0 first, so scores that compare equal get equal high words.
__device__ __forceinline__ unsigned long long edge_key(float score, int e) {
  const unsigned u = __float_as_uint(score + 0.0f);
  const unsigned o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(o) << 32) |
         static_cast<unsigned>(e);
}

// The K edges of hull h nearest its support plane along n (sign > 0: the
// hull supports at its max, else at its min), as world directions in
// h.dir, nearest first.  keys: Ep entries of scratch, 16-byte aligned.
__device__ __forceinline__ void select_edges(const Hull& h,
                                             unsigned long long* keys, int V,
                                             int E, int K, float n0, float n1,
                                             float n2, float sign, int lane) {
  // support extent of the hull along n
  float s;
  if (h.cyl[0] > 0.5f) {
    const float aw[3] = {h.R[2], h.R[5], h.R[8]};
    float mn, mx;
    cyl_extent(n0, n1, n2, aw, h.p, h.cyl[1], h.cyl[2], mn, mx);
    s = sign > 0.0f ? mx : mn;
  } else {
    float loc = sign > 0.0f ? -INFINITY : INFINITY;
    for (int v = lane; v < V; v += kWarp) {
      const float4 q = h.w[v];
      const float pr = dot3(n0, n1, n2, q.x, q.y, q.z);
      loc = sign > 0.0f ? fmaxf(loc, pr) : fminf(loc, pr);
    }
    s = sign > 0.0f ? warp_max(loc) : warp_min(loc);
  }
  // score in the local frame: nloc = R^T n, pe = he . nloc + p . n
  const float* R = h.R;
  const float l0 = R[0] * n0 + R[3] * n1 + R[6] * n2;
  const float l1 = R[1] * n0 + R[4] * n1 + R[7] * n2;
  const float l2 = R[2] * n0 + R[5] * n1 + R[8] * n2;
  const float pn = dot3(h.p[0], h.p[1], h.p[2], n0, n1, n2);
  const int Ep = (E + 3) & ~3;
  for (int e = lane; e < Ep; e += kWarp) {
    float sc = INFINITY;  // a masked edge; a pad ranks after every edge
    if (e < E && h.hm[e] > 0.5f) {
      const float* q = h.he + 6 * e;
      const float pe0 = dot3(q[0], q[1], q[2], l0, l1, l2) + pn;
      const float pe1 = dot3(q[3], q[4], q[5], l0, l1, l2) + pn;
      const float d0 = sign > 0.0f ? s - pe0 : pe0 - s;
      const float d1 = sign > 0.0f ? s - pe1 : pe1 - s;
      sc = fmaxf(d0, d1);
    }
    keys[e] = edge_key(sc, e);
  }
  // a slot no edge claims (K - E.. of a small hull) stays zero
  for (int k = lane; k < 3 * K; k += kWarp) h.dir[k] = 0.0f;
  __syncwarp();
  // rank = keys below this edge's; kRankEdges edges a lane per sweep over
  // the table, two keys per 16-byte broadcast load, no branch
  const ulonglong2* keys2 = reinterpret_cast<const ulonglong2*>(keys);
  for (int e0 = 0; e0 < E; e0 += kWarp * kRankEdges) {
    int mine[kRankEdges], rank[kRankEdges];
    unsigned long long key[kRankEdges];
#pragma unroll
    for (int t = 0; t < kRankEdges; ++t) {
      mine[t] = e0 + t * kWarp + lane;
      key[t] = mine[t] < E ? keys[mine[t]] : ~0ull;
      rank[t] = 0;
    }
    for (int o = 0; o < Ep / 2; ++o) {
      const ulonglong2 k2 = keys2[o];
#pragma unroll
      for (int t = 0; t < kRankEdges; ++t)
        rank[t] += (k2.x < key[t] ? 1 : 0) + (k2.y < key[t] ? 1 : 0);
    }
#pragma unroll
    for (int t = 0; t < kRankEdges; ++t) {
      if (mine[t] < E && rank[t] < K) {
        float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
        // a finite score: the key's high word lies below that of +inf
        if ((key[t] >> 32) < 0xff800000ull) {
          const float* q = h.he + 6 * mine[t];
          const float x = q[3] - q[0], y = q[4] - q[1], z = q[5] - q[2];
          d0 = R[0] * x + R[1] * y + R[2] * z;
          d1 = R[3] * x + R[4] * y + R[5] * z;
          d2 = R[6] * x + R[7] * y + R[8] * z;
        }
        h.dir[3 * rank[t]] = d0;
        h.dir[3 * rank[t] + 1] = d1;
        h.dir[3 * rank[t] + 2] = d2;
      }
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kMaxWarps* kWarp) mtv_query_kernel(
    const float* __restrict__ wA, const float* __restrict__ wB,
    const float* __restrict__ heA, const float* __restrict__ heB,
    const float* __restrict__ hmA, const float* __restrict__ hmB,
    const float* __restrict__ nfA, const float* __restrict__ nfB,
    const float* __restrict__ fmA, const float* __restrict__ fmB,
    const float* __restrict__ RA, const float* __restrict__ RB,
    const float* __restrict__ pA, const float* __restrict__ pB,
    const float* __restrict__ cylA, const float* __restrict__ cylB,
    float* __restrict__ depth_out, float* __restrict__ n_out, int N, int V,
    int E, int F, int K, int rounds, unsigned kmagic) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const long long inst =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (inst >= N) return;  // whole warp leaves together; no block barrier

  // carve this warp's shared memory and stage both hulls: every copy is in
  // flight before the one wait
  float* ptr = smem + warp * warp_floats(V, E, F, K);
  auto stage_verts = [&](const float* src) {
    float* dst = ptr;
    ptr += 4 * V;
    const float* g = src + inst * 3 * V;
    for (int t = lane; t < 3 * V; t += kWarp)
      asynccopy::copy_f32(dst + 4 * (t / 3) + t % 3, g + t);
    return reinterpret_cast<const float4*>(dst);
  };
  auto stage = [&](const float* src, int count) {
    float* dst = ptr;
    ptr += count;
    asynccopy::copy_warp(dst, src + inst * count, count, lane);
    return dst;
  };
  Hull A, B;
  A.w = stage_verts(wA);
  B.w = stage_verts(wB);
  // the ranking's keys: 16-byte aligned (8 V floats in), 8 bytes an edge
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(ptr);
  ptr += 2 * ((E + 3) & ~3);
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
  A.dir = ptr;
  B.dir = ptr + 3 * K;
  asynccopy::wait_all();
  __syncwarp();

  // running [depth, n], the same in every lane
  float cur_d, cur_x, cur_y, cur_z;

  // ---- coarse pass: A's face normals, then B's negated
  {
    Best b;
    for (int c0 = 0; c0 < 2 * F; c0 += kWarp * kAxes) {
      int c[kAxes];
      float ux[kAxes], uy[kAxes], uz[kAxes];
      bool valid[kAxes];
#pragma unroll
      for (int t = 0; t < kAxes; ++t) {
        c[t] = c0 + t * kWarp + lane;
        ux[t] = uy[t] = uz[t] = 0.0f;
        valid[t] = false;
        if (c[t] < 2 * F) {
          const bool fromA = c[t] < F;
          const float* nf = fromA ? A.nf + 3 * c[t] : B.nf + 3 * (c[t] - F);
          const float sg = fromA ? 1.0f : -1.0f;
          valid[t] = (fromA ? A.fm[c[t]] : B.fm[c[t] - F]) > 0.5f;
          ux[t] = sg * nf[0];
          uy[t] = sg * nf[1];
          uz[t] = sg * nf[2];
        } else {
          c[t] = -1;
        }
      }
      consider(b, A, B, V, c, ux, uy, uz, valid);
    }
    pick(b, cur_d, cur_x, cur_y, cur_z);
  }

  // ---- refinement rounds
  for (int r = 0; r < rounds; ++r) {
    __syncwarp();  // the last round's reads of dir are done
    select_edges(A, keys, V, E, K, cur_x, cur_y, cur_z, 1.0f, lane);
    select_edges(B, keys, V, E, K, cur_x, cur_y, cur_z, -1.0f, lane);
    Best b;
    for (int c0 = 0; c0 < K * K; c0 += kWarp * kAxes) {
      int c[kAxes];
      float ux[kAxes], uy[kAxes], uz[kAxes];
      bool valid[kAxes];
#pragma unroll
      for (int t = 0; t < kAxes; ++t) {
        c[t] = c0 + t * kWarp + lane;
        ux[t] = uy[t] = uz[t] = 0.0f;
        valid[t] = false;
        if (c[t] < K * K) {
          const int ia = static_cast<int>(__umulhi(c[t], kmagic));
          const float* a = A.dir + 3 * ia;
          const float* d = B.dir + 3 * (c[t] - ia * K);
          const float cx = a[1] * d[2] - a[2] * d[1];
          const float cy = a[2] * d[0] - a[0] * d[2];
          const float cz = a[0] * d[1] - a[1] * d[0];
          const float crn = sqrtf(cx * cx + cy * cy + cz * cz);
          const float den = fmaxf(crn, 1e-12f);
          ux[t] = cx / den;
          uy[t] = cy / den;
          uz[t] = cz / den;
          valid[t] = crn > 1e-12f;
        } else {
          c[t] = -1;
        }
      }
      consider(b, A, B, V, c, ux, uy, uz, valid);
    }
    float d, nx, ny, nz;
    pick(b, d, nx, ny, nz);
    // strict: a tie keeps the old axis.  A round that does not improve
    // leaves n as it was, so every later round would select the same edges,
    // scan the same axes and not improve either: stop (uniform over the
    // warp).
    if (!(d < cur_d)) break;
    cur_d = d;
    cur_x = nx;
    cur_y = ny;
    cur_z = nz;
  }

  if (lane == 0) depth_out[inst] = cur_d;
  if (lane < 3)
    n_out[inst * 3 + lane] = lane == 0 ? cur_x : (lane == 1 ? cur_y : cur_z);
}

}  // namespace

// Per instance: wA/wB (V, 3), heA/heB (E, 2, 3), hmA/hmB (E,), nfA/nfB
// (F, 3), fmA/fmB (F,), RA/RB (3, 3), pA/pB (3,), cylA/cylB (3,) -> depth
// (), n (3,); every array contiguous float32 on the device with a leading
// instance axis N.  Returns the cudaError_t of the launch (0 =
// cudaSuccess); 1 for sizes the kernel does not take (the tables of one
// instance must fit 47 KB of shared memory).
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
  if (N < 0 || V < 1 || E < 1 || F < 1 || K < 1 || K > 1024 || rounds < 0)
    return 1;
  const size_t per_warp = warp_floats(V, E, F, K) * sizeof(float);
  if (per_warp > kSmemBudget) return 1;
  if (N == 0) return 0;
  int warps = static_cast<int>(kSmemBudget / per_warp);
  if (warps > kMaxWarps) warps = kMaxWarps;
  mtv_query_kernel<<<(N + warps - 1) / warps, warps * kWarp, warps * per_warp,
                     static_cast<cudaStream_t>(stream)>>>(
      wA, wB, heA, heB, hmA, hmB, nfA, nfB, fmA, fmB, RA, RB, pA, pB, cylA,
      cylB, depth, n, N, V, E, F, K, rounds,
      // ceil(2^32 / K): __umulhi(c, kmagic) == c / K for every c < K * K
      K == 1 ? 0u : 0xffffffffu / static_cast<unsigned>(K) + 1u);
  return static_cast<int>(cudaGetLastError());
}
