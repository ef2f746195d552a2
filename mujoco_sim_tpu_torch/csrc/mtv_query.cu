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
// Tables of any size.  The layout above stages every table of an instance
// in shared memory, 8 V + ~16 E + 8 F floats a warp, which holds up to
// ~160 vertices a hull in the 47 KB a block gets without an opt-in.  The
// compiler builds the exact-manifold tables from the full hulls, padded to
// the model's largest (V, E, F = 320, 954, 636 for two 256- and 320-vertex
// pebbles, 92 KB), so a second instantiation (Big) takes every table that
// does not fit:
//  * only the hot tables stay in shared memory: both hulls' vertices as
//    float4 (every axis of every pass scans them) and the selected
//    directions; the edge, edge-mask, face and face-mask tables are read
//    once an axis or once an edge a pass, straight from device memory;
//  * hulls of more than kTileV vertices are scanned tile by tile through a
//    kTileV-vertex buffer a hull (support_scan_tiled in support.cuh, on
//    the staging and scan support_minmax uses), so the shared memory of a
//    warp stays below ~57 KB whatever V (the opt-in attribute is set above
//    48 KB a block);
//  * the K nearest edges come from K passes of a warp-wide minimum over
//    the (score, index) keys above the last one taken, the scores
//    recomputed each pass: O(K E / 32) a lane where the ranking is
//    O(E^2 / 32) (E = 954: 16 x 30 scores against 954 x 30 compares), the
//    same total order, hence the same picks;
//  * a lane with no valid face on either hull and no valid edge on one of
//    them (the compaction's empty deep slots, most of the 8192) returns
//    (inf, A's first face normal) before it stages anything: the result
//    the scan would reach, since every axis is invalid and no round can
//    find a valid cross axis (both paths do this).
// Big would give the same bits on small tables too, but at the manip
// step's (V, E, F) = (24, 56, 34) it takes about twice the staged layout's
// device time on an NVIDIA H100 80GB HBM3 at 700 W (device-memory tables,
// K dependent passes: scripts/torch_mtv_regimes.py), so tables that fit
// keep the staged layout.
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
constexpr int kTileV = 1024;             // Big: vertices a hull's buffer holds

struct Hull {
  float4* w;         // V world vertices (x, y, z, unused), or a tile of tv
  const float* wg;   // V * 3 world vertices in device memory
  const float* he;   // E * 6 local edge endpoints
  const float* hm;   // E edge mask
  const float* nf;   // F * 3 world face normals
  const float* fm;   // F face mask
  const float* R;    // 9 rotation, row-major
  const float* p;    // 3 world position
  const float* cyl;  // [flag, radius, half-height]
  float* dir;        // K * 3 selected world edge directions
};

// Floats of shared memory per instance (a multiple of 4): every table
// staged.
__host__ __device__ inline int warp_floats(int V, int E, int F, int K) {
  const int Ep = (E + 3) & ~3;
  return (8 * V + 2 * Ep + 14 * E + 8 * F + 30 + 6 * K + 3) & ~3;
}

// The same for Big: two vertex buffers of tv, the poses, the directions.
__host__ __device__ inline int big_warp_floats(int tv, int K) {
  return (8 * tv + 6 * K + 30 + 3) & ~3;
}

// (min, max) of the hull along kAxes unit axes.  tv >= V: the vertices are
// staged whole; else they are scanned in tiles of tv (Big).
__device__ __forceinline__ void hull_extents(
    const Hull& h, int V, int tv, int lane, const float (&ux)[kAxes],
    const float (&uy)[kAxes], const float (&uz)[kAxes], float (&mn)[kAxes],
    float (&mx)[kAxes]) {
  if (h.cyl[0] > 0.5f) {  // uniform over the warp
    const float aw[3] = {h.R[2], h.R[5], h.R[8]};
#pragma unroll
    for (int t = 0; t < kAxes; ++t)
      cyl_extent(ux[t], uy[t], uz[t], aw, h.p, h.cyl[1], h.cyl[2], mn[t],
                 mx[t]);
  } else if (tv >= V) {
    support_scan_block<kAxes>(h.w, V, ux, uy, uz, mn, mx);
  } else {
    support_scan_tiled<kAxes>(h.w, tv, h.wg, V, lane, ux, uy, uz, mn, mx);
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
    Best& b, const Hull& A, const Hull& B, int V, int tv, int lane,
    const int (&c)[kAxes], const float (&ux)[kAxes],
    const float (&uy)[kAxes], const float (&uz)[kAxes],
    const bool (&valid)[kAxes]) {
  float mnA[kAxes], mxA[kAxes], mnB[kAxes], mxB[kAxes];
  hull_extents(A, V, tv, lane, ux, uy, uz, mnA, mxA);
  hull_extents(B, V, tv, lane, ux, uy, uz, mnB, mxB);
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

// Support plane offset of hull h along n: its max (sign > 0) or min of
// n . vertex, or the cylinder's analytic extent.  tv >= V: from the staged
// vertices; else from the rows in device memory.
__device__ __forceinline__ float support_plane(const Hull& h, int V, int tv,
                                               float n0, float n1, float n2,
                                               float sign, int lane) {
  if (h.cyl[0] > 0.5f) {
    const float aw[3] = {h.R[2], h.R[5], h.R[8]};
    float mn, mx;
    cyl_extent(n0, n1, n2, aw, h.p, h.cyl[1], h.cyl[2], mn, mx);
    return sign > 0.0f ? mx : mn;
  }
  float loc = sign > 0.0f ? -INFINITY : INFINITY;
  for (int v = lane; v < V; v += kWarp) {
    float pr;
    if (tv >= V) {
      const float4 q = h.w[v];
      pr = dot3(n0, n1, n2, q.x, q.y, q.z);
    } else {
      const float* q = h.wg + 3 * v;
      pr = dot3(n0, n1, n2, q[0], q[1], q[2]);
    }
    loc = sign > 0.0f ? fmaxf(loc, pr) : fminf(loc, pr);
  }
  return sign > 0.0f ? warp_max(loc) : warp_min(loc);
}

// What scores an edge against the support plane s along n, in the hull's
// local frame: nloc = R^T n, pe = he . nloc + p . n.
struct EdgeScore {
  float l0, l1, l2, pn, s, sign;
  __device__ __forceinline__ EdgeScore(const Hull& h, float n0, float n1,
                                       float n2, float s_, float sign_) {
    const float* R = h.R;
    l0 = R[0] * n0 + R[3] * n1 + R[6] * n2;
    l1 = R[1] * n0 + R[4] * n1 + R[7] * n2;
    l2 = R[2] * n0 + R[5] * n1 + R[8] * n2;
    pn = dot3(h.p[0], h.p[1], h.p[2], n0, n1, n2);
    s = s_;
    sign = sign_;
  }
  // the farther endpoint's distance behind the plane; +inf for a masked
  // edge
  __device__ __forceinline__ float operator()(const Hull& h, int e) const {
    if (!(h.hm[e] > 0.5f)) return INFINITY;
    const float* q = h.he + 6 * e;
    const float pe0 = dot3(q[0], q[1], q[2], l0, l1, l2) + pn;
    const float pe1 = dot3(q[3], q[4], q[5], l0, l1, l2) + pn;
    const float d0 = sign > 0.0f ? s - pe0 : pe0 - s;
    const float d1 = sign > 0.0f ? s - pe1 : pe1 - s;
    return fmaxf(d0, d1);
  }
};

// World direction of edge e (local endpoints rotated by R).
__device__ __forceinline__ void edge_dir(const Hull& h, int e, float* out) {
  const float* R = h.R;
  const float* q = h.he + 6 * e;
  const float x = q[3] - q[0], y = q[4] - q[1], z = q[5] - q[2];
  out[0] = R[0] * x + R[1] * y + R[2] * z;
  out[1] = R[3] * x + R[4] * y + R[5] * z;
  out[2] = R[6] * x + R[7] * y + R[8] * z;
}

// A key's score is finite: its high word lies below that of +inf.
__device__ __forceinline__ bool finite_key(unsigned long long key) {
  return (key >> 32) < 0xff800000ull;
}

// The K edges of hull h nearest its support plane along n (sign > 0: the
// hull supports at its max, else at its min), as world directions in
// h.dir, nearest first, by ranking: an edge's rank is the number of keys
// below its own.  keys: Ep entries of scratch, 16-byte aligned.
__device__ __forceinline__ void select_edges_rank(
    const Hull& h, unsigned long long* keys, int V, int E, int K, float n0,
    float n1, float n2, float sign, int lane) {
  const EdgeScore score(h, n0, n1, n2,
                        support_plane(h, V, V, n0, n1, n2, sign, lane), sign);
  const int Ep = (E + 3) & ~3;
  for (int e = lane; e < Ep; e += kWarp)  // a pad ranks after every edge
    keys[e] = edge_key(e < E ? score(h, e) : INFINITY, e);
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
        float d[3] = {0.0f, 0.0f, 0.0f};
        if (finite_key(key[t])) edge_dir(h, mine[t], d);
        h.dir[3 * rank[t]] = d[0];
        h.dir[3 * rank[t] + 1] = d[1];
        h.dir[3 * rank[t] + 2] = d[2];
      }
    }
  }
  __syncwarp();
}

__device__ __forceinline__ unsigned long long warp_min_u64(
    unsigned long long v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// The same selection for tables of any size (Big): pass r takes the
// smallest key above pass r - 1's, one warp-wide minimum a pass over
// scores recomputed from the tables in device memory.  The first key with
// no finite score ends it: that slot and every later one stay zero, as
// the ranking leaves them.
__device__ __forceinline__ void select_edges_passes(const Hull& h, int V,
                                                    int tv, int E, int K,
                                                    float n0, float n1,
                                                    float n2, float sign,
                                                    int lane) {
  const EdgeScore score(h, n0, n1, n2,
                        support_plane(h, V, tv, n0, n1, n2, sign, lane), sign);
  for (int k = lane; k < 3 * K; k += kWarp) h.dir[k] = 0.0f;
  __syncwarp();
  const int kk = K < E ? K : E;
  unsigned long long last = 0;
  for (int r = 0; r < kk; ++r) {
    unsigned long long best = ~0ull;
    for (int e = lane; e < E; e += kWarp) {
      const unsigned long long key = edge_key(score(h, e), e);
      if ((r == 0 || key > last) && key < best) best = key;
    }
    best = warp_min_u64(best);
    if (!finite_key(best)) break;  // uniform over the warp
    last = best;
    if (lane == 0) edge_dir(h, static_cast<int>(best & 0xffffffffu),
                            h.dir + 3 * r);
  }
  __syncwarp();
}

// A lane whose faces are all masked on both hulls and whose edges are all
// masked on one of them (an empty deep slot: every table zero) has no valid
// axis at all: the coarse pick is the first axis, A's first face normal, at
// depth +inf, and no round finds a valid cross axis (one hull's directions
// are all zero).  True for every lane of the warp or for none.
__device__ __forceinline__ bool no_valid_axis(
    const float* fmA, const float* fmB, const float* hmA, const float* hmB,
    int E, int F, int lane) {
  bool face = false;
  for (int f = lane; f < F; f += kWarp)
    face |= (fmA[f] > 0.5f) | (fmB[f] > 0.5f);
  if (__any_sync(kFull, face)) return false;
  bool edgeA = false, edgeB = false;
  for (int e = lane; e < E; e += kWarp) {
    edgeA |= hmA[e] > 0.5f;
    edgeB |= hmB[e] > 0.5f;
  }
  return !__any_sync(kFull, edgeA) || !__any_sync(kFull, edgeB);
}

template <bool kBig>
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
    int E, int F, int K, int rounds, int tv, unsigned kmagic) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const long long inst =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (inst >= N) return;  // whole warp leaves together; no block barrier

  if (no_valid_axis(fmA + inst * F, fmB + inst * F, hmA + inst * E,
                    hmB + inst * E, E, F, lane)) {
    if (lane == 0) depth_out[inst] = INFINITY;
    if (lane < 3) n_out[inst * 3 + lane] = nfA[inst * 3 * F + lane];
    return;
  }

  // carve this warp's shared memory and stage both hulls: every copy is in
  // flight before the one wait
  float* ptr = smem + warp * (kBig ? big_warp_floats(tv, K)
                                   : warp_floats(V, E, F, K));
  Hull A, B;
  A.wg = wA + inst * 3 * V;
  B.wg = wB + inst * 3 * V;
  auto stage_verts = [&](const float* src) {
    float4* dst = reinterpret_cast<float4*>(ptr);
    ptr += 4 * tv;
    if (tv >= V) stage_rows_f4(dst, src, V, lane, kWarp);
    return dst;
  };
  auto stage = [&](const float* src, int count) {
    float* dst = ptr;
    ptr += count;
    asynccopy::copy_warp(dst, src + inst * count, count, lane);
    return dst;
  };
  A.w = stage_verts(A.wg);
  B.w = stage_verts(B.wg);
  unsigned long long* keys = nullptr;
  if (kBig) {
    // the cold tables stay in device memory
    A.he = heA + inst * 6 * E;
    B.he = heB + inst * 6 * E;
    A.hm = hmA + inst * E;
    B.hm = hmB + inst * E;
    A.nf = nfA + inst * 3 * F;
    B.nf = nfB + inst * 3 * F;
    A.fm = fmA + inst * F;
    B.fm = fmB + inst * F;
  } else {
    // the ranking's keys: 16-byte aligned (8 V floats in), 8 bytes an edge
    keys = reinterpret_cast<unsigned long long*>(ptr);
    ptr += 2 * ((E + 3) & ~3);
    A.he = stage(heA, 6 * E);
    B.he = stage(heB, 6 * E);
    A.hm = stage(hmA, E);
    B.hm = stage(hmB, E);
    A.nf = stage(nfA, 3 * F);
    B.nf = stage(nfB, 3 * F);
    A.fm = stage(fmA, F);
    B.fm = stage(fmB, F);
  }
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
      consider(b, A, B, V, tv, lane, c, ux, uy, uz, valid);
    }
    pick(b, cur_d, cur_x, cur_y, cur_z);
  }

  // ---- refinement rounds
  for (int r = 0; r < rounds; ++r) {
    __syncwarp();  // the last round's reads of dir are done
    if (kBig) {
      select_edges_passes(A, V, tv, E, K, cur_x, cur_y, cur_z, 1.0f, lane);
      select_edges_passes(B, V, tv, E, K, cur_x, cur_y, cur_z, -1.0f, lane);
    } else {
      select_edges_rank(A, keys, V, E, K, cur_x, cur_y, cur_z, 1.0f, lane);
      select_edges_rank(B, keys, V, E, K, cur_x, cur_y, cur_z, -1.0f, lane);
    }
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
      consider(b, A, B, V, tv, lane, c, ux, uy, uz, valid);
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
// instance axis N.  Any table size: one instance's tables in the 47 KB of
// shared memory a block gets without an opt-in take the all-staged kernel,
// larger ones the Big kernel.  Returns the cudaError_t of the launch (0 =
// cudaSuccess); 1 for K outside 1..1024, negative rounds or empty tables.
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
  if (N == 0) return 0;
  const bool big = warp_floats(V, E, F, K) * sizeof(float) > kSmemBudget;
  const int tv = big && V > kTileV ? kTileV : V;
  const size_t per_warp =
      (big ? big_warp_floats(tv, K) : warp_floats(V, E, F, K)) *
      sizeof(float);
  int warps = static_cast<int>(kSmemBudget / per_warp);
  if (warps > kMaxWarps) warps = kMaxWarps;
  if (warps < 1) warps = 1;
  const size_t smem = warps * per_warp;
  const auto kernel = big ? mtv_query_kernel<true> : mtv_query_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<(N + warps - 1) / warps, warps * kWarp, smem,
           static_cast<cudaStream_t>(stream)>>>(
      wA, wB, heA, heB, hmA, hmB, nfA, nfB, fmA, fmB, RA, RB, pA, pB, cylA,
      cylB, depth, n, N, V, E, F, K, rounds, tv,
      // ceil(2^32 / K): __umulhi(c, kmagic) == c / K for every c < K * K
      K == 1 ? 0u : 0xffffffffu / static_cast<unsigned>(K) + 1u);
  return static_cast<int>(cudaGetLastError());
}
