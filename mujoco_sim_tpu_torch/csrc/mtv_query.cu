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
// Large tables (Big).  The layout above stages every table of an instance
// in one warp's share of the 47 KB a block gets without an opt-in, which
// holds up to ~160 vertices a hull.  The compiler builds the exact-manifold
// tables from the full hulls, padded to the model's largest (V, E, F =
// 320, 954, 636 for two 256- and 320-vertex pebbles, 92 KB), and those
// take mtv_query_block_kernel: one block of kBlockWarps = 8 warps an
// instance.  What bounds it there depends on how many lanes are live.  The
// deep-pair compaction hands the query 8192 slots of which a step fills a
// handful (7 at the bighull scene's captured step): then each live
// instance is a chain of ~1.4 M axis-vertex products while the rest of
// the card only reads the empty slots' masks (~75 MB, bound by bytes), and
// the time is the live chain's issue latency on its SM.  With every lane
// live it is operations, as above.  A warp an instance (the first
// large-table design) ran the chain on one warp, took the K nearest edges
// in K dependent warp-wide passes over E edges read from device memory,
// and checked the empty slots one dependent load after another.  What
// this design does about it:
//  * the block stages its instance's tables once into dynamic shared
//    memory, hottest first, each where it fits half the card's opt-in
//    limit (two blocks an SM): both hulls' vertices as float4, the edge
//    tables, the face tables; what does not fit (the 1200-vertex pebble's
//    edges and faces) is read from device memory.  A hull's trailing rows
//    that repeat its first vertex (the compiler's padding) are not
//    scanned: they move neither extreme;
//  * a scan pass takes kChunk = 256 axes: four warps scan hull A and four
//    hull B, kBlockAxes = 2 axes a lane per 16-byte broadcast vertex load,
//    four vertices an iteration, and write each axis's (min, max) to
//    shared memory; after a barrier a thread an axis folds the gap into its
//    running best, and the block's first minimum by axis index comes from
//    one shuffle reduction a warp and one read of the eight warps' (depth,
//    axis) in shared memory, so the picks are the twin's, bit for bit
//    where the warp layout's were;
//  * the K nearest edges: each warp takes a quarter of one hull's edges,
//    keys them once (in registers, up to 256 a warp, else in shared
//    memory) and finds its K smallest (score, index) keys in K warp-wide
//    minimum passes; the 4 K candidates of a hull are then ranked by a
//    thread each, and rank r < K writes direction r.  Every key of the
//    hull's K smallest is among the candidates, and so is every key below
//    it, so the ranks are the hull's own: the twin's total order, the same
//    picks;
//  * as many blocks as the card holds take turns of 8 instances from
//    counters the wrapper zeroes, in an order that scatters neighbouring
//    slots: first a probe of each instance's first face masks, so a live
//    instance is solved within microseconds of the launch on a block of
//    its own, then the empty-slot checks, their masks staged into shared
//    memory with every copy in flight at once, on whichever blocks are
//    free; a round that finds no better axis ends the instance, as above.
// The block layout gives the same bits on small tables too, but at the
// manip step's (V, E, F) = (24, 56, 34) with thousands of live lanes the
// warp layout keeps more instances on each SM, so tables that fit keep it
// (scripts/torch_mtv_regimes.py times the two side by side).
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
constexpr int kBlockWarps = 8;           // Big: warps an instance
constexpr int kHullWarps = kBlockWarps / 2;  // Big: warps a hull's scan
constexpr int kBlockAxes = 2;            // Big: axes a lane per vertex load
constexpr int kChunk = kHullWarps * kWarp * kBlockAxes;  // Big: axes a pass
constexpr int kBlockThreads = kBlockWarps * kWarp;
constexpr int kKeysLane = 8;             // Big: edge keys a lane holds
static_assert(kChunk == kBlockThreads, "a thread folds one axis a pass");

struct Hull {
  float4* w;         // V world vertices (x, y, z, unused), or null
  const float* wg;   // V * 3 world vertices in device memory
  const float* he;   // E * 6 local edge endpoints
  const float* hm;   // E edge mask
  const float* nf;   // F * 3 world face normals
  const float* fm;   // F face mask
  const float* R;    // 9 rotation, row-major
  const float* p;    // 3 world position
  const float* cyl;  // [flag, radius, half-height]
  float* dir;        // K * 3 selected world edge directions
  int nv;            // block layout: the vertices its scans take (<= V)
};

// Floats of shared memory per instance (a multiple of 4): every table
// staged.
__host__ __device__ inline int warp_floats(int V, int E, int F, int K) {
  const int Ep = (E + 3) & ~3;
  return (8 * V + 2 * Ep + 14 * E + 8 * F + 30 + 6 * K + 3) & ~3;
}

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// (min, max) of the hull along kAxes unit axes, over the staged vertices.
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

// n . vertex v of hull h, from the staged vertices or the rows in device
// memory.
__device__ __forceinline__ float vertex_dot(const Hull& h, int v, float n0,
                                            float n1, float n2) {
  if (h.w != nullptr) {
    const float4 q = h.w[v];
    return dot3(n0, n1, n2, q.x, q.y, q.z);
  }
  const float* q = h.wg + 3 * v;
  return dot3(n0, n1, n2, __ldg(q), __ldg(q + 1), __ldg(q + 2));
}

// The analytic support plane of a cylinder-flagged hull along n: its max
// (sign > 0) or min.
__device__ __forceinline__ float cyl_plane(const Hull& h, float n0, float n1,
                                           float n2, float sign) {
  const float aw[3] = {h.R[2], h.R[5], h.R[8]};
  float mn, mx;
  cyl_extent(n0, n1, n2, aw, h.p, h.cyl[1], h.cyl[2], mn, mx);
  return sign > 0.0f ? mx : mn;
}

// Support plane offset of hull h along n over a warp: its max (sign > 0)
// or min of n . vertex, or the cylinder's analytic extent.
__device__ __forceinline__ float support_plane(const Hull& h, int V,
                                               float n0, float n1, float n2,
                                               float sign, int lane) {
  if (h.cyl[0] > 0.5f) return cyl_plane(h, n0, n1, n2, sign);
  float loc = sign > 0.0f ? -INFINITY : INFINITY;
  for (int v = lane; v < V; v += kWarp) {
    const float pr = vertex_dot(h, v, n0, n1, n2);
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
                        support_plane(h, V, n0, n1, n2, sign, lane), sign);
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

// The staged layout: one warp an instance, every table in shared memory.
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

  if (no_valid_axis(fmA + inst * F, fmB + inst * F, hmA + inst * E,
                    hmB + inst * E, E, F, lane)) {
    if (lane == 0) depth_out[inst] = INFINITY;
    if (lane < 3) n_out[inst * 3 + lane] = nfA[inst * 3 * F + lane];
    return;
  }

  // carve this warp's shared memory and stage both hulls: every copy is in
  // flight before the one wait
  float* ptr = smem + warp * warp_floats(V, E, F, K);
  Hull A, B;
  A.wg = wA + inst * 3 * V;
  B.wg = wB + inst * 3 * V;
  auto stage_verts = [&](const float* src) {
    float4* dst = reinterpret_cast<float4*>(ptr);
    ptr += 4 * V;
    stage_rows_f4(dst, src, V, lane, kWarp);
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
    select_edges_rank(A, keys, V, E, K, cur_x, cur_y, cur_z, 1.0f, lane);
    select_edges_rank(B, keys, V, E, K, cur_x, cur_y, cur_z, -1.0f, lane);
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

// ---- the block layout (Big) ----------------------------------------------

// Which of an instance's tables the block layout stages (the rest is read
// from device memory), and the floats of shared memory that takes.
struct BlockPlan {
  bool verts, keys, edges, faces;
  int floats;
};

// The block layout's scratch, in floats: the poses, the directions, a
// pass's (min, max) of both hulls, the edge candidates (8-byte keys), the
// reductions' slots.
__host__ __device__ inline int block_scratch_floats(int K) {
  return 32 + round4(6 * K) + 4 * kChunk + 4 * kHullWarps * K +
         4 * kBlockWarps;
}

// What fits `budget` bytes, hottest first: the vertices (every axis of
// every pass scans them), the edge keys (read K times a round; only past
// the E that the lanes' registers hold), the edge tables, the face tables.
inline BlockPlan block_plan(int V, int E, int F, int K, int budget) {
  BlockPlan plan{false, false, false, false, block_scratch_floats(K)};
  auto take = [&](int floats) {
    if (static_cast<size_t>(plan.floats + floats) * sizeof(float) >
        static_cast<size_t>(budget))
      return false;
    plan.floats += floats;
    return true;
  };
  plan.verts = take(8 * V);
  plan.keys = E > kKeysLane * kWarp * kHullWarps && take(4 * round4(E));
  plan.edges = take(2 * round4(6 * E) + 2 * round4(E));
  plan.faces = take(2 * round4(3 * F) + 2 * round4(F));
  return plan;
}

// Issue the copy of `count` contiguous floats over the block's threads:
// 16 bytes a copy where count and both addresses allow it, else 4.
__device__ __forceinline__ void copy_block(float* dst_shared,
                                           const float* src_global,
                                           int count) {
  const bool wide =
      count % 4 == 0 &&
      (reinterpret_cast<unsigned long long>(src_global) % 16 == 0) &&
      (__cvta_generic_to_shared(dst_shared) % 16 == 0);
  if (wide) {  // uniform over the block
    for (int t = 4 * threadIdx.x; t < count; t += 4 * blockDim.x)
      asynccopy::copy_f32x4(dst_shared + t, src_global + t);
  } else {
    for (int t = threadIdx.x; t < count; t += blockDim.x)
      asynccopy::copy_f32(dst_shared + t, src_global + t);
  }
}

// (min, max) of hull h along kBlockAxes axes: the cylinder's analytic
// extent, or the scan of its first h.nv vertices (staged, or rows in
// device memory).  h is a copy (a reference picked at run time would put
// both hulls in local memory).
__device__ __forceinline__ void block_extents(
    const Hull h, const float (&ux)[kBlockAxes],
    const float (&uy)[kBlockAxes], const float (&uz)[kBlockAxes],
    float (&mn)[kBlockAxes], float (&mx)[kBlockAxes]) {
  if (h.cyl[0] > 0.5f) {  // uniform over the block
    const float aw[3] = {h.R[2], h.R[5], h.R[8]};
#pragma unroll
    for (int t = 0; t < kBlockAxes; ++t)
      cyl_extent(ux[t], uy[t], uz[t], aw, h.p, h.cyl[1], h.cyl[2], mn[t],
                 mx[t]);
  } else if (h.w != nullptr) {
    // support_scan_block's arithmetic, four vertices an iteration: the
    // loads of an iteration go out together and 4 kBlockAxes products
    // hide each other's latency (one hull's scan is a block's whole work
    // between two barriers)
    scan_init(mn, mx);
    int v = 0;
    for (; v + 4 <= h.nv; v += 4) {
      float4 q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] = h.w[v + j];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int t = 0; t < kBlockAxes; ++t) {
          const float pr = dot3(ux[t], uy[t], uz[t], q[j].x, q[j].y, q[j].z);
          mn[t] = fminf(mn[t], pr);
          mx[t] = fmaxf(mx[t], pr);
        }
    }
    for (; v < h.nv; ++v) {
      const float4 q = h.w[v];
#pragma unroll
      for (int t = 0; t < kBlockAxes; ++t) {
        const float pr = dot3(ux[t], uy[t], uz[t], q.x, q.y, q.z);
        mn[t] = fminf(mn[t], pr);
        mx[t] = fmaxf(mx[t], pr);
      }
    }
  } else {
    scan_init(mn, mx);
    for (int v = 0; v < h.nv; ++v) {
      const float* q = h.wg + 3 * v;
      const float qx = __ldg(q), qy = __ldg(q + 1), qz = __ldg(q + 2);
#pragma unroll
      for (int t = 0; t < kBlockAxes; ++t) {
        const float pr = dot3(ux[t], uy[t], uz[t], qx, qy, qz);
        mn[t] = fminf(mn[t], pr);
        mx[t] = fmaxf(mx[t], pr);
      }
    }
  }
}

// Whether vertex v of hull h differs from its vertex 0 in any bit.
__device__ __forceinline__ bool differs_from_first(const Hull& h, int v) {
  float x, y, z, x0, y0, z0;
  if (h.w != nullptr) {
    const float4 q = h.w[v], q0 = h.w[0];
    x = q.x, y = q.y, z = q.z, x0 = q0.x, y0 = q0.y, z0 = q0.z;
  } else {
    const float* q = h.wg + 3 * v;
    x = __ldg(q), y = __ldg(q + 1), z = __ldg(q + 2);
    x0 = __ldg(h.wg), y0 = __ldg(h.wg + 1), z0 = __ldg(h.wg + 2);
  }
  return (__float_as_uint(x) != __float_as_uint(x0)) |
         (__float_as_uint(y) != __float_as_uint(y0)) |
         (__float_as_uint(z) != __float_as_uint(z0));
}

// The axes of a coarse pass: A's face normals, then B's negated; axis c's
// unit vector (x, y, z) and whether its face is valid (w: 1 or 0).
struct CoarseAxes {
  const float *nfA, *nfB, *fmA, *fmB;
  int F;
  __device__ __forceinline__ float4 operator()(int c) const {
    const bool fromA = c < F;
    const float* nf = fromA ? nfA + 3 * c : nfB + 3 * (c - F);
    const float sg = fromA ? 1.0f : -1.0f;
    const bool valid = (fromA ? fmA[c] : fmB[c - F]) > 0.5f;
    return make_float4(sg * nf[0], sg * nf[1], sg * nf[2],
                       valid ? 1.0f : 0.0f);
  }
};

// The axes of a refinement pass: the normalised cross product of A's
// direction c / K and B's direction c % K, valid where its norm is above
// 1e-12.
struct CrossAxes {
  const float *dA, *dB;
  int K;
  unsigned kmagic;
  __device__ __forceinline__ float4 operator()(int c) const {
    const int ia = static_cast<int>(__umulhi(c, kmagic));
    const float* a = dA + 3 * ia;
    const float* d = dB + 3 * (c - ia * K);
    const float cx = a[1] * d[2] - a[2] * d[1];
    const float cy = a[2] * d[0] - a[0] * d[2];
    const float cz = a[0] * d[1] - a[1] * d[0];
    const float crn = sqrtf(cx * cx + cy * cy + cz * cz);
    const float den = fmaxf(crn, 1e-12f);
    return make_float4(cx / den, cy / den, cz / den,
                       crn > 1e-12f ? 1.0f : 0.0f);
  }
};

// A thread's running best of a pass: gap, axis index, sign of the normal.
struct BlockBest {
  float v = INFINITY;
  int c = INT_MAX;
  float s = 1.0f;
};

// Where the block layout keeps its scratch.
struct BlockScratch {
  float* ext;                // kChunk x {A, B} x {min, max}
  unsigned long long* cand;  // 2 hulls x kHullWarps x K edge keys
  unsigned long long* keys;  // 2 hulls x round4(E) edge keys, or null
  float* red;                // 4 kBlockWarps floats of reductions
};

// One pass over `count` axes: kChunk axes at a time, warps 0..3 scan hull
// A and 4..7 hull B, then thread t folds axis c0 + t; the block's first
// minimum by axis index, as (depth, axis, sign) in every thread.  Every
// thread of the block calls it.
template <typename Axes>
__device__ __forceinline__ BlockBest block_pass(const Hull& A, const Hull& B,
                                                int count,
                                                const BlockScratch& sc,
                                                const Axes& axis) {
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int side = warp / kHullWarps, sub = warp % kHullWarps;
  const Hull h = side == 0 ? A : B;
  BlockBest b;
  for (int c0 = 0; c0 < count; c0 += kChunk) {
    float ux[kBlockAxes], uy[kBlockAxes], uz[kBlockAxes];
    float mn[kBlockAxes], mx[kBlockAxes];
    int slot[kBlockAxes];
#pragma unroll
    for (int t = 0; t < kBlockAxes; ++t) {
      slot[t] = (sub * kBlockAxes + t) * kWarp + lane;
      const float4 u = c0 + slot[t] < count ? axis(c0 + slot[t])
                                            : make_float4(0.f, 0.f, 0.f, 0.f);
      ux[t] = u.x;
      uy[t] = u.y;
      uz[t] = u.z;
    }
    block_extents(h, ux, uy, uz, mn, mx);
#pragma unroll
    for (int t = 0; t < kBlockAxes; ++t) {
      sc.ext[4 * slot[t] + 2 * side] = mn[t];
      sc.ext[4 * slot[t] + 2 * side + 1] = mx[t];
    }
    __syncthreads();
    const int c = c0 + tid;
    if (c < count) {
      const bool valid = axis(c).w > 0.5f;
      const float4 e = reinterpret_cast<const float4*>(sc.ext)[tid];
      const float fwd = e.y - e.z;  // max_A - min_B: along +u
      const float rev = e.w - e.x;  // max_B - min_A: along -u
      const float comb = valid ? fminf(fwd, rev) : INFINITY;
      if (less_vi(comb, c, b.v, b.c)) {
        b.v = comb;
        b.c = c;
        b.s = (!valid || fwd <= rev) ? 1.0f : -1.0f;
      }
    }
    __syncthreads();  // ext is written again by the next chunk
  }
  // the block's first minimum: a shuffle reduction a warp, then the eight
  // warps' winners from shared memory, folded in the same order by all
  float v = b.v;
  int c = b.c;
  warp_argmin(v, c);
  const unsigned own = __ballot_sync(kFull, c != INT_MAX && b.c == c);
  const float s = __shfl_sync(kFull, b.s, own ? __ffs(own) - 1 : 0);
  if (lane == 0) {
    sc.red[3 * warp] = v;
    sc.red[3 * warp + 1] = __int_as_float(c);
    sc.red[3 * warp + 2] = s;
  }
  __syncthreads();
  BlockBest out;
  for (int w = 0; w < kBlockWarps; ++w) {
    const float wv = sc.red[3 * w];
    const int wc = __float_as_int(sc.red[3 * w + 1]);
    if (less_vi(wv, wc, out.v, out.c)) {
      out.v = wv;
      out.c = wc;
      out.s = sc.red[3 * w + 2];
    }
  }
  __syncthreads();  // red is written again by the next reduction
  return out;
}

// The support planes of both hulls along n over the block: A's max, B's
// min.
__device__ __forceinline__ void block_planes(const Hull& A, const Hull& B,
                                             float n0, float n1, float n2,
                                             const BlockScratch& sc,
                                             float& sA, float& sB) {
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  float a = -INFINITY, b = INFINITY;
  for (int v = tid; v < A.nv; v += blockDim.x)
    a = fmaxf(a, vertex_dot(A, v, n0, n1, n2));
  for (int v = tid; v < B.nv; v += blockDim.x)
    b = fminf(b, vertex_dot(B, v, n0, n1, n2));
  a = warp_max(a);
  b = warp_min(b);
  if (lane == 0) {
    sc.red[2 * warp] = a;
    sc.red[2 * warp + 1] = b;
  }
  __syncthreads();
  sA = -INFINITY;
  sB = INFINITY;
  for (int w = 0; w < kBlockWarps; ++w) {
    sA = fmaxf(sA, sc.red[2 * w]);
    sB = fminf(sB, sc.red[2 * w + 1]);
  }
  if (A.cyl[0] > 0.5f) sA = cyl_plane(A, n0, n1, n2, 1.0f);
  if (B.cyl[0] > 0.5f) sB = cyl_plane(B, n0, n1, n2, -1.0f);
  __syncthreads();  // red is written again by the next reduction
}

__device__ __forceinline__ unsigned long long warp_min_u64(
    unsigned long long v) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// The K edges of both hulls nearest their support planes along n, as world
// directions in A.dir and B.dir, nearest first.  Warp w takes a quarter of
// hull w / 4's edges, keys them once (into shared memory where the plan
// holds the keys, else a pass keys them again), and writes its K smallest
// (score, index) keys, in order, by K warp-wide minimum passes above the
// last key taken; then a thread a candidate counts the hull's candidates
// below its key, and rank r < K writes direction r (zeros for a key with no
// finite score).
__device__ __forceinline__ void block_select(const Hull& A, const Hull& B,
                                             int E, int K, float n0,
                                             float n1, float n2,
                                             const BlockScratch& sc) {
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  float sA, sB;
  block_planes(A, B, n0, n1, n2, sc, sA, sB);
  for (int k = tid; k < 6 * K; k += blockDim.x) A.dir[k] = 0.0f;  // A, B
  const int side = warp / kHullWarps, sub = warp % kHullWarps;
  const Hull h = side == 0 ? A : B;
  const EdgeScore score(h, n0, n1, n2, side == 0 ? sA : sB,
                        side == 0 ? 1.0f : -1.0f);
  const int per = (E + kHullWarps - 1) / kHullWarps;
  const int e0 = sub * per, e1 = min(E, e0 + per);
  // a lane's keys in registers where a warp's quarter fits them (E up to
  // kKeysLane kWarp kHullWarps), else in shared memory where the plan
  // holds them, else keyed again each pass
  const bool in_regs = e1 - e0 <= kKeysLane * kWarp;  // uniform over the warp
  unsigned long long reg[kKeysLane];
  unsigned long long* keys =
      sc.keys == nullptr ? nullptr : sc.keys + side * round4(E);
  if (in_regs) {
#pragma unroll
    for (int u = 0; u < kKeysLane; ++u) {
      const int e = e0 + u * kWarp + lane;
      reg[u] = e < e1 ? edge_key(score(h, e), e) : ~0ull;
    }
  } else if (keys != nullptr) {
    for (int e = e0 + lane; e < e1; e += kWarp)
      keys[e] = edge_key(score(h, e), e);
    __syncwarp();  // a warp reads only the keys it wrote
  }
  unsigned long long* out = sc.cand + (side * kHullWarps + sub) * K;
  unsigned long long last = 0;
  int k = 0;
  for (; k < K; ++k) {
    unsigned long long best = ~0ull;
    if (in_regs) {
#pragma unroll
      for (int u = 0; u < kKeysLane; ++u)
        if ((k == 0 || reg[u] > last) && reg[u] < best) best = reg[u];
    } else {
      for (int e = e0 + lane; e < e1; e += kWarp) {
        const unsigned long long key =
            keys != nullptr ? keys[e] : edge_key(score(h, e), e);
        if ((k == 0 || key > last) && key < best) best = key;
      }
    }
    best = warp_min_u64(best);
    if (lane == 0) out[k] = best;
    if (!finite_key(best)) break;  // uniform over the warp
    last = best;
  }
  for (int r = k + 1 + lane; r < K; r += kWarp) out[r] = ~0ull;
  __syncthreads();
  const int per_hull = kHullWarps * K;
  for (int t = tid; t < 2 * per_hull; t += blockDim.x) {
    const unsigned long long key = sc.cand[t];
    const unsigned long long* all = sc.cand + (t / per_hull) * per_hull;
    int rank = 0;
#pragma unroll 8
    for (int j = 0; j < per_hull; ++j) rank += all[j] < key ? 1 : 0;
    if (rank < K && finite_key(key)) {
      const Hull g = t < per_hull ? A : B;
      edge_dir(g, static_cast<int>(key & 0xffffffffu), g.dir + 3 * rank);
    }
  }
  __syncthreads();
}

// The query of one live instance by the whole block: stage what `plan`
// holds, the coarse pass, the rounds; writes depth_out[inst] and
// n_out[inst].
__device__ __forceinline__ void block_instance(
    const float* __restrict__ wA, const float* __restrict__ wB,
    const float* __restrict__ heA, const float* __restrict__ heB,
    const float* __restrict__ hmA, const float* __restrict__ hmB,
    const float* __restrict__ nfA, const float* __restrict__ nfB,
    const float* __restrict__ fmA, const float* __restrict__ fmB,
    const float* __restrict__ RA, const float* __restrict__ RB,
    const float* __restrict__ pA, const float* __restrict__ pB,
    const float* __restrict__ cylA, const float* __restrict__ cylB,
    float* __restrict__ depth_out, float* __restrict__ n_out, int V, int E,
    int F, int K, int rounds, unsigned kmagic, const BlockPlan& plan,
    float* smem, long long inst) {
  const int tid = threadIdx.x;
  // every copy in flight before the one wait
  float* ptr = smem;
  auto stage = [&](const float* src, int count, bool in_smem) {
    const float* g = src + inst * count;
    if (!in_smem) return g;
    float* dst = ptr;
    ptr += round4(count);
    copy_block(dst, g, count);
    return static_cast<const float*>(dst);
  };
  Hull A, B;
  A.wg = wA + inst * 3 * V;
  B.wg = wB + inst * 3 * V;
  A.w = B.w = nullptr;
  if (plan.verts) {
    A.w = reinterpret_cast<float4*>(ptr);
    B.w = A.w + V;
    ptr += 8 * V;
    stage_rows_f4(A.w, A.wg, V, tid, blockDim.x);
    stage_rows_f4(B.w, B.wg, V, tid, blockDim.x);
  }
  BlockScratch sc;
  sc.keys = nullptr;
  if (plan.keys) {
    sc.keys = reinterpret_cast<unsigned long long*>(ptr);
    ptr += 4 * round4(E);
  }
  A.he = stage(heA, 6 * E, plan.edges);
  B.he = stage(heB, 6 * E, plan.edges);
  A.hm = stage(hmA, E, plan.edges);
  B.hm = stage(hmB, E, plan.edges);
  A.nf = stage(nfA, 3 * F, plan.faces);
  B.nf = stage(nfB, 3 * F, plan.faces);
  A.fm = stage(fmA, F, plan.faces);
  B.fm = stage(fmB, F, plan.faces);
  // the poses, 30 floats in 32: R, R, p, p, cyl, cyl
  for (int t = tid; t < 30; t += blockDim.x) {
    const float* src =
        t < 9    ? RA + inst * 9 + t
        : t < 18 ? RB + inst * 9 + (t - 9)
        : t < 21 ? pA + inst * 3 + (t - 18)
        : t < 24 ? pB + inst * 3 + (t - 21)
        : t < 27 ? cylA + inst * 3 + (t - 24)
                 : cylB + inst * 3 + (t - 27);
    asynccopy::copy_f32(ptr + t, src);
  }
  A.R = ptr;
  B.R = ptr + 9;
  A.p = ptr + 18;
  B.p = ptr + 21;
  A.cyl = ptr + 24;
  B.cyl = ptr + 27;
  ptr += 32;
  A.dir = ptr;
  B.dir = ptr + 3 * K;
  ptr += round4(6 * K);
  sc.ext = ptr;
  ptr += 4 * kChunk;
  sc.cand = reinterpret_cast<unsigned long long*>(ptr);
  ptr += 4 * kHullWarps * K;
  sc.red = ptr;
  int* last = reinterpret_cast<int*>(sc.red);  // free until the first pick
  if (tid < 2) last[tid] = 1;
  asynccopy::wait_all();
  __syncthreads();
  // the compiler pads a hull's vertex table with copies of its first
  // vertex, which move neither extreme of any scan: a hull's scans stop
  // after its last row that differs from row 0 (the same bits, less work)
  for (int v = tid; v < V; v += blockDim.x) {
    if (differs_from_first(A, v)) atomicMax(&last[0], v + 1);
    if (differs_from_first(B, v)) atomicMax(&last[1], v + 1);
  }
  __syncthreads();
  A.nv = last[0];
  B.nv = last[1];

  // ---- coarse pass: A's face normals, then B's negated
  const CoarseAxes coarse{A.nf, B.nf, A.fm, B.fm, F};
  BlockBest best = block_pass(A, B, 2 * F, sc, coarse);
  const float4 u = coarse(best.c);
  float cur_d = best.v, cur_x = best.s * u.x, cur_y = best.s * u.y,
        cur_z = best.s * u.z;

  // ---- refinement rounds
  const CrossAxes cross{A.dir, B.dir, K, kmagic};
  for (int r = 0; r < rounds; ++r) {
    block_select(A, B, E, K, cur_x, cur_y, cur_z, sc);
    best = block_pass(A, B, K * K, sc, cross);
    // strict: a tie keeps the old axis, and a round that does not improve
    // ends the instance (uniform over the block)
    if (!(best.v < cur_d)) break;
    const float4 nu = cross(best.c);
    cur_d = best.v;
    cur_x = best.s * nu.x;
    cur_y = best.s * nu.y;
    cur_z = best.s * nu.z;
    __syncthreads();  // every thread has read dir before the next round
  }

  if (tid == 0) depth_out[inst] = cur_d;
  if (tid < 3)
    n_out[inst * 3 + tid] = tid == 0 ? cur_x : (tid == 1 ? cur_y : cur_z);
  __syncthreads();  // shared memory is staged again by the next instance
}

// Whether any of `count` masks (shared or device memory) is set, over a
// warp.
__device__ __forceinline__ bool any_set(const float* m, int count,
                                        int lane) {
  bool set = false;
  for (int i = lane; i < count; i += kWarp) set |= m[i] > 0.5f;
  return __any_sync(kFull, set);
}

// Whether instance inst has a valid axis (no_valid_axis's test), over a
// warp: its face masks and A's edge masks staged into `m` (the warp's
// share of shared memory, every copy in flight before the one wait; B's
// edge masks only where A has a valid edge), or read from device memory
// where m is null.
__device__ __forceinline__ bool slot_is_live(
    const float* __restrict__ fmA, const float* __restrict__ fmB,
    const float* __restrict__ hmA, const float* __restrict__ hmB, int E,
    int F, float* m, int lane) {
  if (m == nullptr) return !no_valid_axis(fmA, fmB, hmA, hmB, E, F, lane);
  asynccopy::copy_warp(m, fmA, F, lane);
  asynccopy::copy_warp(m + round4(F), fmB, F, lane);
  asynccopy::copy_warp(m + 2 * round4(F), hmA, E, lane);
  asynccopy::wait_all();
  __syncwarp();
  const bool live =
      any_set(m, F, lane) || any_set(m + round4(F), F, lane) ||
      (any_set(m + 2 * round4(F), E, lane) && any_set(hmB, E, lane));
  __syncwarp();  // read before the warp's next copies land
  return live;
}

// kBlockWarps warps a block, as many blocks as fit the card at once.  The
// instances are visited in the order t P mod N (P coprime to N, so every
// instance once: the slots the compaction fills side by side, or one
// env's, land far apart), kBlockWarps a turn, from two counters in device
// memory that the wrapper zeroes for each launch.  First probe turns: a
// warp an instance reads the first face mask of both hulls, and a set one
// makes the instance live; the block solves the turn's live instances at
// once (the deep-pair compaction's live slots have valid faces, so they
// start within microseconds, each on its own block unless two share a
// turn).  Then check turns, taken by the blocks that are free: a warp an
// instance whose probe found nothing checks it for an empty slot (no valid
// face on either hull, no valid edge on one: (inf, A's first face normal),
// as the scan would end, before anything is staged; reading its masks is
// the launch's whole memory traffic, bound by bytes), and the block solves
// any that is live after all.
// (two blocks an SM: at most 128 registers a thread)
__global__ void __launch_bounds__(kBlockThreads, 2) mtv_query_block_kernel(
    const float* __restrict__ wA, const float* __restrict__ wB,
    const float* __restrict__ heA, const float* __restrict__ heB,
    const float* __restrict__ hmA, const float* __restrict__ hmB,
    const float* __restrict__ nfA, const float* __restrict__ nfB,
    const float* __restrict__ fmA, const float* __restrict__ fmB,
    const float* __restrict__ RA, const float* __restrict__ RB,
    const float* __restrict__ pA, const float* __restrict__ pB,
    const float* __restrict__ cylA, const float* __restrict__ cylB,
    float* __restrict__ depth_out, float* __restrict__ n_out,
    unsigned long long* __restrict__ next, int N, int V, int E, int F, int K,
    int rounds, unsigned kmagic, long long perm, BlockPlan plan) {
  extern __shared__ __align__(16) float smem[];
  __shared__ long long turn;
  __shared__ int live[kBlockWarps];
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const long long turns = (N + kBlockWarps - 1) / kBlockWarps;
  // a warp's share of the dynamic shared memory for the empty-slot checks
  const int share = plan.floats / kBlockWarps & ~3;
  float* m = 2 * round4(F) + round4(E) <= share ? smem + warp * share
                                                 : nullptr;
  for (int pass = 0; pass < 2; ++pass) {  // probe turns, then check turns
    for (;;) {
      if (tid == 0) turn = static_cast<long long>(atomicAdd(next + pass, 1ull));
      __syncthreads();
      const long long c = turn;
      if (c >= turns) {  // uniform over the block
        __syncthreads();  // every warp has read turn before the next pass
        break;            // writes it
      }
      const long long t = c * kBlockWarps + warp;
      const long long inst = t * perm % N;
      bool is_live = false;
      if (t < N) {  // uniform over the warp
        const bool probe = (__ldg(fmA + inst * F) > 0.5f) |
                           (__ldg(fmB + inst * F) > 0.5f);
        if (pass == 0) {
          is_live = probe;
        } else if (!probe) {
          is_live = slot_is_live(fmA + inst * F, fmB + inst * F,
                                 hmA + inst * E, hmB + inst * E, E, F, m,
                                 lane);
          if (!is_live) {
            if (lane == 0) depth_out[inst] = INFINITY;
            if (lane < 3) n_out[inst * 3 + lane] = nfA[inst * 3 * F + lane];
          }
        }
      }
      if (lane == 0) live[warp] = is_live;
      __syncthreads();  // the masks are read and live is set
      for (int w = 0; w < kBlockWarps; ++w)
        if (live[w])  // uniform over the block
          block_instance(wA, wB, heA, heB, hmA, hmB, nfA, nfB, fmA, fmB, RA,
                         RB, pA, pB, cylA, cylB, depth_out, n_out, V, E, F,
                         K, rounds, kmagic, plan, smem,
                         (c * kBlockWarps + w) * perm % N);
      __syncthreads();  // turn and live are written again by the next turn
    }
  }
}

// A step coprime to N for the block layout's order of visit: the first of
// a few primes that does not divide it.
long long visit_step(int N) {
  for (const long long p : {7919ll, 104729ll, 1299709ll, 15485863ll})
    if (N % p != 0) return p % N == 0 ? 1 : p;
  return 1;
}

}  // namespace

// Whether tables of this size take the block layout (whose launch needs
// two zeroed counters, `next`).
extern "C" int mtv_query_block_layout(int V, int E, int F, int K) {
  return warp_floats(V, E, F, K) * sizeof(float) > kSmemBudget ? 1 : 0;
}

// Per instance: wA/wB (V, 3), heA/heB (E, 2, 3), hmA/hmB (E,), nfA/nfB
// (F, 3), fmA/fmB (F,), RA/RB (3, 3), pA/pB (3,), cylA/cylB (3,) -> depth
// (), n (3,); every array contiguous float32 on the device with a leading
// instance axis N.  Any table size: one instance's tables in the 47 KB of
// shared memory a block gets without an opt-in take the staged (warp)
// layout, larger ones the block layout, which takes its turns from `next`:
// two 64-bit counters in device memory, zero at the launch (null for the
// staged layout).  Returns the cudaError_t of the launch (0 =
// cudaSuccess); 1 for K outside 1..1024, negative rounds, empty tables or
// a missing counter.
extern "C" int mtv_query_f32(const float* wA, const float* wB,
                             const float* heA, const float* heB,
                             const float* hmA, const float* hmB,
                             const float* nfA, const float* nfB,
                             const float* fmA, const float* fmB,
                             const float* RA, const float* RB, const float* pA,
                             const float* pB, const float* cylA,
                             const float* cylB, float* depth, float* n,
                             unsigned long long* next, int N, int V, int E,
                             int F, int K, int rounds, void* stream) {
  if (N < 0 || V < 1 || E < 1 || F < 1 || K < 1 || K > 1024 || rounds < 0)
    return 1;
  if (N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // ceil(2^32 / K): __umulhi(c, kmagic) == c / K for every c < K * K
  const unsigned kmagic =
      K == 1 ? 0u : 0xffffffffu / static_cast<unsigned>(K) + 1u;
  const bool big = warp_floats(V, E, F, K) * sizeof(float) > kSmemBudget;
  if (big) {
    if (next == nullptr) return 1;
    // half the opt-in limit: two instances an SM at least; as many blocks
    // as the card holds at once
    const int optin = asynccopy::smem_optin();
    const BlockPlan plan = block_plan(V, E, F, K, optin / 2);
    const size_t smem = static_cast<size_t>(plan.floats) * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          mtv_query_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mtv_query_block_kernel, kBlockThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long fit = static_cast<long long>(per_sm < 1 ? 1 : per_sm) * sms;
    const long long turns = (N + kBlockWarps - 1) / kBlockWarps;
    mtv_query_block_kernel<<<static_cast<int>(turns < fit ? turns : fit),
                             kBlockThreads, smem, s>>>(
        wA, wB, heA, heB, hmA, hmB, nfA, nfB, fmA, fmB, RA, RB, pA, pB, cylA,
        cylB, depth, n, next, N, V, E, F, K, rounds, kmagic, visit_step(N),
        plan);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t per_warp = warp_floats(V, E, F, K) * sizeof(float);
  int warps = static_cast<int>(kSmemBudget / per_warp);
  if (warps > kMaxWarps) warps = kMaxWarps;
  if (warps < 1) warps = 1;
  mtv_query_kernel<<<(N + warps - 1) / warps, warps * kWarp, warps * per_warp,
                     s>>>(wA, wB, heA, heB, hmA, hmB, nfA, nfB, fmA, fmB, RA,
                          RB, pA, pB, cylA, cylB, depth, n, N, V, E, F, K,
                          rounds, kmagic);
  return static_cast<int>(cudaGetLastError());
}
