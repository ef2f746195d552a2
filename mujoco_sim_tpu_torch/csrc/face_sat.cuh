// Shared device code of the face-SAT depth queries (sm_90a): hull_sat.cu
// (hull_ref_face_depth) and face_sat.cu (face_sat_depth) both run `run`, so
// the two queries cannot drift apart.  Per instance (V points of one hull
// in the frame of another hull with F face planes, a 0/1 mask over the
// points):
//
//   vals[v, f] = p_v . n_f - d_f   (1e9 for a masked point)
//   per-face minimum over v -> sep = its maximum over f, the reference face
//   = the lowest f that reaches it -> depth[v] = vals[v, ref] of the real
//   point -> optional lateral filter (drop v whose maximum over faces
//   exceeds max(depth, 0) + slack + 1e-4, unless that drops every v) ->
//   masked points at 1e9 -> the K smallest depths and their indices, lowest
//   index on ties, a pick excluded from the next passes.
//
// The two queries differ in three ways, each a compile-time switch
// (Variant): the lateral filter; the value that excludes a pick (+inf, or
// 1e9 as the prototype kernel does, so once only masked entries remain the
// lowest index is picked again); the outputs (the reference normal and
// int64 indices, or the reference plane with its offset and int32 indices).
//
// What bounds it on this card: bytes, nominally.  An instance reads
// 16 (V + F) bytes and writes ~12 K + 16: at V = 24, F = 44 about 1.1 KB
// against 24 x 44 pairs of 5 flops (6 with the filter's maximum), under
// the card's f32 balance of ~20 flop/byte.  Issue slots come next: built
// with -fmad=false a pair is 3 multiplies, 2 adds, a subtraction and a
// minimum (and a maximum for the filter), 7-8 issue slots, so one pass over
// the pairs of the manip step's 43 008 mesh-mesh instances is ~0.013 ms of
// issue on 132 SMs x 4 schedulers.  The first design (one warp an instance,
// lanes over faces, then over points) computed the pairs twice with the
// filter on, idled lanes (44 faces on 32 lanes, 8 points on 32 lanes, the
// picks on one lane) and issued four scalar shared loads per pair.
//
// What this design does about it:
//  * the support tensor is computed once, in registers.  A team of kTeam
//    lanes takes an instance, as kVG point groups x kFG face groups: a lane
//    holds kVPL points (v = vg + kVG i) as float4 registers and walks the
//    faces f = fg + kFG j, one 16-byte shared load a face.  In the same
//    pass it keeps the per-face minimum over its points (then shuffles
//    across the point groups) and, with the filter, the per-point maximum
//    over its faces (shuffled across the face groups once at the end).
//    The depth along the reference face is the same product again for the
//    lane's own points: kVPL dot products;
//  * for the face loop a masked point is replaced by a live point of the
//    same lane (the minimum is unchanged by a duplicate), so a pair issues
//    no select; the masked points' common 1e9 is one fminf a face;
//  * an instance's fixed work (staging, the reductions across groups, the
//    depths, the filter, the picks, the writes) costs as many instructions
//    as its pairs do at this size, so up to V = 32 a warp carries four
//    instances, 8 lanes each, and every such instruction serves four:
//    V <= 8 as 1 x 8 groups (a lane holds all 8 points, the picks need no
//    shuffle), V <= 24 as 4 x 2 with 6 points a lane (mesh-mesh
//    V = 24, F = 44: 6 x 22 pairs a lane, no idle slot; on the H100 it
//    measured 11% faster than 2 x 4, whose 12-deep pick chains the few
//    resident warps could not hide), V <= 32 as 2 x 4 with 16 points a
//    lane.  Faces past F are dummy planes (0, 0, 0, inf) in shared memory,
//    so a round issues no select.  V > 32 takes a
//    warp an instance and walks the points in tiles of 32, with the
//    per-face minima, the per-point maxima and the depths in a few floats
//    of shared memory a team (the picks then run over shared memory, each
//    entry read and written by one owner lane, so they need no barrier
//    either).  F is a loop of its own: any F;
//  * the K picks: each lane ranks its own points in registers, one shuffle
//    argmin across the point groups a pick, and the owner of the pick
//    excludes it in a register; no shared round trip, no __syncwarp;
//  * staging overlaps the compute: a persistent grid of teams walks the
//    instances, and the next instance's points, mask, planes and slack are
//    copied as they lie (16-byte cp.async where the sizes and addresses
//    allow) into the other half of a double buffer while the current one
//    computes (one commit group a stage, wait for all but the newest).
//    Measured on the H100 against one stage loaded and then waited on:
//    within 3%.  The double buffer stays (it costs no extra instruction
//    an instance); at these shapes the copies are not what waits.
//
// What still holds it (clock64 stamps and SASS counts of a scratch build
// on the H100): issue slots, not bytes.  At 12 resident warps an SM (126
// registers at V <= 32) the face pass takes about half of an instance's
// cycles, and staging, the reductions across groups and the picks share
// the rest about equally.
//
// Arithmetic keeps the twins' product order (dot3 in support.cuh) and the
// sources are built with -fmad=false: every reference face and pick is a
// float comparison that must tie where the plain version ties.
#pragma once
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "support.cuh"

namespace satk {

using hullk::dot3;
using hullk::kFull;
using hullk::kWarp;
using hullk::less_vi;

constexpr float kBig = 1e9f;
constexpr int kMaxWarpsPerBlock = 4;

// The kernel's arguments (by value: one launch parameter).
struct Query {
  const float* pts;     // (N, V, 3)
  const float* planes;  // (N, F, 4): normal, offset
  const float* mask;    // (N, V), or null: every point live
  const float* slack;   // (N,), or null: slack_scalar for every instance
  float slack_scalar;
  float* depth;         // (N, K)
  void* idx;            // (N, K): int32 with kPlaneOut, else int64
  float* ref;           // (N, 4) plane with kPlaneOut, else (N, 3) normal
  float* sep;           // (N,)
  int N, V, F, K;
};

template <bool Lateral, bool ExclInf, bool PlaneOut>
struct Variant {
  static constexpr bool kLateral = Lateral;    // the lateral filter
  static constexpr bool kExclInf = ExclInf;    // exclude a pick with +inf
  static constexpr bool kPlaneOut = PlaneOut;  // plane + int32, or normal
};

template <int Team, int VG, int VPL, bool Multi>
struct Layout {
  static constexpr int kTeam = Team;        // lanes an instance
  static constexpr int kVG = VG;            // point groups
  static constexpr int kFG = Team / VG;     // face groups
  static constexpr int kVPL = VPL;          // points a lane holds
  static constexpr int kTile = VG * VPL;    // points a tile
  static constexpr int kTeams = kWarp / Team;
  static constexpr bool kMulti = Multi;     // V above one tile
};

// Floats of one stage of a team's double buffer: the V points packed as in
// the input (x, y, z), the V mask values, the F planes and, up to a
// multiple of 8 (of every kFG), dummy planes (0, 0, 0, inf), the slack;
// each region padded to 4 floats, so every region starts 16-byte aligned.
__host__ __device__ inline int r4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int planes_padded(int F) { return (F + 7) & ~7; }
__host__ __device__ inline int stage_floats(int V, int F) {
  return r4(3 * V) + r4(V) + 4 * planes_padded(F) + 4;
}

// Floats of a team: two stages, and with kMulti the per-face minima, the
// per-point maxima (then keep flags) and the depths.
__host__ __device__ inline int team_floats(int V, int F, bool multi) {
  return 2 * stage_floats(V, F) + (multi ? r4(F + 2 * V) : 0);
}

template <int Team>
__device__ __forceinline__ unsigned team_mask(int lane) {
  if constexpr (Team == kWarp) {
    return kFull;
  } else {
    return ((1u << Team) - 1u) << (lane / Team * Team);
  }
}

// Reductions over the team lanes that differ in the bits [Lo, Hi) of
// their team-lane id; every lane of the group gets the result.
template <int Lo, int Hi>
__device__ __forceinline__ float min_over(float v) {
#pragma unroll
  for (int m = Lo; m < Hi; m <<= 1) v = fminf(v, __shfl_xor_sync(kFull, v, m));
  return v;
}

template <int Lo, int Hi>
__device__ __forceinline__ float max_over(float v) {
#pragma unroll
  for (int m = Lo; m < Hi; m <<= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, m));
  return v;
}

// smaller value first, then the lower index
template <int Lo, int Hi>
__device__ __forceinline__ void argmin_over(float& v, int& i) {
#pragma unroll
  for (int m = Lo; m < Hi; m <<= 1) {
    const float ov = __shfl_xor_sync(kFull, v, m);
    const int oi = __shfl_xor_sync(kFull, i, m);
    if (less_vi(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// larger value first, then the lower index
template <int Lo, int Hi>
__device__ __forceinline__ void argmax_over(float& v, int& i) {
#pragma unroll
  for (int m = Lo; m < Hi; m <<= 1) {
    const float ov = __shfl_xor_sync(kFull, v, m);
    const int oi = __shfl_xor_sync(kFull, i, m);
    if ((ov > v) | ((ov == v) & (oi < i))) {
      v = ov;
      i = oi;
    }
  }
}

// Issue the copy of `count` contiguous floats by the team's lanes: 16
// bytes a copy where the count and both addresses allow it, else 4.
template <class L>
__device__ __forceinline__ void copy_team(float* dst, const float* src,
                                          int count, int tl) {
  const bool wide =
      ((count | (reinterpret_cast<uintptr_t>(src) >> 2) |
        (__cvta_generic_to_shared(dst) >> 2)) & 3) == 0;
  if (wide) {
    for (int t = 4 * tl; t < count; t += 4 * L::kTeam)
      asynccopy::copy_f32x4(dst + t, src + t);
  } else {
    for (int t = tl; t < count; t += L::kTeam)
      asynccopy::copy_f32(dst + t, src + t);
  }
}

// The regions of a stage (see stage_floats).
struct Stage {
  const float* p;   // 3 V point coordinates
  const float* m;   // V mask values (unused without a mask)
  const float4* pl; // F planes
  const float* slack;
  __device__ __forceinline__ Stage(const float* sb, int V, int F)
      : p(sb),
        m(sb + r4(3 * V)),
        pl(reinterpret_cast<const float4*>(sb + r4(3 * V) + r4(V))),
        slack(sb + r4(3 * V) + r4(V) + 4 * planes_padded(F)) {}
};

// Issue the copies of one instance into a stage.  Nothing waits here.
template <class L>
__device__ __forceinline__ void stage_copy(const Query& q, long long inst,
                                           float* sb, int tl) {
  const int V = q.V, F = q.F;
  const Stage st(sb, V, F);
  copy_team<L>(const_cast<float*>(st.p), q.pts + inst * V * 3, 3 * V, tl);
  if (q.mask != nullptr)
    copy_team<L>(const_cast<float*>(st.m), q.mask + inst * V, V, tl);
  copy_team<L>(reinterpret_cast<float*>(const_cast<float4*>(st.pl)),
               q.planes + inst * F * 4, 4 * F, tl);
  if (q.slack != nullptr && tl == 0)
    asynccopy::copy_f32(const_cast<float*>(st.slack), q.slack + inst);
}

// Point v of a stage as (x, y, z, mask).
__device__ __forceinline__ float4 point(const Query& q, const Stage& st,
                                        int v) {
  return make_float4(st.p[3 * v], st.p[3 * v + 1], st.p[3 * v + 2],
                     q.mask != nullptr ? st.m[v] : 1.0f);
}

template <class X>
__device__ __forceinline__ void write_pick(const Query& q, long long inst,
                                           int k, float v, int i) {
  const long long at = inst * q.K + k;
  q.depth[at] = v;
  if constexpr (X::kPlaneOut) {
    static_cast<int*>(q.idx)[at] = i;
  } else {
    static_cast<long long*>(q.idx)[at] = i;
  }
}

template <class X>
__device__ __forceinline__ void write_ref(const Query& q, long long inst,
                                          int tl, float4 r, float sep) {
  constexpr int nc = X::kPlaneOut ? 4 : 3;
  if (tl < nc)
    q.ref[inst * nc + tl] = tl == 0 ? r.x : tl == 1 ? r.y : tl == 2 ? r.z : r.w;
  if (tl == nc) q.sep[inst] = sep;
}

__device__ __forceinline__ float slack_of(const Query& q, const Stage& st) {
  return (q.slack != nullptr ? st.slack[0] : q.slack_scalar) + 1e-4f;
}

// The lane's points of the tile starting at t0, and the face pass over
// them: `emit(f, pmin)` for each face f of the lane's face group (f past F
// included, for the caller to skip) with the minimum over the tile's
// points (shuffled across the point groups; a masked point counts 1e9
// through `fill`), and in sdf the lane's points' maxima over all faces.
// live and present get the lane's points' bits.
template <class L, class X, class Emit>
__device__ __forceinline__ void face_pass(const Query& q, const Stage& st,
                                          int t0, int vg, int fg, float fill,
                                          unsigned& live, unsigned& present,
                                          float (&sdf)[L::kVPL], Emit emit) {
  const int V = q.V, F = q.F;
  float4 w[L::kVPL];
  live = present = 0u;
#pragma unroll
  for (int i = 0; i < L::kVPL; ++i) {
    const int v = t0 + vg + L::kVG * i;
    w[i] = v < V ? point(q, st, v) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (v < V) present |= 1u << i;
    if (v < V && w[i].w > 0.5f) live |= 1u << i;
  }
  // a point that is masked (or past V) takes a live point of the lane: a
  // duplicate leaves the lane's minimum as it is; a lane with no live point
  // contributes +inf (lane_floor)
  float4 rep = w[0];
#pragma unroll
  for (int i = L::kVPL - 1; i >= 0; --i)
    if (live >> i & 1u) rep = w[i];
#pragma unroll
  for (int i = 0; i < L::kVPL; ++i)
    if (!(live >> i & 1u)) w[i] = rep;
  const float lane_floor = live ? -INFINITY : INFINITY;
#pragma unroll
  for (int i = 0; i < L::kVPL; ++i) sdf[i] = -INFINITY;

  // past F the dummy planes (0, 0, 0, inf) give -inf: no point's maximum
  // moves and no face's minimum wins; two rounds a trip, so one round's
  // shuffles overlap the next one's products
  const int rounds = (F + L::kFG - 1) / L::kFG;
#pragma unroll 2
  for (int j = 0; j < rounds; ++j) {
    const int f = fg + L::kFG * j;
    const float4 pl = st.pl[f];
    float pmin = INFINITY;
    if constexpr (X::kLateral) {
#pragma unroll
      for (int i = 0; i < L::kVPL; ++i) {
        const float val =
            dot3(w[i].x, w[i].y, w[i].z, pl.x, pl.y, pl.z) - pl.w;
        pmin = fminf(pmin, val);
        sdf[i] = fmaxf(sdf[i], val);
      }
    } else {
      // rounding is monotonic, so min_v fl(p_v . n - d) = fl(min_v (p_v .
      // n) - d) exactly: one subtraction a face, not a pair
#pragma unroll
      for (int i = 0; i < L::kVPL; ++i)
        pmin = fminf(pmin, dot3(w[i].x, w[i].y, w[i].z, pl.x, pl.y, pl.z));
      pmin = pmin - pl.w;
    }
    pmin = min_over<1, L::kVG>(fmaxf(pmin, lane_floor));
    emit(f, fminf(pmin, fill));
  }
}

// The lowest (value, index) of the lane's kVPL entries, the index of entry
// i being vg + kVG i: a tree of depth log2(kVPL), each pair keeping the
// left (lower-index) entry unless the right one is strictly smaller.
template <class L>
__device__ __forceinline__ void lane_argmin(const float (&d)[L::kVPL], int vg,
                                            float& bv, int& bi) {
  float tv[L::kVPL];
  int ti[L::kVPL];
#pragma unroll
  for (int i = 0; i < L::kVPL; ++i) {
    tv[i] = d[i];
    ti[i] = vg + L::kVG * i;
  }
#pragma unroll
  for (int h = 1; h < L::kVPL; h <<= 1) {
#pragma unroll
    for (int i = 0; i + h < L::kVPL; i += 2 * h) {
      const bool right = tv[i + h] < tv[i];
      tv[i] = right ? tv[i + h] : tv[i];
      ti[i] = right ? ti[i + h] : ti[i];
    }
  }
  bv = tv[0];
  bi = ti[0];
}

// One instance whose V points fit one tile: everything in registers.
template <class L, class X>
__device__ __forceinline__ void query_tile(const Query& q, const Stage& st,
                                           long long inst, bool on, int tl,
                                           unsigned tmask) {
  const int V = q.V, F = q.F;
  const int vg = tl % L::kVG, fg = tl / L::kVG;
  bool masked = false;
  if (q.mask != nullptr) {
#pragma unroll
    for (int i = 0; i < L::kVPL; ++i) {
      const int v = vg + L::kVG * i;
      if (v < V) masked |= !(st.m[v] > 0.5f);
    }
  }
  // a masked point puts 1e9 into every face's minimum (the twin's fill)
  const float fill = (__ballot_sync(kFull, masked) & tmask) ? kBig : INFINITY;

  unsigned live, present;
  float sdf[L::kVPL];
  float best = -INFINITY;
  int bestf = INT_MAX;
  face_pass<L, X>(q, st, 0, vg, fg, fill, live, present, sdf,
                  [&](int f, float pfm) {
                    // f ascends in the lane: a strict > keeps the first (a
                    // dummy face past F, at -inf, wins only a lane without
                    // a real face, and loses every tie by its index)
                    if (pfm > best || bestf == INT_MAX) {
                      best = pfm;
                      bestf = f;
                    }
                  });
  argmax_over<L::kVG, L::kTeam>(best, bestf);
  const float sep = best;
  const float4 rp = st.pl[bestf < F ? bestf : 0];

  // depth of the lane's real points along the reference normal
  float dep[L::kVPL];
#pragma unroll
  for (int i = 0; i < L::kVPL; ++i) {
    const int v = vg + L::kVG * i;
    const float4 p =
        v < V ? point(q, st, v) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    dep[i] = dot3(p.x, p.y, p.z, rp.x, rp.y, rp.z) - rp.w;
  }
  if constexpr (X::kLateral) {
    const float slk = slack_of(q, st);
    unsigned keep = 0u;
#pragma unroll
    for (int i = 0; i < L::kVPL; ++i) {
      const float s_all = max_over<L::kVG, L::kTeam>(sdf[i]);
      const float s = (live >> i & 1u) ? s_all : kBig;
      if ((present >> i & 1u) && s <= fmaxf(dep[i], 0.0f) + slk)
        keep |= 1u << i;
    }
    // if the filter would drop every point, it drops none
    const bool any_keep = (__ballot_sync(kFull, keep != 0u) & tmask) != 0u;
#pragma unroll
    for (int i = 0; i < L::kVPL; ++i)
      if (any_keep && !(keep >> i & 1u)) dep[i] = kBig;
  }
#pragma unroll
  for (int i = 0; i < L::kVPL; ++i)
    if (!(live >> i & 1u)) dep[i] = (present >> i & 1u) ? kBig : INFINITY;

  // the K smallest, lowest index on ties; the owner excludes each pick
  const float excl = X::kExclInf ? INFINITY : kBig;
  for (int k = 0; k < q.K; ++k) {
    float bv;
    int bi;
    lane_argmin<L>(dep, vg, bv, bi);
    argmin_over<1, L::kVG>(bv, bi);
    if (bi >= V) bi = 0;
    if (on && tl == k % L::kTeam) write_pick<X>(q, inst, k, bv, bi);
#pragma unroll
    for (int i = 0; i < L::kVPL; ++i)
      if (vg + L::kVG * i == bi) dep[i] = excl;
  }
  if (on) write_ref<X>(q, inst, tl, rp, sep);
}

// One instance whose V points span several tiles: the face pass runs per
// tile, and what must outlive a tile sits in the team's scratch (pfm: F
// minima, vsd: V maxima then keep flags, vdep: V depths).
template <class L, class X>
__device__ __forceinline__ void query_multi(const Query& q, const Stage& st,
                                            float* scratch, long long inst,
                                            bool on, int tl, unsigned tmask) {
  const int V = q.V, F = q.F;
  float* pfm = scratch;
  float* vsd = scratch + F;
  float* vdep = vsd + V;
  const int vg = tl % L::kVG, fg = tl / L::kVG;
  bool masked = false;
  if (q.mask != nullptr)
    for (int v = tl; v < V; v += L::kTeam) masked |= !(st.m[v] > 0.5f);
  const float fill = (__ballot_sync(kFull, masked) & tmask) ? kBig : INFINITY;

  for (int t0 = 0; t0 < V; t0 += L::kTile) {
    unsigned live, present;
    float sdf[L::kVPL];
    face_pass<L, X>(q, st, t0, vg, fg, fill, live, present, sdf,
                    [&](int f, float m) {
                      // one owner a face: the lane of point group 0
                      if (f < F && vg == 0)
                        pfm[f] = t0 == 0 ? m : fminf(pfm[f], m);
                    });
    if constexpr (X::kLateral) {
#pragma unroll
      for (int i = 0; i < L::kVPL; ++i) {
        const float s = max_over<L::kVG, L::kTeam>(sdf[i]);
        if (fg == 0 && (present >> i & 1u)) vsd[t0 + vg + L::kVG * i] = s;
      }
    }
  }
  __syncwarp();
  float best = -INFINITY;
  int bestf = INT_MAX;
  for (int f = tl; f < F; f += L::kTeam) {
    if (pfm[f] > best || bestf == INT_MAX) {
      best = pfm[f];
      bestf = f;
    }
  }
  argmax_over<1, L::kTeam>(best, bestf);
  const float sep = best;
  const float4 rp = st.pl[bestf < F ? bestf : 0];

  // depths (and keep flags) of the points v = tl + kTeam j: from here on
  // each entry of vsd and vdep is read and written by its owner lane only
  bool any = false;
  const float slk = X::kLateral ? slack_of(q, st) : 0.0f;
  for (int v = tl; v < V; v += L::kTeam) {
    const float4 p = point(q, st, v);
    const float d = dot3(p.x, p.y, p.z, rp.x, rp.y, rp.z) - rp.w;
    vdep[v] = d;
    if constexpr (X::kLateral) {
      const float s = p.w > 0.5f ? vsd[v] : kBig;
      const bool keep = s <= fmaxf(d, 0.0f) + slk;
      vsd[v] = keep ? 1.0f : 0.0f;
      any |= keep;
    }
  }
  const bool any_keep = (__ballot_sync(kFull, any) & tmask) != 0u;
  for (int v = tl; v < V; v += L::kTeam) {
    const bool keep = !X::kLateral || !any_keep || vsd[v] > 0.5f;
    if (!(keep && point(q, st, v).w > 0.5f)) vdep[v] = kBig;
  }
  const float excl = X::kExclInf ? INFINITY : kBig;
  for (int k = 0; k < q.K; ++k) {
    float bv = INFINITY;
    int bi = V;
    for (int v = tl; v < V; v += L::kTeam) {
      if (less_vi(vdep[v], v, bv, bi)) {
        bv = vdep[v];
        bi = v;
      }
    }
    argmin_over<1, L::kTeam>(bv, bi);
    if (bi >= V) bi = 0;
    if (on && tl == k % L::kTeam) write_pick<X>(q, inst, k, bv, bi);
    if (bi % L::kTeam == tl) vdep[bi] = excl;
  }
  if (on) write_ref<X>(q, inst, tl, rp, sep);
}

// The kernel body: a persistent grid of teams walks the instances, each
// team double-buffering its instances' tables through cp.async.
template <class L, class X>
__device__ __forceinline__ void run(const Query& q) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int tl = lane % L::kTeam;
  const unsigned tmask = team_mask<L::kTeam>(lane);
  const int sfl = stage_floats(q.V, q.F);
  float* base = smem + (warp * L::kTeams + lane / L::kTeam) *
                           team_floats(q.V, q.F, L::kMulti);
  float* scratch = base + 2 * sfl;
  const long long teams =
      static_cast<long long>(gridDim.x) * (blockDim.x / L::kTeam);
  // the warp's first team; the warp's teams move together, so every loop
  // below is uniform over the warp
  const long long first =
      (static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp) *
      L::kTeams;

  // the dummy planes past F, in both stages (no copy overwrites them)
  for (int s = 0; s < 2; ++s) {
    float4* pl = const_cast<float4*>(Stage(base + s * sfl, q.V, q.F).pl);
    for (int f = q.F + tl; f < planes_padded(q.F); f += L::kTeam)
      pl[f] = make_float4(0.0f, 0.0f, 0.0f, INFINITY);
  }
  long long inst = first + lane / L::kTeam;
  if (inst < q.N) stage_copy<L>(q, inst, base, tl);
  asynccopy::commit();
  int stage = 0;
  for (long long at = first; at < q.N; at += teams) {
    const long long next = inst + teams;
    if (next < q.N) stage_copy<L>(q, next, base + (stage ^ 1) * sfl, tl);
    asynccopy::commit();
    asynccopy::wait_pending<1>();
    __syncwarp();
    const Stage st(base + stage * sfl, q.V, q.F);
    if constexpr (L::kMulti) {
      query_multi<L, X>(q, st, scratch, inst, inst < q.N, tl, tmask);
    } else {
      query_tile<L, X>(q, st, inst, inst < q.N, tl, tmask);
    }
    __syncwarp();  // the stage just read is the next copy's target
    inst = next;
    stage ^= 1;
  }
}

// Launch `kernel` (a __global__ that runs run<L, ...>) over q.N instances
// on `stream`: as many warps a block (up to four) as the shared memory
// allows, as many blocks as are resident at once (the grid is persistent).
// Returns the cudaError_t of the launch, or 1 when one team's tables do not
// fit the card's shared memory.  The device queries are cached per device
// and kernel.
template <class L>
int launch(void (*kernel)(Query), const Query& q, cudaStream_t stream) {
  struct Occ {
    const void* fn;
    int dev;
    size_t bytes;
    int per_sm;
  };
  static int optin[64], sms[64];
  static Occ occ[64];
  static int nocc = 0;
  static const void* opted[64];
  static int nopted = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64) return 1;
  if (sms[dev] == 0) {
    cudaDeviceGetAttribute(&optin[dev],
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  const size_t warp_bytes = static_cast<size_t>(L::kTeams) *
                            team_floats(q.V, q.F, L::kMulti) * sizeof(float);
  int warps = static_cast<int>(optin[dev] / warp_bytes);
  if (warps < 1) return 1;
  if (warps > kMaxWarpsPerBlock) warps = kMaxWarpsPerBlock;
  const size_t bytes = warps * warp_bytes;
  const void* fn = reinterpret_cast<const void*>(kernel);
  if (bytes > 48 * 1024) {
    bool done = false;
    for (int i = 0; i < nopted; ++i) done |= opted[i] == fn;
    if (!done) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin[dev]);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (nopted < 64) opted[nopted++] = fn;
    }
  }
  int per_sm = 0;
  for (int i = 0; i < nocc; ++i)
    if (occ[i].fn == fn && occ[i].dev == dev && occ[i].bytes == bytes)
      per_sm = occ[i].per_sm;
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  warps * kWarp, bytes);
    if (per_sm < 1) per_sm = 1;
    if (nocc < 64) occ[nocc++] = Occ{fn, dev, bytes, per_sm};
  }
  const long long per_block = static_cast<long long>(warps) * L::kTeams;
  long long blocks = (q.N + per_block - 1) / per_block;
  const long long resident = static_cast<long long>(sms[dev]) * per_sm;
  if (blocks > resident) blocks = resident;
  kernel<<<static_cast<unsigned>(blocks), warps * kWarp, bytes, stream>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace satk

// FN<Layout>(args...) for the layout that takes V points: four instances a
// warp (8 lanes each, 1 x 8, 4 x 2 or 2 x 4 point x face groups) up to
// V = 32, one a warp in tiles of 32 points beyond.
#define SATK_DISPATCH(V, FN, ...)                                  \
  ((V) <= 8    ? FN<satk::Layout<8, 1, 8, false>>(__VA_ARGS__)     \
   : (V) <= 24 ? FN<satk::Layout<8, 4, 6, false>>(__VA_ARGS__)     \
   : (V) <= 32 ? FN<satk::Layout<8, 2, 16, false>>(__VA_ARGS__)    \
               : FN<satk::Layout<32, 4, 8, true>>(__VA_ARGS__))
