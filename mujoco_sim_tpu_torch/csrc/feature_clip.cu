// Feature clip of the deep-pair exact manifold on Hopper (sm_90a): from the
// exact MTV (depth, n) of a convex pair to its <= 4 oracle-form contacts.
//
// Replaces no TPU kernel: the JAX package computes this stage in XLA ops
// (mujoco_sim_tpu/ops/manifold.py, after the exact query).  It fuses the
// plain tail of ops/manifold.exact_pair_contacts, which the port runs as
// ~630 tensor ops over every deep slot of every env, live or not.  Per lane
// (one hull pair), as ops/manifold.feature_clip_plain computes it:
//
//   ok = depth in (0, 1e8); the hulls' bounding radii rbA, rbB (local
//   vertices) and rb = min; the support extents sA = max_A(n.a), sB =
//   min_B(n.b) (a cylinder-flagged hull: its analytic extent);
//   each hull's feature polygon (16 rows): the best-aligned merged face's
//   row of the shared fpoly table (by the lane's hull index) when the face
//   is within the face window and >= 3 vertices lie in the feature window,
//   a cylinder's cap, else a thin rectangle around the extreme window
//   vertices (a cylinder: its tangent segment or its rim point);
//   both polygons in a 2-D frame of the contact plane, B's ring reversed;
//   the convex clip's 288 corner candidates (A's vertices inside B, B's
//   inside A, the 256 edge crossings); the <= 4 spread points of them
//   (_reduce4: farthest from the centroid, farthest from that, the largest
//   and smallest signed areas, later points within 1e-4 rb of a kept one
//   dropped); the midpoint of the closest boundary points when the
//   intersection is empty; the interior witness of a cylinder side; the
//   points lifted onto the mid-surface plane; dist = -depth on the active
//   rows of an ok lane, 1e9 elsewhere; sepd = -depth where the query
//   proved separation.  A lane that is not enabled writes the miss tuple
//   (dist 1e9, pos 0, n +z, ok false, sepd 0) and exits.
//
// What bounds it on this card: bytes.  The deep-pair compaction hands the
// stage 8 slots an env, mostly empty: a disabled lane reads its flag and
// writes 21 floats and a byte.  A live lane reads its tables once (world
// and local vertices and their mask, 28 V bytes; world face normals and
// mask, 16 F; its poses, 4 x 30; one 192-byte row of fpoly a hull) and
// writes the same 85 bytes; its arithmetic (~20 k flops, most of it the
// 16 x 16 edge crossings and the 256 segment pairs of the fallback) is
// small beside the plain code's, which materialises every lane's
// (16, 16, 2) tensors whether it is live or not.
//
// What this design does about it:
//  * one warp a lane, eight lanes a block, no block barrier: a disabled
//    lane's warp reads one byte, writes its miss tuple and exits, so the
//    cost follows the live lanes, not the slots;
//  * a live lane's warp strides over its own V vertices and F faces, so
//    any table size the compiler builds works (bighull's (V, F) = (320,
//    636) too); the polygons' 16 rows are computed a thread each, and the
//    two 2-D rings and their edges sit in ~0.6 KB of shared memory a warp;
//  * the 288 candidates stay in registers, nine a thread (thread t holds
//    candidate t + 32 q: q = 0 a polygon vertex, q >= 1 the crossings of
//    B's edge t % 16); every pick is a warp shuffle reduction on (value,
//    index, point) with ties to the lowest index, as torch.argmax /
//    argmin pick;
//  * the fallback's 256 segment pairs run only on a lane whose clip is
//    empty, eight a thread.
// The sums are the plain code's operations in float32: products and sums
// rounded one by one (built with -fmad=false), three-term dots summed
// left to right.  The centroids are sums over many terms whose order the
// plain code leaves to PyTorch's reduction: they can differ in the last
// bit, which moves a pick only where it ties in exact arithmetic (corners
// of one rectangle, or of a square, equally far from its centre): the same
// point set, in another row order.
//
// Loaded with ctypes by ops/manifold.py.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;                     // lanes (warps) a block
constexpr int kPoly = 16;                     // rows of a feature polygon
constexpr int kCand = 2 * kPoly + kPoly * kPoly;  // clip candidates: 288
constexpr int kPer = kCand / kWarp;           // candidates a thread: 9
constexpr int kPairs = kPoly * kPoly / kWarp;  // fallback pairs a thread: 8
static_assert(kCand % kWarp == 0 && kPoly * 2 == kWarp, "warp layout");
constexpr unsigned kAll = 0xffffffffu;

// the plain code's constants as it compares them: a Python float against
// a float32 tensor, rounded to float32 once
constexpr float kFeatWindow = static_cast<float>(1.5e-3);
constexpr float kCosFace = static_cast<float>(1.0 - 1.25e-5);
constexpr float kTiny = static_cast<float>(1e-30);
constexpr float kMiss = 1e9f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 ld3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 scale(float s, V3 a) {
  return {s * a.x, s * a.y, s * a.z};
}
__device__ __forceinline__ V3 divs(V3 a, float s) {
  return {a.x / s, a.y / s, a.z / s};
}
// (v * u).sum(-1): three products, summed left to right
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return (a.x * b.x + a.y * b.y) + a.z * b.z;
}
__device__ __forceinline__ float norm(V3 a) { return sqrtf(dot(a, a)); }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 rot(const float* R, V3 v) {  // R v, R row-major
  return {dot({R[0], R[1], R[2]}, v), dot({R[3], R[4], R[5]}, v),
          dot({R[6], R[7], R[8]}, v)};
}
__device__ __forceinline__ float cross2(float ax, float ay, float bx,
                                        float by) {
  return ax * by - ay * bx;
}
__device__ __forceinline__ float sq2(float x, float y) {
  return x * x + y * y;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = kWarp / 2; o; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}
__device__ __forceinline__ int warp_sum(int v) {
  for (int o = kWarp / 2; o; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = kWarp / 2; o; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kAll, v, o));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int o = kWarp / 2; o; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

// A running pick: the best value, its index and the point it names.  A
// thread offers its elements in rising index order (a strict update keeps
// the first of equal values); the warp then keeps the better value, or of
// equal values the lower index: torch.argmax / argmin's first extreme.
// An empty pick (index INT_MAX) takes the first element offered whatever
// its value, so a row of -inf picks index 0, as torch.argmax does.
template <bool kMax, int kN>
struct Pick {
  float v = kMax ? -INFINITY : INFINITY;
  int i = INT_MAX;
  float p[kN > 0 ? kN : 1] = {};

  __device__ __forceinline__ bool beats(float w) const {
    return kMax ? w > v : w < v;
  }
  __device__ __forceinline__ void offer(float w, int j, const float* q) {
    if (i == INT_MAX || beats(w)) {
      v = w;
      i = j;
      for (int k = 0; k < kN; ++k) p[k] = q[k];
    }
  }
  __device__ __forceinline__ void reduce() {
    for (int o = kWarp / 2; o; o >>= 1) {
      const float w = __shfl_xor_sync(kAll, v, o);
      const int j = __shfl_xor_sync(kAll, i, o);
      float q[kN > 0 ? kN : 1];
      for (int k = 0; k < kN; ++k) q[k] = __shfl_xor_sync(kAll, p[k], o);
      if (beats(w) || (w == v && j < i)) {
        v = w;
        i = j;
        for (int k = 0; k < kN; ++k) p[k] = q[k];
      }
    }
  }
};

// One hull as a lane sees it.
struct Hull {
  const float* w;      // V x 3 world vertices
  const float* vl;     // V x 3 local vertices
  const float* vm;     // V vertex mask
  const float* nf;     // F x 3 world face normals
  const float* fm;     // F face mask
  const float* poly;   // F x 16 x 3 local face polygons of its hull, or null
  const float* R;      // 3 x 3
  V3 p;                // world position (the cylinder's centre)
  V3 aw;               // third column of R (the cylinder's axis)
  float cyl[3];        // [flag, radius, half-height]
  float rb;            // bounding radius
};

// The hull's bounding radius: sqrt of the largest |v|^2 of its masked
// local vertices (-inf, and so NaN, where none is).
__device__ float bound_radius(const Hull& h, int V, int t) {
  float r2 = -INFINITY;
  for (int v = t; v < V; v += kWarp)
    if (h.vm[v] > 0.5f) r2 = fmaxf(r2, dot(ld3(h.vl + 3 * v),
                                           ld3(h.vl + 3 * v)));
  return sqrtf(warp_max(r2));
}

// mtv_query.cyl_ext along the unit axis n
__device__ __forceinline__ float cyl_ext(V3 n, const Hull& h) {
  const float da = dot(n, h.aw);
  const float dperp = sqrtf(fmaxf(1.0f - da * da, 0.0f));
  return h.cyl[2] * fabsf(da) + h.cyl[1] * dperp;
}

// _any_perp
__device__ __forceinline__ V3 any_perp(V3 v) {
  const float small = fabsf(v.x) < 0.5f ? 1.0f : 0.0f;
  const V3 p = cross(v, {small, 1.0f - small, 0.0f});
  return divs(p, fmaxf(norm(p), 1e-12f));
}

// The lane's feature polygon of one hull (_feature_poly): row `t` of it
// (t < 16), in world coordinates.  sign = +1 for hull A (the feature
// maximises n.v at s_ext), -1 for hull B; n is the MTV axis.
__device__ V3 feature_row(const Hull& h, int V, int F, V3 n, float s_ext,
                          float sign, int t) {
  const bool is_cyl = h.cyl[0] > 0.5f;
  const float window = kFeatWindow * h.rb;
  // the window vertices: their count and centroid
  int cnt = 0;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  for (int v = t; v < V; v += kWarp) {
    const V3 wv = ld3(h.w + 3 * v);
    if (h.vm[v] > 0.5f && sign * (dot(wv, n) - s_ext) > -window) {
      ++cnt;
      sx += wv.x;
      sy += wv.y;
      sz += wv.z;
    }
  }
  cnt = warp_sum(cnt);
  const float cden = fmaxf(static_cast<float>(cnt), 1.0f);
  const V3 c = {warp_sum(sx) / cden, warp_sum(sy) / cden,
                warp_sum(sz) / cden};
  // the best-aligned face (outward normal ~ sign n)
  const V3 nn = scale(sign, n);
  Pick<true, 0> face;
  for (int f = t; f < F; f += kWarp)
    face.offer(h.fm[f] > 0.5f ? dot(ld3(h.nf + 3 * f), nn) : -INFINITY, f,
               nullptr);
  face.reduce();
  const float ca = dot(nn, h.aw);
  // a cylinder's smooth side is never a face: only its cap
  const bool face_ok = is_cyl ? fabsf(ca) > kCosFace
                              : cnt >= 3 && face.v > kCosFace;
  if (face_ok) {
    if (t >= kPoly) return {};
    const V3 row = h.poly == nullptr
                       ? V3{0.0f, 0.0f, 0.0f}
                       : ld3(h.poly + (static_cast<long long>(face.i) *
                                           kPoly + t) * 3);
    return add(h.p, rot(h.R, row));
  }
  // the segment feature: the window vertex farthest from the centroid,
  // then the one farthest from that
  Pick<true, 3> e0;
  for (int v = t; v < V; v += kWarp) {
    const V3 wv = ld3(h.w + 3 * v);
    const bool in = h.vm[v] > 0.5f && sign * (dot(wv, n) - s_ext) > -window;
    const V3 d = sub(wv, c);
    e0.offer(in ? dot(d, d) : -1.0f, v, &wv.x);
  }
  e0.reduce();
  V3 p0 = {e0.p[0], e0.p[1], e0.p[2]};
  Pick<true, 3> e1;
  for (int v = t; v < V; v += kWarp) {
    const V3 wv = ld3(h.w + 3 * v);
    const bool in = h.vm[v] > 0.5f && sign * (dot(wv, n) - s_ext) > -window;
    const V3 d = sub(wv, p0);
    e1.offer(in ? dot(d, d) : -1.0f, v, &wv.x);
  }
  e1.reduce();
  V3 p1 = {e1.p[0], e1.p[1], e1.p[2]};
  if (is_cyl) {
    // the tangent segment of a side contact, the rim point otherwise
    const V3 u_raw = sub(nn, scale(ca, h.aw));
    const float un = norm(u_raw);
    const V3 u_rad = un > 1e-9f ? divs(u_raw, fmaxf(un, 1e-12f))
                                : any_perp(h.aw);
    const float r = h.cyl[1], hh = h.cyl[2];
    const V3 tangent = add(h.p, scale(r, u_rad));
    const bool is_side = hh * fabsf(ca) < window;
    const float sgn = ca > 0.0f ? 1.0f : (ca < 0.0f ? -1.0f : 0.0f);
    const V3 rim = add(tangent, scale(hh * sgn, h.aw));
    p0 = is_side ? sub(tangent, scale(hh, h.aw)) : rim;
    p1 = is_side ? add(tangent, scale(hh, h.aw)) : rim;
  }
  // a thin rectangle in the contact plane around (p0, p1), its last
  // corner repeated to 16 rows
  const V3 u = sub(p1, p0);
  const float un2 = norm(u);
  const V3 uu = un2 > 1e-9f ? divs(u, fmaxf(un2, 1e-12f))
                            : V3{1.0f, 0.0f, 0.0f};
  const V3 ds = scale(1e-6f * h.rb, cross(n, uu));
  switch (t) {
    case 0: return sub(p0, ds);
    case 1: return sub(p1, ds);
    case 2: return add(p1, ds);
    default: return add(p0, ds);
  }
}

// _seg_closest2 on 2-D segments [p1, q1], [p2, q2]: the midpoint of the
// closest points and their squared distance
__device__ __forceinline__ float seg_mid(float p1x, float p1y, float q1x,
                                         float q1y, float p2x, float p2y,
                                         float q2x, float q2y, float* mid) {
  const float d1x = q1x - p1x, d1y = q1y - p1y;
  const float d2x = q2x - p2x, d2y = q2y - p2y;
  const float rx = p1x - p2x, ry = p1y - p2y;
  const float a = sq2(d1x, d1y), e = d2x * d2x + d2y * d2y;
  const float f = d2x * rx + d2y * ry;
  const float c = d1x * rx + d1y * ry;
  const float b = d1x * d2x + d1y * d2y;
  const float denom = a * e - b * b;
  float s = denom > kTiny ? (b * f - c * e) / denom : 0.0f;
  s = fminf(fmaxf(s, 0.0f), 1.0f);
  float tt = e > kTiny ? (b * s + f) / e : 0.0f;
  tt = fminf(fmaxf(tt, 0.0f), 1.0f);
  s = a > kTiny ? fminf(fmaxf((b * tt - c) / a, 0.0f), 1.0f) : 0.0f;
  const float ax = p1x + s * d1x, ay = p1y + s * d1y;
  const float bx = p2x + tt * d2x, by = p2y + tt * d2y;
  mid[0] = 0.5f * (ax + bx);
  mid[1] = 0.5f * (ay + by);
  return sq2(ax - bx, ay - by);
}

struct Rings {          // one warp's share of shared memory
  float a[kPoly][2];    // A's ring, CCW about n
  float b[kPoly][2];    // B's ring reversed (CCW)
  float ea[kPoly][2], eb[kPoly][2];   // edges to the next vertex
  float la[kPoly], lb[kPoly];         // their lengths
};

__global__ void __launch_bounds__(kWarps* kWarp) feature_clip_kernel(
    const float* __restrict__ wA, const float* __restrict__ wB,
    const float* __restrict__ vlA, const float* __restrict__ vlB,
    const float* __restrict__ vmA, const float* __restrict__ vmB,
    const float* __restrict__ nfA, const float* __restrict__ nfB,
    const float* __restrict__ fmA, const float* __restrict__ fmB,
    const float* __restrict__ pA, const float* __restrict__ pB,
    const float* __restrict__ RA, const float* __restrict__ RB,
    const float* __restrict__ cylA, const float* __restrict__ cylB,
    const long long* __restrict__ hidA, const long long* __restrict__ hidB,
    const float* __restrict__ fpoly, const float* __restrict__ depth,
    const float* __restrict__ nrm, const bool* __restrict__ enabled,
    float* __restrict__ dist, float* __restrict__ pos,
    float* __restrict__ n_out, bool* __restrict__ ok_out,
    float* __restrict__ sepd, int N, int V, int F) {
  __shared__ Rings rings[kWarps];
  const int t = threadIdx.x % kWarp;
  const long long lane =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / kWarp;
  if (lane >= N) return;
  float* d_o = dist + 4 * lane;
  float* p_o = pos + 12 * lane;
  float* n_o = n_out + 3 * lane;
  if (!enabled[lane]) {     // the miss tuple, whatever the inputs hold
    if (t < 4) d_o[t] = kMiss;
    if (t < 12) p_o[t] = 0.0f;
    if (t < 3) n_o[t] = t == 2 ? 1.0f : 0.0f;
    if (t == 0) {
      ok_out[lane] = false;
      sepd[lane] = 0.0f;
    }
    return;
  }
  Rings& s = rings[threadIdx.x / kWarp];
  const float dep = depth[lane];
  const V3 n = ld3(nrm + 3 * lane);
  const bool ok = dep > 0.0f && dep < 1e8f;
  const long long vo = lane * V, fo = lane * F;
  const long long ia = hidA[lane], ib = hidB[lane];
  const long long prow = static_cast<long long>(F) * kPoly * 3;
  Hull A{wA + 3 * vo, vlA + 3 * vo, vmA + vo, nfA + 3 * fo, fmA + fo,
         ia >= 0 ? fpoly + ia * prow : nullptr, RA + 9 * lane,
         ld3(pA + 3 * lane), {RA[9 * lane + 2], RA[9 * lane + 5],
                              RA[9 * lane + 8]},
         {cylA[3 * lane], cylA[3 * lane + 1], cylA[3 * lane + 2]}, 0.0f};
  Hull B{wB + 3 * vo, vlB + 3 * vo, vmB + vo, nfB + 3 * fo, fmB + fo,
         ib >= 0 ? fpoly + ib * prow : nullptr, RB + 9 * lane,
         ld3(pB + 3 * lane), {RB[9 * lane + 2], RB[9 * lane + 5],
                              RB[9 * lane + 8]},
         {cylB[3 * lane], cylB[3 * lane + 1], cylB[3 * lane + 2]}, 0.0f};
  A.rb = bound_radius(A, V, t);
  B.rb = bound_radius(B, V, t);
  // torch.minimum: a NaN radius (a hull with no vertex) stays NaN
  const float rb = A.rb < B.rb || A.rb != A.rb ? A.rb : B.rb;
  // support extents along n
  float sa = -INFINITY, sb = INFINITY;
  for (int v = t; v < V; v += kWarp) {
    if (A.vm[v] > 0.5f) sa = fmaxf(sa, dot(ld3(A.w + 3 * v), n));
    if (B.vm[v] > 0.5f) sb = fminf(sb, dot(ld3(B.w + 3 * v), n));
  }
  sa = warp_max(sa);
  sb = warp_min(sb);
  if (A.cyl[0] > 0.5f) sa = dot(n, A.p) + cyl_ext(n, A);
  if (B.cyl[0] > 0.5f) sb = dot(n, B.p) - cyl_ext(n, B);
  const float c_mid = 0.5f * (sa + sb);
  // the 2-D frame on the contact plane
  const float small = fabsf(n.x) < 0.5f ? 1.0f : 0.0f;
  V3 t1 = cross(n, {small, 1.0f - small, 0.0f});
  t1 = divs(t1, fmaxf(norm(t1), 1e-12f));
  const V3 t2 = cross(n, t1);
  // both feature polygons, projected; B's ring reversed to read CCW
  const V3 ra = feature_row(A, V, F, n, sa, 1.0f, t);
  const V3 rbw = feature_row(B, V, F, n, sb, -1.0f, t);
  if (t < kPoly) {
    s.a[t][0] = dot(ra, t1);
    s.a[t][1] = dot(ra, t2);
    s.b[kPoly - 1 - t][0] = dot(rbw, t1);
    s.b[kPoly - 1 - t][1] = dot(rbw, t2);
  }
  __syncwarp();
  {
    const int k = t % kPoly;
    float(*ring)[2] = t < kPoly ? s.a : s.b;
    float(*edge)[2] = t < kPoly ? s.ea : s.eb;
    const float ex = ring[(k + 1) % kPoly][0] - ring[k][0];
    const float ey = ring[(k + 1) % kPoly][1] - ring[k][1];
    edge[k][0] = ex;
    edge[k][1] = ey;
    (t < kPoly ? s.la : s.lb)[k] = sqrtf(sq2(ex, ey));
  }
  __syncwarp();
  // the clip's corner candidates: q = 0 a vertex of one ring inside the
  // other (A's for t < 16, B's above), q >= 1 the crossing of A's edge
  // 2 (q - 1) + t / 16 with B's edge t % 16
  const float eps = 1e-6f * rb;
  float cx[kPer], cy[kPer];
  bool cm[kPer];
  {
    const int k = t % kPoly;
    const bool mine = t < kPoly;
    float(*self)[2] = mine ? s.a : s.b;
    float(*other)[2] = mine ? s.b : s.a;
    float(*oe)[2] = mine ? s.eb : s.ea;
    const float* ol = mine ? s.lb : s.la;
    const float px = self[k][0], py = self[k][1];
    bool in = true;
    for (int j = 0; j < kPoly; ++j)
      in = in && cross2(oe[j][0], oe[j][1], px - other[j][0],
                        py - other[j][1]) >= -eps * ol[j];
    // a repeat pad of the ring is not a candidate of its own
    const int pk = (k + kPoly - 1) % kPoly;
    const bool first = k == 0 || fabsf(px - self[pk][0]) +
                                         fabsf(py - self[pk][1]) > 0.0f;
    cx[0] = px;
    cy[0] = py;
    cm[0] = in && first;
  }
  {
    const int j = t % kPoly;
    const float bx = s.b[j][0], by = s.b[j][1];
    const float ebx = s.eb[j][0], eby = s.eb[j][1];
#pragma unroll
    for (int q = 1; q < kPer; ++q) {
      const int i = 2 * (q - 1) + t / kPoly;
      const float ax = s.a[i][0], ay = s.a[i][1];
      const float eax = s.ea[i][0], eay = s.ea[i][1];
      const float dx = ax - bx, dy = ay - by;
      const float den = cross2(eax, eay, ebx, eby);
      const bool ok_den = fabsf(den) > kTiny;
      const float dsafe = ok_den ? den : 1.0f;
      const float sp = cross2(ebx, eby, dx, dy) / dsafe;
      const float tp = cross2(eax, eay, dx, dy) / dsafe;
      cm[q] = ok_den && sp >= 0.0f && sp <= 1.0f && tp >= 0.0f && tp <= 1.0f;
      cx[q] = ax + sp * eax;
      cy[q] = ay + sp * eay;
    }
  }
  // _reduce4: centroid of the candidates, then the four picks
  float mx = 0.0f, my = 0.0f;
  int mc = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    mx += cm[q] ? cx[q] : 0.0f;
    my += cm[q] ? cy[q] : 0.0f;
    mc += cm[q];
  }
  mc = warp_sum(mc);
  const float mden = fmaxf(static_cast<float>(mc), 1.0f);
  const float gx = warp_sum(mx) / mden, gy = warp_sum(my) / mden;
  Pick<true, 2> q0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const float pt[2] = {cx[q], cy[q]};
    q0.offer(cm[q] ? sq2(cx[q] - gx, cy[q] - gy) : -1.0f, t + kWarp * q, pt);
  }
  q0.reduce();
  Pick<true, 2> q1;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const float pt[2] = {cx[q], cy[q]};
    q1.offer(cm[q] ? sq2(cx[q] - q0.p[0], cy[q] - q0.p[1]) : -1.0f,
             t + kWarp * q, pt);
  }
  q1.reduce();
  const float ux = q1.p[0] - q0.p[0], uy = q1.p[1] - q0.p[1];
  Pick<true, 2> q2;
  Pick<false, 2> q3;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const float pt[2] = {cx[q], cy[q]};
    const float area = cross2(ux, uy, cx[q] - q0.p[0], cy[q] - q0.p[1]);
    q2.offer(cm[q] ? area : -INFINITY, t + kWarp * q, pt);
    q3.offer(cm[q] ? area : INFINITY, t + kWarp * q, pt);
  }
  q2.reduce();
  q3.reduce();
  float px4[4] = {q0.p[0], q1.p[0], q2.p[0], q3.p[0]};
  float py4[4] = {q0.p[1], q1.p[1], q2.p[1], q3.p[1]};
  const bool any_pt = mc > 0;
  const float athr = 1e-12f * rb * rb;
  const bool keep[4] = {any_pt, any_pt, q2.v > athr, q3.v < -athr};
  const float tol = 1e-4f * rb, tol2 = tol * tol;
  bool m4[4];
  for (int a = 0; a < 4; ++a) {
    bool dup = false;
    for (int b = 0; b < a; ++b)
      dup = dup || (sq2(px4[a] - px4[b], py4[a] - py4[b]) < tol2 && keep[b]);
    m4[a] = keep[a] && !dup;
  }
  const bool empty = !(m4[0] || m4[1] || m4[2] || m4[3]);
  if (empty) {
    // the midpoint of the closest boundary points of A's ring and B's
    // (B's in its own order)
    Pick<false, 2> cl;
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      const int c = t + kWarp * q, i = c / kPoly, j = c % kPoly;
      const int i1 = (i + 1) % kPoly, j0 = kPoly - 1 - j,
                j1 = kPoly - 1 - (j + 1) % kPoly;
      float mid[2];
      const float d2 = seg_mid(s.a[i][0], s.a[i][1], s.a[i1][0], s.a[i1][1],
                               s.b[j0][0], s.b[j0][1], s.b[j1][0],
                               s.b[j1][1], mid);
      cl.offer(d2, c, mid);
    }
    cl.reduce();
    for (int a = 0; a < 4; ++a) {
      px4[a] = cl.p[0];
      py4[a] = cl.p[1];
      m4[a] = a == 0;
    }
  }
  // a cylinder side contact: the segment's midpoint as the interior
  // witness
  const float window = kFeatWindow * rb;
  const bool sideA = A.cyl[0] > 0.5f && A.cyl[2] * fabsf(dot(n, A.aw)) <
                                            window;
  const bool sideB = B.cyl[0] > 0.5f && B.cyl[2] * fabsf(dot(n, B.aw)) <
                                            window;
  if ((sideA || sideB) && m4[0] && m4[1] && !empty) {
    px4[2] = px4[3] = 0.5f * (px4[0] + px4[1]);
    py4[2] = py4[3] = 0.5f * (py4[0] + py4[1]);
    m4[2] = true;
    m4[3] = false;
  }
  // out: the points on the mid-surface plane
  if (t < 12) {
    const int r = t / 3, c = t % 3;
    const float t1c = c == 0 ? t1.x : (c == 1 ? t1.y : t1.z);
    const float t2c = c == 0 ? t2.x : (c == 1 ? t2.y : t2.z);
    const float nc = c == 0 ? n.x : (c == 1 ? n.y : n.z);
    p_o[t] = (px4[r] * t1c + py4[r] * t2c) + c_mid * nc;
  }
  if (t < 4) d_o[t] = m4[t] && ok ? -dep : kMiss;
  if (t < 3) n_o[t] = t == 0 ? n.x : (t == 1 ? n.y : n.z);
  if (t == 0) {
    ok_out[lane] = ok;
    sepd[lane] = dep <= 0.0f && dep > -1e8f ? -dep : 0.0f;
  }
}

}  // namespace

// Per lane: wA/wB (V, 3) world and vlA/vlB (V, 3) local vertices, vmA/vmB
// (V,), nfA/nfB (F, 3) world face normals, fmA/fmB (F,), pA/pB (3,),
// RA/RB (3, 3), cylA/cylB (3,), hidA/hidB int64 (-1: no hull), depth (),
// n (3,), enabled bool; fpoly (nh, F, 16, 3) shared by the lanes ->
// dist (4,), pos (4, 3), n_out (3,), ok bool, sepd (): contiguous on the
// device with a leading lane axis N.  Returns the cudaError_t of the
// launch (0 = cudaSuccess); 1 for sizes it does not take.
extern "C" int feature_clip_f32(
    const float* wA, const float* wB, const float* vlA, const float* vlB,
    const float* vmA, const float* vmB, const float* nfA, const float* nfB,
    const float* fmA, const float* fmB, const float* pA, const float* pB,
    const float* RA, const float* RB, const float* cylA, const float* cylB,
    const long long* hidA, const long long* hidB, const float* fpoly,
    const float* depth, const float* n, const bool* enabled, float* dist,
    float* pos, float* n_out, bool* ok, float* sepd, int N, int V, int F,
    void* stream) {
  if (N < 0 || V < 1 || F < 1) return 1;
  if (N == 0) return 0;
  const int blocks = (N + kWarps - 1) / kWarps;
  feature_clip_kernel<<<blocks, kWarps * kWarp, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      wA, wB, vlA, vlB, vmA, vmB, nfA, nfB, fmA, fmB, pA, pB, RA, RB, cylA,
      cylB, hidA, hidB, fpoly, depth, n, enabled, dist, pos, n_out, ok, sepd,
      N, V, F);
  return static_cast<int>(cudaGetLastError());
}
