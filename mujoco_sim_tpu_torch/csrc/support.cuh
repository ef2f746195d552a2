// Shared device helpers of the convex-hull collision kernels (sm_90a):
// the support scan of one unit axis over a vertex cloud held in shared
// memory, the analytic cylinder support, and warp reductions on
// (value, index) pairs whose ties go to the lowest index.
//
// All arithmetic is written as separate multiplies and adds in the order of
// the plain PyTorch twins ((x*a + y*b) + z*c); the sources that include this
// header are built with -fmad=false so nvcc does not contract them.
#pragma once
#include <cuda_runtime.h>

namespace hullk {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// (min, max) over the V vertices w[v*3 + c] (shared memory) of axis . vertex.
// Unmasked: the hull tables pad by repeating a real vertex, so a pad never
// moves either extreme.
__device__ __forceinline__ void support_scan(const float* __restrict__ w,
                                             int V, float ax, float ay,
                                             float az, float& mn, float& mx) {
  float lo = INFINITY, hi = -INFINITY;
  for (int v = 0; v < V; ++v) {
    const float p = dot3(ax, ay, az, w[3 * v], w[3 * v + 1], w[3 * v + 2]);
    lo = fminf(lo, p);
    hi = fmaxf(hi, p);
  }
  mn = lo;
  mx = hi;
}

// The same scan for T axes at once over vertices stored as float4
// (x, y, z, unused): one 16-byte broadcast load a vertex serves all T axes,
// and each axis-vertex product keeps the order of support_scan.
template <int T>
__device__ __forceinline__ void support_scan_block(
    const float4* __restrict__ w, int V, const float (&ax)[T],
    const float (&ay)[T], const float (&az)[T], float (&mn)[T],
    float (&mx)[T]) {
#pragma unroll
  for (int t = 0; t < T; ++t) {
    mn[t] = INFINITY;
    mx[t] = -INFINITY;
  }
  for (int v = 0; v < V; ++v) {
    const float4 q = w[v];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float p = dot3(ax[t], ay[t], az[t], q.x, q.y, q.z);
      mn[t] = fminf(mn[t], p);
      mx[t] = fmaxf(mx[t], p);
    }
  }
}

// Exact support extents of a cylinder (centre cen, axis aw, radius r,
// half-height hh) along the unit axis a: [dc - ext, dc + ext].
__device__ __forceinline__ void cyl_extent(float ax, float ay, float az,
                                           const float* aw, const float* cen,
                                           float r, float hh, float& mn,
                                           float& mx) {
  const float da = dot3(ax, ay, az, aw[0], aw[1], aw[2]);
  const float dperp = sqrtf(fmaxf(1.0f - da * da, 0.0f));
  const float ext = hh * fabsf(da) + r * dperp;
  const float dc = dot3(ax, ay, az, cen[0], cen[1], cen[2]);
  mn = dc - ext;
  mx = dc + ext;
}

// true when (v, i) comes before (bv, bi) in "smaller value, then lower index"
__device__ __forceinline__ bool less_vi(float v, int i, float bv, int bi) {
  return (v < bv) | ((v == bv) & (i < bi));  // no short circuit: no branch
}

// Warp-wide argmin with lowest-index ties; every lane gets the result.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (less_vi(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Warp-wide argmax with lowest-index ties; every lane gets the result.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

}  // namespace hullk
