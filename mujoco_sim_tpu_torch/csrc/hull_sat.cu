// Hull face-SAT reference-face depth query on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mujoco_sim_tpu/ops/pallas_sat.py
// `_make_kernel` (public `hull_ref_face_depth`).  Per instance (one hull's
// V points in the frame of another hull with F face planes): the support
// distances, the per-face minimum, the SAT separation and the reference
// face (lowest index on ties), the points' depths along its normal, the
// optional lateral filter (drop a point whose maximum over faces exceeds
// max(depth, 0) + slack + 1e-4, unless that drops every point), and the K
// smallest depths with their indices (lowest index on ties; a pick is
// excluded with +inf, which also beats the 1e9 of filtered and masked
// entries, so no pass re-picks an index).  It computes what the TPU kernel
// computes and keeps none of its layout (instances on 128 lanes, (V, 3, L)
// transposes, lane padding).
//
// The query itself is csrc/face_sat.cuh (satk::run), shared with
// face_sat.cu: its note says what bounds the query on this card (bytes
// nominally, then issue slots) and what the design does about it (the
// support tensor once, in registers, over a 2-D grid of point and face
// groups; picks in registers; cp.async double buffering over a persistent
// grid).  This file picks the variant: the filter as a compile-time
// switch, +inf exclusion, the reference normal and int64 indices.  A
// missing mask and a scalar slack reach the kernel as null pointers and a
// float.
//
// Built with -fmad=false (see support.cuh).  Loaded with ctypes by
// ops/hull_sat.py.
#include "face_sat.cuh"

namespace {

template <class L, bool kLateral>
__global__ void __launch_bounds__(satk::kMaxWarpsPerBlock* hullk::kWarp)
    hull_sat_kernel(const satk::Query q) {
  satk::run<L, satk::Variant<kLateral, /*ExclInf=*/true, /*PlaneOut=*/false>>(
      q);
}

template <class L>
int launch_variant(const satk::Query& q, int lateral, cudaStream_t stream) {
  return lateral ? satk::launch<L>(hull_sat_kernel<L, true>, q, stream)
                 : satk::launch<L>(hull_sat_kernel<L, false>, q, stream);
}

}  // namespace

// pts (N, V, 3), planes (N, F, 4), mask (N, V) or null (every point live),
// slack (N,) or null (slack_scalar for every instance) -> depth (N, K), idx
// (N, K) int64, nref (N, 3), sep (N,): contiguous on the device.  Returns
// the cudaError_t of the launch (0 = cudaSuccess); 1 for sizes the kernel
// does not take (K must be below V; a team's double buffer, 32 (V + F + 1)
// bytes, plus 4 (F + 2 V) bytes of scratch above V = 32, must fit the
// card's shared memory, four teams a warp up to V = 32).
extern "C" int hull_sat_f32(const float* pts, const float* planes,
                            const float* mask, const float* slack,
                            float* depth, long long* idx, float* nref,
                            float* sep, int N, int V, int F, int K,
                            int lateral, float slack_scalar, void* stream) {
  if (N < 0 || V < 1 || F < 1 || K < 1 || K >= V) return 1;
  if (N == 0) return 0;
  const satk::Query q{pts, planes, mask,  slack, slack_scalar, depth,
                      idx, nref,   sep,   N,     V,            F,
                      K};
  return SATK_DISPATCH(V, launch_variant, q, lateral,
                       static_cast<cudaStream_t>(stream));
}
