// Face-SAT depth query with the reference plane returned, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel benchmarks/pallas_sat_proto.py
// `make_kernel`.  Per instance (V points of one hull in the frame of another
// hull with F face planes, a 0/1 mask over the points): the support
// distances (1e9 for a masked point), the per-face minimum, the SAT
// separation and the reference face (lowest index on ties), the depths
// along it (1e9 masked), the K smallest depths with their indices (lowest
// index on ties; a picked entry is set to 1e9, so once only masked entries
// remain the lowest index is picked again, as in the TPU kernel), the
// reference plane (normal and offset) and sep.  Unlike hull_sat.cu it has
// no lateral filter and returns the plane's offset.  It computes what the
// TPU kernel computes and keeps none of its layout (instances on 128
// lanes, (V, 3, L) transposes, padding to 128).
//
// The query itself is csrc/face_sat.cuh (satk::run), shared with
// hull_sat.cu: its note says what bounds the query on this card (bytes
// nominally, then issue slots: 1.5 KB and 32 x 60 pairs an instance at
// V = 32, F = 60) and what the design does about it.  This file picks the
// variant: no filter, 1e9 exclusion, the plane and int32 indices.
//
// Built with -fmad=false (see support.cuh).  Loaded with ctypes by
// ops/face_sat.py.
#include "face_sat.cuh"

namespace {

template <class L>
__global__ void __launch_bounds__(satk::kMaxWarpsPerBlock* hullk::kWarp)
    face_sat_kernel(const satk::Query q) {
  satk::run<L, satk::Variant</*Lateral=*/false, /*ExclInf=*/false,
                             /*PlaneOut=*/true>>(q);
}

template <class L>
int launch_variant(const satk::Query& q, cudaStream_t stream) {
  return satk::launch<L>(face_sat_kernel<L>, q, stream);
}

}  // namespace

// pts (N, V, 3), planes (N, F, 4), mask (N, V) -> depth (N, K), idx (N, K)
// int32, plane (N, 4), sep (N,): contiguous on the device.  Returns the
// cudaError_t of the launch (0 = cudaSuccess); 1 for sizes the kernel does
// not take (K must not exceed V; a team's tables must fit the card's
// shared memory, as for hull_sat_f32).
extern "C" int face_sat_f32(const float* pts, const float* planes,
                            const float* mask, float* depth, int* idx,
                            float* plane, float* sep, int N, int V, int F,
                            int K, void* stream) {
  if (N < 0 || V < 1 || F < 1 || K < 1 || K > V) return 1;
  if (N == 0) return 0;
  const satk::Query q{pts,   planes, mask, nullptr, 0.0f, depth, idx,
                      plane, sep,    N,    V,       F,    K};
  return SATK_DISPATCH(V, launch_variant, q, static_cast<cudaStream_t>(stream));
}
