// Hull face-SAT reference-face depth query on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mujoco_sim_tpu/ops/pallas_sat.py
// `_make_kernel` (public `hull_ref_face_depth`).  Per instance (one hull's
// V points in the frame of another hull with F face planes):
//
//   support distances vals[v, f] = pts[v] . n_f - d_f   (1e9 for masked v)
//   per-face min over v  ->  sep = max over f, reference face = first f
//   with pfm[f] >= sep   ->  depth[v] = pts[v] . n_ref - d_ref
//   optional lateral filter: drop v whose max-over-faces sdf exceeds
//   max(depth, 0) + slack + 1e-4, unless that drops every v
//   ->  the K smallest depths and their vertex indices (lowest index on
//   ties; a picked entry is excluded with +inf, which also beats the 1e9
//   of filtered entries, so no pass re-picks an index).
//
// It computes what the TPU kernel computes and keeps none of its layout
// (instances on 128 lanes, (V, 3, L) transposes, lane padding).
//
// What bounds it on this card: bytes, nominally.  An instance reads
// 4 (4 V + 4 F + 1) bytes and writes 4 (3 K + 4), against ~8 V F flops
// (16 V F with the lateral filter): at V = 24, F = 44 about 1.1 KB and
// 8.4-17 kFLOP, 8-15 flop/byte, under the ~20 flop/byte f32 balance of the
// card.  The plain version materializes the (N, V, F) tensor in device
// memory and re-reads it for each reduction.  What this design does about
// it: one warp per instance stages points, planes and mask in shared
// memory with coalesced loads and never writes vals anywhere; lanes stride
// over faces for the per-face min and over vertices for depth and filter,
// every cross-lane step is a shuffle reduction on (value, index), and a
// block carries several instances so small V and F still fill the SMs.
// The serial tail (K argmin passes, each a 5-step shuffle) is latency, not
// bandwidth; at the sizes the step uses it is a few hundred cycles.
//
// Built with -fmad=false (see support.cuh): the reference face and the K
// picks are float comparisons, and the plain twin does not contract.
// Loaded with ctypes by ops/hull_sat.py.
#include "support.cuh"

namespace {

using namespace hullk;

constexpr float kBig = 1e9f;
constexpr int kWarpsPerBlock = 4;

__global__ void hull_sat_kernel(const float* __restrict__ pts,
                                const float* __restrict__ planes,
                                const float* __restrict__ mask,
                                const float* __restrict__ slack,
                                float* __restrict__ depth_out,
                                long long* __restrict__ idx_out,
                                float* __restrict__ nref_out,
                                float* __restrict__ sep_out, int N, int V,
                                int F, int K, int lateral) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const long long inst =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (inst >= N) return;  // whole warp leaves together

  const int per_warp = 6 * V + 4 * F;
  float* sp = smem + warp * per_warp;  // V * 3 points
  float* sm = sp + 3 * V;              // V mask
  float* sd = sm + V;                  // V depths
  float* sk = sd + V;                  // V lateral-filter keep flags
  float* spl = sk + V;                 // F * 4 planes

  const float* gp = pts + inst * V * 3;
  const float* gpl = planes + inst * F * 4;
  const float* gm = mask + inst * V;
  for (int t = lane; t < 3 * V; t += kWarp) sp[t] = gp[t];
  for (int t = lane; t < V; t += kWarp) sm[t] = gm[t];
  for (int t = lane; t < 4 * F; t += kWarp) spl[t] = gpl[t];
  __syncwarp();

  // per-face min over the (masked) points; reference face = argmax with
  // the lowest index on ties
  float best = -INFINITY;
  int bestf = F;
  for (int f = lane; f < F; f += kWarp) {
    const float n0 = spl[4 * f], n1 = spl[4 * f + 1], n2 = spl[4 * f + 2];
    const float nd = spl[4 * f + 3];
    float pfm = INFINITY;
    for (int v = 0; v < V; ++v) {
      const float val =
          sm[v] > 0.5f
              ? dot3(sp[3 * v], sp[3 * v + 1], sp[3 * v + 2], n0, n1, n2) - nd
              : kBig;
      pfm = fminf(pfm, val);
    }
    if (pfm > best || bestf == F) {  // f ascends: strict > keeps the first
      best = pfm;
      bestf = f;
    }
  }
  warp_argmax(best, bestf);
  const float sep = best;
  const int ref = bestf < F ? bestf : 0;
  const float r0 = spl[4 * ref], r1 = spl[4 * ref + 1], r2 = spl[4 * ref + 2];
  const float rd = spl[4 * ref + 3];

  // depth of every point along the reference normal (+ lateral filter)
  const float slk = lateral ? slack[inst] + 1e-4f : 0.0f;
  bool any_keep = false;
  for (int v = lane; v < V; v += kWarp) {
    const float px = sp[3 * v], py = sp[3 * v + 1], pz = sp[3 * v + 2];
    float dep = dot3(px, py, pz, r0, r1, r2) - rd;
    if (lateral) {
      float sdf = -INFINITY;
      if (sm[v] > 0.5f) {
        for (int f = 0; f < F; ++f)
          sdf = fmaxf(sdf, dot3(px, py, pz, spl[4 * f], spl[4 * f + 1],
                                spl[4 * f + 2]) - spl[4 * f + 3]);
      } else {
        sdf = kBig;
      }
      const bool keep = sdf <= fmaxf(dep, 0.0f) + slk;
      any_keep |= keep;
      sk[v] = keep ? 1.0f : 0.0f;
    }
    sd[v] = dep;
  }
  // if the filter would drop every point, it drops none
  any_keep = __any_sync(kFull, any_keep);
  for (int v = lane; v < V; v += kWarp) {
    const bool keep = !lateral || !any_keep || sk[v] > 0.5f;
    if (!keep || !(sm[v] > 0.5f)) sd[v] = kBig;
  }
  __syncwarp();

  // K smallest depths, lowest index on ties
  for (int k = 0; k < K; ++k) {
    float bv = INFINITY;
    int bi = V;
    for (int v = lane; v < V; v += kWarp) {
      const float x = sd[v];
      if (x < bv || bi == V) {  // v ascends: strict < keeps the first
        bv = x;
        bi = v;
      }
    }
    warp_argmin(bv, bi);
    if (bi >= V) bi = 0;
    if (lane == 0) {
      depth_out[inst * K + k] = bv;
      idx_out[inst * K + k] = bi;
      sd[bi] = INFINITY;
    }
    __syncwarp();
  }
  if (lane == 0) {
    nref_out[inst * 3 + 0] = r0;
    nref_out[inst * 3 + 1] = r1;
    nref_out[inst * 3 + 2] = r2;
    sep_out[inst] = sep;
  }
}

}  // namespace

// pts (N, V, 3), planes (N, F, 4), mask (N, V), slack (N,) -> depth (N, K),
// idx (N, K) int64, nref (N, 3), sep (N,): contiguous on the device.
// Returns the cudaError_t of the launch (0 = cudaSuccess); 1 for sizes the
// kernel does not take (K must be below V; an instance must fit 12 KB of
// shared memory).
extern "C" int hull_sat_f32(const float* pts, const float* planes,
                            const float* mask, const float* slack,
                            float* depth, long long* idx, float* nref,
                            float* sep, int N, int V, int F, int K,
                            int lateral, void* stream) {
  const size_t per_warp = (6 * V + 4 * F) * sizeof(float);
  if (N < 0 || V < 1 || F < 1 || K < 1 || K >= V ||
      per_warp * kWarpsPerBlock > 48 * 1024)
    return 1;
  if (N == 0) return 0;
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  hull_sat_kernel<<<blocks, kWarpsPerBlock * hullk::kWarp,
                    per_warp * kWarpsPerBlock,
                    static_cast<cudaStream_t>(stream)>>>(
      pts, planes, mask, slack, depth, idx, nref, sep, N, V, F, K, lateral);
  return static_cast<int>(cudaGetLastError());
}
