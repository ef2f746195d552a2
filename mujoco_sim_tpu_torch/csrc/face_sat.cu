// Face-SAT depth query with the reference plane returned, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel benchmarks/pallas_sat_proto.py
// `make_kernel`.  Per instance (V points of one hull in the frame of another
// hull with F face planes, a 0/1 mask over the points):
//
//   support distances vals[v, f] = pts[v] . n_f - d_f   (1e9 for masked v)
//   per-face min over v  ->  sep = max over f, reference face = lowest f
//   with pfm[f] >= sep   ->  depth[v] = pts[v] . n_ref - d_ref (1e9 masked)
//   ->  the K smallest depths and their vertex indices, lowest index on
//   ties; a picked entry is set to 1e9 (so once only masked entries remain
//   the lowest index is picked again, as in the TPU kernel)
//   ->  the reference plane (normal and offset) and sep.
//
// Unlike hull_sat.cu it has no lateral filter and returns the plane's
// offset.  It computes what the TPU kernel computes and keeps none of its
// layout (instances on 128 lanes, (V, 3, L) transposes, padding to 128).
//
// What bounds it on this card: bytes, nominally (4 (4 V + 4 F) read and
// 4 (2 K + 5) written per instance against ~8 V F flops: 1.5 KB and
// 15 kFLOP at V = 32, F = 60, ~10 flop/byte, under the card's ~20 flop/byte
// f32 balance).  The plain version writes the (N, V, F) tensor to device
// memory and re-reads it.  The design is hull_sat.cu's: one warp per
// instance, points, planes and mask staged once in shared memory with
// coalesced loads, lanes striding faces then vertices, every cross-lane
// step a shuffle reduction on (value, index); several instances per block.
//
// Built with -fmad=false (see support.cuh): the reference face and the K
// picks are float comparisons, and the plain twin does not contract.
// Loaded with ctypes by ops/face_sat.py.
#include "support.cuh"

namespace {

using namespace hullk;

constexpr float kBig = 1e9f;
constexpr int kWarpsPerBlock = 4;

__global__ void face_sat_kernel(const float* __restrict__ pts,
                                const float* __restrict__ planes,
                                const float* __restrict__ mask,
                                float* __restrict__ depth_out,
                                int* __restrict__ idx_out,
                                float* __restrict__ plane_out,
                                float* __restrict__ sep_out, int N, int V,
                                int F, int K) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const long long inst =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (inst >= N) return;  // whole warp leaves together

  const int per_warp = 5 * V + 4 * F;
  float* sp = smem + warp * per_warp;  // V * 3 points
  float* sm = sp + 3 * V;              // V mask
  float* sd = sm + V;                  // V depths
  float* spl = sd + V;                 // F * 4 planes

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

  // depth of every point along the reference normal
  for (int v = lane; v < V; v += kWarp)
    sd[v] = sm[v] > 0.5f
                ? dot3(sp[3 * v], sp[3 * v + 1], sp[3 * v + 2], r0, r1, r2) - rd
                : kBig;
  __syncwarp();

  // K smallest depths, lowest index on ties; a pick is replaced by 1e9
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
      sd[bi] = kBig;
    }
    __syncwarp();
  }
  if (lane == 0) {
    plane_out[inst * 4 + 0] = r0;
    plane_out[inst * 4 + 1] = r1;
    plane_out[inst * 4 + 2] = r2;
    plane_out[inst * 4 + 3] = rd;
    sep_out[inst] = sep;
  }
}

}  // namespace

// pts (N, V, 3), planes (N, F, 4), mask (N, V) -> depth (N, K), idx (N, K)
// int32, plane (N, 4), sep (N,): contiguous on the device.  Returns the
// cudaError_t of the launch (0 = cudaSuccess); 1 for sizes the kernel does
// not take (K must not exceed V; an instance must fit 12 KB of shared
// memory).
extern "C" int face_sat_f32(const float* pts, const float* planes,
                            const float* mask, float* depth, int* idx,
                            float* plane, float* sep, int N, int V, int F,
                            int K, void* stream) {
  const size_t per_warp = (5 * V + 4 * F) * sizeof(float);
  if (N < 0 || V < 1 || F < 1 || K < 1 || K > V ||
      per_warp * kWarpsPerBlock > 48 * 1024)
    return 1;
  if (N == 0) return 0;
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  face_sat_kernel<<<blocks, kWarpsPerBlock * hullk::kWarp,
                    per_warp * kWarpsPerBlock,
                    static_cast<cudaStream_t>(stream)>>>(
      pts, planes, mask, depth, idx, plane, sep, N, V, F, K);
  return static_cast<int>(cudaGetLastError());
}
