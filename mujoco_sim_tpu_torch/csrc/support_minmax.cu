// Support extents of a vertex cloud along many axes on Hopper (sm_90a):
// mn[i, c] = min_v axes[i, c] . w[i, v],  mx[i, c] = max_v of the same.
//
// Replaces the Pallas TPU kernel mujoco_sim_tpu/ops/pallas_support.py
// `_make_kernel` (public `support_minmax`).  Same function, natural (N, C, 3)
// / (N, V, 3) layouts: the TPU kernel's lane-major transposes, its padding
// of the instance axis to 128 lanes and its chunking for scoped VMEM are not
// carried over.
//
// What bounds it on this card: bytes, with issue close behind.  Per
// instance it reads 12 (C + V) bytes and writes 8 C, against C V axis-vertex
// products of 7 issue slots each (3 multiplies, 2 adds, a min and a max:
// no FMA, see below); at N = 8192, V = 24 the bytes take 4.0 / 13.2 us at
// C = 68 / 256 and the products ~3.3 / ~12 us of the SMs' issue slots.  So
// the design has to keep the memory system busy while the arithmetic runs,
// waste no lanes on absent axes, and add little issue of its own:
//
//  * a persistent grid of warps, each walking a strided list of work items
//    (a group of instances and a chunk of their axes) with its own
//    double-buffered stage in shared memory: the next item's vertices and
//    axes are in flight (cp.async) while the current one is scanned;
//  * a team of lanes per instance with T axes a lane, in two layouts
//    picked from C: up to C = 72, teams of 8 lanes x 9 axes (4 instances
//    a warp: C = 68 leaves 4 of 72 slots idle); wider, a warp of 32
//    lanes x 8 axes an instance, in chunks of 256 axes (C = 256: none
//    idle);
//  * the vertices staged once an item as float4, repacked from the 12-byte
//    rows on the way in (stage_rows_f4), and scanned T axes a lane per
//    16-byte broadcast load (support_scan_acc, shared with mtv_query);
//    vertex clouds larger than the stage are scanned tile by tile, so any
//    V runs; the teams' clouds are staggered by an odd number of 16-byte
//    slots so the broadcast loads of four teams hit different banks;
//  * the axes copied as contiguous runs (16 bytes a copy when aligned),
//    read from shared memory into registers once an item; mn and mx stored
//    straight from registers, a team writing consecutive floats.
//
// Built with -fmad=false (see support.cuh): the twin rounds each product
// as separate multiplies and adds, so the kernel's results are the twin's
// bit for bit.  Loaded with ctypes by ops/support_minmax.py.
#include "async_copy.cuh"
#include "support.cuh"

namespace {

using namespace hullk;

constexpr int kWarps = 4;            // warps a block
constexpr int kStageVerts = 256;     // float4 vertex slots a warp stage holds

// Shared-memory plan of one warp: two stages, each the axes of its item's
// instances (astride floats each) and their vertex tiles (vstride float4
// each).
struct Plan {
  int G;        // instances a warp
  int chunk;    // axes an instance per item (Team x T)
  int nchunk;   // items per instance group
  int tv;       // vertices a tile
  int ntiles;   // tiles per item
  int astride;  // floats of axes per instance in a stage
  int vstride;  // float4 slots per instance in a stage (odd)
  int vbase;    // float offset of the vertex tiles in a stage
  int stage;    // floats per stage (a multiple of 4)
};

__host__ __device__ inline Plan make_plan(int team, int T, int C, int V) {
  Plan p;
  p.G = kWarp / team;
  p.chunk = team * T;
  p.nchunk = (C + p.chunk - 1) / p.chunk;
  const int tvmax = kStageVerts / p.G;
  p.tv = V < tvmax ? V : tvmax;
  p.ntiles = (V + p.tv - 1) / p.tv;
  p.astride = 3 * (C < p.chunk ? C : p.chunk);
  p.vstride = p.tv | 1;
  p.vbase = (p.G * p.astride + 3) & ~3;
  p.stage = p.vbase + 4 * p.G * p.vstride;
  return p;
}

// A warp's place in its strided walk over the work items (instance group
// g, axis chunk ch, vertex tile k), advanced without dividing: the item
// index never needs to be split again.
struct Cursor {
  long long g;
  int ch, k;
};

// Issue the copies of one stage: item (group g, chunk ch), vertex tile k.
// The axes come with the first tile only.
__device__ __forceinline__ void issue_stage(
    float* buf, const Plan& p, const float* __restrict__ axes,
    const float* __restrict__ w, long long N, int C, int V, long long g,
    int ch, int k, int lane) {
  const long long i0 = g * p.G;
  const int ninst = static_cast<int>(N - i0 < p.G ? N - i0 : p.G);
  if (k == 0) {
    if (p.nchunk == 1) {
      // all C axes of the group's instances: one contiguous run
      asynccopy::copy_warp(buf, axes + 3 * i0 * C, 3 * C * ninst, lane);
    } else {
      const int c0 = ch * p.chunk;
      const int nc = C - c0 < p.chunk ? C - c0 : p.chunk;
      for (int j = 0; j < ninst; ++j)
        asynccopy::copy_warp(buf + j * p.astride,
                             axes + 3 * ((i0 + j) * C + c0), 3 * nc, lane);
    }
  }
  const int v0 = k * p.tv;
  const int n = V - v0 < p.tv ? V - v0 : p.tv;
  float4* vt = reinterpret_cast<float4*>(buf + p.vbase);
  for (int j = 0; j < ninst; ++j)
    stage_rows_f4(vt + j * p.vstride, w + 3 * ((i0 + j) * V + v0), n, lane,
                  kWarp);
}

template <int Team, int T>
__global__ void __launch_bounds__(kWarps* kWarp)
    support_minmax_kernel(const float* __restrict__ axes,
                          const float* __restrict__ w, float* __restrict__ mn,
                          float* __restrict__ mx, long long N, int C, int V) {
  extern __shared__ __align__(16) float smem[];
  const Plan p = make_plan(Team, T, C, V);
  const int lane = threadIdx.x % kWarp;
  const int team = lane / Team, rank = lane % Team;
  float* const buf0 = smem + (threadIdx.x / kWarp) * 2 * p.stage;
  const long long ngroups = (N + p.G - 1) / p.G;
  // the walk: items w0, w0 + W, w0 + 2 W, ... of W warps, as (g, ch)
  const long long W = static_cast<long long>(gridDim.x) * (blockDim.x / kWarp);
  const long long w0 = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  const long long dg = W / p.nchunk;
  const int dch = static_cast<int>(W % p.nchunk);
  Cursor at{w0 / p.nchunk, static_cast<int>(w0 % p.nchunk), 0};
  int cur = 0;
  if (at.g < ngroups) issue_stage(buf0, p, axes, w, N, C, V, at.g, at.ch, 0,
                                  lane);
  asynccopy::commit();

  float ax[T], ay[T], az[T], lo[T], hi[T];
  while (at.g < ngroups) {
    // the next stage goes in flight before this one is scanned
    Cursor nx = at;
    if (++nx.k == p.ntiles) {
      nx.k = 0;
      nx.g += dg;
      nx.ch += dch;
      if (nx.ch >= p.nchunk) {
        nx.ch -= p.nchunk;
        ++nx.g;
      }
    }
    if (nx.g < ngroups)
      issue_stage(buf0 + (cur ^ 1) * p.stage, p, axes, w, N, C, V, nx.g,
                  nx.ch, nx.k, lane);
    asynccopy::commit();
    asynccopy::wait_pending<1>();
    __syncwarp();

    const float* buf = buf0 + cur * p.stage;
    const long long inst = at.g * p.G + team;
    const int c0 = at.ch * p.chunk;
    const int tile = at.k;
    if (tile == 0) {
      const float* a = buf + team * p.astride;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int c = t * Team + rank;  // within the chunk
        const bool live = inst < N && c0 + c < C;
        ax[t] = live ? a[3 * c] : 0.0f;
        ay[t] = live ? a[3 * c + 1] : 0.0f;
        az[t] = live ? a[3 * c + 2] : 0.0f;
      }
      scan_init(lo, hi);
    }
    const int n = V - tile * p.tv < p.tv ? V - tile * p.tv : p.tv;
    support_scan_acc<T>(
        reinterpret_cast<const float4*>(buf + p.vbase) + team * p.vstride, n,
        ax, ay, az, lo, hi);
    if (tile == p.ntiles - 1 && inst < N) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int c = c0 + t * Team + rank;
        if (c < C) {
          mn[inst * C + c] = lo[t];
          mx[inst * C + c] = hi[t];
        }
      }
    }
    __syncwarp();  // every lane is done with this stage before it is reused
    at = nx;
    cur ^= 1;
  }
  asynccopy::wait_all();
}

template <int Team, int T>
int launch(const float* axes, const float* w, float* mn, float* mx,
           long long N, int C, int V, cudaStream_t stream) {
  const auto kernel = support_minmax_kernel<Team, T>;
  const Plan p = make_plan(Team, T, C, V);
  const size_t smem = sizeof(float) * 2 * p.stage * kWarps;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                kWarps * kWarp, smem);
  // as many blocks as fit at once, or one a kWarps items
  const long long nitems = (N + p.G - 1) / p.G * p.nchunk;
  long long blocks = (nitems + kWarps - 1) / kWarps;
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  kernel<<<static_cast<unsigned>(blocks), kWarps * kWarp, smem, stream>>>(
      axes, w, mn, mx, N, C, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// axes (N, C, 3), w (N, V, 3) -> mn, mx (N, C): contiguous float32 on the
// device.  Returns the cudaError_t of the launch (0 = cudaSuccess); 1 for
// sizes the kernel does not take (N < 0, C < 1, V < 1).
extern "C" int support_minmax_f32(const float* axes, const float* w, float* mn,
                                  float* mx, long long N, int C, int V,
                                  void* stream) {
  if (N < 0 || C < 1 || V < 1) return 1;
  if (N == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 8 * 9) return launch<8, 9>(axes, w, mn, mx, N, C, V, s);
  return launch<32, 8>(axes, w, mn, mx, N, C, V, s);
}
