// The pyramidal Newton solve of the constraint problem on Hopper (sm_90a):
// every env's Newton iterations and line searches in one launch, an env a
// block, each env to its own stop.
//
// Replaces no TPU kernel: the JAX package runs this loop as XLA ops
// (mujoco_sim_tpu/ops/solver.py, the Newton and line-search
// lax.while_loops under vmap).  It fuses the port's lockstep loops of
// ops/solver.solve for pyramidal and frictionless models: a WHILE node of
// ~100 plain kernels an iteration over the whole (B, nefc) batch, with the
// line search's WHILE node (~35 more an iteration) nested in it, both
// running every env's body while any env is live.  Per env it computes what
// ops/solver._newton_lockstep computes, from the carry after the best-of-two
// init (a, x = J a - aref, cost), until cost stops improving by `tol` of
// max(|cost|, 1) or `max_it` iterations:
//
//   row force f and curvature c of each row at x (one-sided rows: 0 for
//   x >= 0; friction-loss rows: D x clamped to +-floss, c = 0 on the tails);
//   grad = M (a - a_smooth) + J' f;  H = M + J' diag(c) J + ridge I with
//   ridge = 1e-7 trace(H) / nv;  p = -H^-1 grad (non-finite entries 0);
//   the 1-D Newton line search on phi'(alpha) from alpha = 1 (slope test at
//   ls_tol of |phi'(0)|, at most max_ls steps, curvature floored at 1e-8
//   p'Mp, alpha clamped to [0, 8]); the step at alpha, else at 0.5 where
//   that is lower and alpha's is not, else no step; x += alpha J p.
//
// What bounds it on this card: latency.  An env's work is small (J read
// once, 131 x 42 floats for the manip bin; ~180 kflop an iteration) and its
// iterations are a chain: the Hessian needs the last step's x, the factor
// is a chain of nv column steps, each line-search step needs the last one's
// reduction.  The lockstep loops paid ~135 launches an iteration and the
// slowest env's iteration count for every env.
//
// What this design does about it:
//  * one block of 128 threads an env; its J rows, M and row data are staged
//    in shared memory once (cp.async) and every iteration reads them there;
//    where the staged J does not fit the card's shared memory J is read
//    from device memory (newton_solve_kernel<false>);
//  * the Hessian is summed over the rows whose curvature is not zero only
//    (a warp's ballots list them in row order; a skipped row adds exactly
//    zero), a 4 x 4 register tile of its lower triangle a thread, the two
//    J row pieces of a tile read as 16-byte loads; the gradient's J' f and
//    M (a - a_smooth) run on the other warps meanwhile;
//  * the factor and both substitutions are chol_factor.cuh's panel factor
//    (factor_panels, backward_panels: warp 0 factors each 32-column
//    diagonal block in registers, the block the rest), on the Hessian where
//    it was summed, with the same 1e-30 pivot floor as chol_solve;
//  * J p reads each row as 16-byte loads (the staged rows' stride is an
//    odd multiple of 4 floats, so eight rows hit distinct banks);
//  * every reduction (the line search's two slopes a step, the two trial
//    costs, p'Mp, p'M da, da'M da and f'Jp) is a warp butterfly and a sum
//    of the warps' partials in warp order, the same on every thread: no
//    float atomics, the same bits on every run, and every thread takes the
//    same branch of each loop test.
// Arithmetic is f32 (no tensor cores, no TF32).  Elementwise terms round
// as the plain code's (built with -fmad=false: a product and a sum are two
// roundings); the sums run in another order than PyTorch's reductions and
// matrix products, so results agree with the lockstep loops to rounding,
// not bit for bit, and a stop test that sits on a rounding can flip.
//
// Build (no PyTorch headers; loaded with ctypes by ops/newton_solve.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
//        -fmad=false
#include "async_copy.cuh"
#include "chol_factor.cuh"

namespace {

using namespace cholk;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxNv = 64;
constexpr int kOneSided = 1, kFloss = 2;   // row flags
constexpr int kRed = 4;                    // values a reduction carries

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

struct Args {
  const float* M;              // (N, nv, nv)
  const float* as;             // (N, nv) a_smooth
  const float* J;              // (N, nefc, nv)
  const float* D;              // (N, nefc)
  const int* type;             // (N, nefc); >= 2: one-sided
  const float* floss;          // (N, nefc)
  const unsigned char* fon;    // (N, nefc) bool: a friction-loss row
  const float* a0;             // (N, nv) the carry after the init
  const float* x0;             // (N, nefc)
  const float* c0;             // (N,)
  float* a;                    // (N, nv) out
  float* x;                    // (N, nefc) out
  int* iters;                  // (N,) Newton iterations
  int* ls_iters;               // (N,) line-search steps, summed
  int N, nv, nefc;
  float tol, ls_tol;
  int max_it, max_ls;
};

// Floats of shared memory of one env, by part: the panel factor's (S holds
// the Hessian, stride ld), M (odd stride), six vectors of ld floats, eight
// row arrays, the reductions' double buffer and the row count, and the
// staged J (stride ld) where it is staged.
struct Sizes {
  int ld, ldm, e4, panels, m, vecs, rows, red, j;
  __host__ __device__ Sizes(int nv, int nefc, bool staged) {
    ld = panel_ld(nv, true);
    ldm = nv | 1;
    e4 = round4(nefc);
    panels = round4(panel_floats(nv, ld));
    m = round4(nv * ldm);
    vecs = 6 * ld;
    rows = 8 * e4;
    red = 2 * kRed * kWarps + 4;
    j = staged ? nefc * ld : 0;
  }
  __host__ __device__ int total() const {
    return panels + m + vecs + rows + red + j;
  }
};

// torch.maximum / minimum / clamp: a NaN operand gives NaN.
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tclamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// c'(x) and c''(x) of one row (ops/solver._row_force_and_curv).
__device__ __forceinline__ void row_fc(float x, float D, float fl, int flags,
                                       float& f, float& c) {
  const float quad = D * x;
  const bool zero_side = (flags & kOneSided) && x >= 0.0f;
  f = zero_side ? 0.0f : quad;
  c = zero_side ? 0.0f : D;
  if (flags & kFloss) {
    f = tmin(tmax(quad, -fl), fl);
    if (fabsf(quad) >= fl) c = 0.0f;
  }
}

// c(x) of one row (ops/solver._row_cost).
__device__ __forceinline__ float row_cost(float x, float D, float fl,
                                          int flags) {
  const float quad = 0.5f * D * x * x;
  float c = ((flags & kOneSided) && x >= 0.0f) ? 0.0f : quad;
  if ((flags & kFloss) && fabsf(D * x) >= fl) {
    const float tail = D > 0.0f ? fl * fl / tmax(D, 1e-12f) : 0.0f;
    c = fl * fabsf(x) - 0.5f * tail;
  }
  return c;
}

// Sum each of v[0..K) over the block; every thread gets the same sums: a
// butterfly in each warp (lanes i and i ^ o add the same two values), then
// the warps' partials in warp order.  Two buffers in turn, so one barrier
// a reduction: a buffer is written again only after the next reduction's
// barrier, which every thread reaches after reading it.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red,
                                          int& buf) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1)
      v[k] += __shfl_xor_sync(kFull, v[k], o);
  float* out = red + buf * kRed * kWarps;
  const int warp = threadIdx.x / kWarp;
  if (threadIdx.x % kWarp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k * kWarps + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = out[k * kWarps];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += out[k * kWarps + w];
    v[k] = s;
  }
  buf ^= 1;
}

// Four consecutive entries of row r of J from column c0 (c0 % 4 == 0):
// one 16-byte load from the staged rows (zero past nv), else four loads
// from device memory.
template <bool kStaged>
__device__ __forceinline__ float4 j4(const float* J, int ldj, int r, int c0,
                                     int nv) {
  if constexpr (kStaged) {
    return *reinterpret_cast<const float4*>(J + r * ldj + c0);
  } else {
    const float* row = J + static_cast<long long>(r) * ldj;
    return make_float4(c0 < nv ? row[c0] : 0.0f,
                       c0 + 1 < nv ? row[c0 + 1] : 0.0f,
                       c0 + 2 < nv ? row[c0 + 2] : 0.0f,
                       c0 + 3 < nv ? row[c0 + 3] : 0.0f);
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
    newton_solve_kernel(const Args g) {
  extern __shared__ __align__(16) float smem[];
  const int nv = g.nv, nefc = g.nefc, tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const long long env = blockIdx.x;
  const Sizes z(nv, nefc, kStaged);
  const int ld = z.ld, ldm = z.ldm;

  const Panels pan(smem, nv, ld);
  float* Ms = smem + z.panels;
  float* a = Ms + z.m;
  float* as = a + ld;
  float* da = as + ld;
  float* Mda = da + ld;
  float* pv = Mda + ld;
  float* Mp = pv + ld;
  float* x = Mp + ld;
  float* Jp = x + z.e4;
  float* D = Jp + z.e4;
  float* fl = D + z.e4;
  float* curv = fl + z.e4;
  float* f = curv + z.e4;
  int* flags = reinterpret_cast<int*>(f + z.e4);
  int* list = flags + z.e4;
  float* red = reinterpret_cast<float*>(list + z.e4);
  int* nlist = reinterpret_cast<int*>(red + 2 * kRed * kWarps);
  float* Js = red + z.red;

  // ---- stage the env's inputs
  const float* Jg = g.J + env * nefc * nv;
  const float* J = kStaged ? Js : Jg;
  const int ldj = kStaged ? ld : nv;
  const unsigned magic = div_magic(nv);
  if constexpr (kStaged) {
    for (unsigned t = tid; t < static_cast<unsigned>(nefc * nv);
         t += kThreads) {
      const unsigned r = nv == 1 ? t : __umulhi(t, magic);
      asynccopy::copy_f32(Js + r * ld + (t - r * nv), Jg + t);
    }
    const int pad = ld - nv;  // > 0 but where nv is an odd multiple of 4
    if (pad > 0)
      for (int t = tid; t < nefc * pad; t += kThreads)
        Js[(t / pad) * ld + nv + t % pad] = 0.0f;
  }
  const float* Mg = g.M + env * nv * nv;
  for (unsigned t = tid; t < static_cast<unsigned>(nv * nv); t += kThreads) {
    const unsigned r = nv == 1 ? t : __umulhi(t, magic);
    asynccopy::copy_f32(Ms + r * ldm + (t - r * nv), Mg + t);
  }
  for (int i = tid; i < ld; i += kThreads) {
    const bool in = i < nv;
    a[i] = in ? g.a0[env * nv + i] : 0.0f;
    as[i] = in ? g.as[env * nv + i] : 0.0f;
    da[i] = Mda[i] = pv[i] = Mp[i] = 0.0f;
  }
  for (int r = tid; r < nefc; r += kThreads) {
    const long long e = env * nefc + r;
    x[r] = g.x0[e];
    D[r] = g.D[e];
    fl[r] = g.floss[e];
    flags[r] = (g.type[e] >= 2 ? kOneSided : 0) | (g.fon[e] ? kFloss : 0);
  }
  float cost = g.c0[env];
  asynccopy::wait_all();
  __syncthreads();

  const int T = (nv + 3) / 4, tiles = T * (T + 1) / 2;
  int buf = 0, it = 0, ls_total = 0;
  bool done = false;
  while (it < g.max_it && !done) {
    // ---- each row's force and curvature at x; a - a_smooth
    for (int r = tid; r < nefc; r += kThreads)
      row_fc(x[r], D[r], fl[r], flags[r], f[r], curv[r]);
    for (int i = tid; i < nv; i += kThreads) da[i] = a[i] - as[i];
    __syncthreads();

    // ---- warp 0 lists the rows with curvature; the others take the
    // gradient, M da + J' f, a column a thread, into the factor's y
    if (warp == 0) {
      int base = 0;
      for (int r0 = 0; r0 < nefc; r0 += kWarp) {
        const int r = r0 + lane;
        const bool on = r < nefc && curv[r] != 0.0f;
        const unsigned b = __ballot_sync(kFull, on);
        if (on) list[base + __popc(b & ((1u << lane) - 1u))] = r;
        base += __popc(b);
      }
      if (lane == 0) *nlist = base;
    } else {
      for (int i = tid - kWarp; i < nv; i += kThreads - kWarp) {
        const float* mi = Ms + i * ldm;
        float s = 0.0f;
        for (int k = 0; k < nv; ++k) s = fmaf(mi[k], da[k], s);
        float t = 0.0f;
        for (int r = 0; r < nefc; ++r)
          t = fmaf(J[static_cast<long long>(r) * ldj + i], f[r], t);
        Mda[i] = s;
        pan.y[i] = s + t;
      }
    }
    __syncthreads();

    // ---- H = M + J' diag(c) J over the listed rows, lower 4 x 4 tiles
    const int nl = *nlist;
    for (int q = tid; q < tiles; q += kThreads) {
      int bi = static_cast<int>((sqrtf(8.0f * q + 1.0f) - 1.0f) * 0.5f);
      while (bi * (bi + 1) / 2 > q) --bi;
      while ((bi + 1) * (bi + 2) / 2 <= q) ++bi;
      const int bk = q - bi * (bi + 1) / 2;
      const int i0 = 4 * bi, k0 = 4 * bk;
      float acc[4][4] = {};
      for (int t = 0; t < nl; ++t) {
        const int r = list[t];
        const float c = curv[r];
        const float4 vi = j4<kStaged>(J, ldj, r, i0, nv);
        const float4 vk = j4<kStaged>(J, ldj, r, k0, nv);
        const float ci[4] = {vi.x * c, vi.y * c, vi.z * c, vi.w * c};
        const float jk[4] = {vk.x, vk.y, vk.z, vk.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w)
            acc[u][w] = fmaf(ci[u], jk[w], acc[u][w]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u;
        if (i >= nv) continue;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int k = k0 + w;
          pan.S[i * ld + k] = k < nv ? Ms[i * ldm + k] + acc[u][w] : 0.0f;
        }
      }
    }
    __syncthreads();

    // ---- the ridge 1e-7 trace(H) / nv on the diagonal (warp 0), then
    // p = -H^-1 grad by the panel factor
    if (warp == 0) {
      float tr = 0.0f;
      for (int i = lane; i < nv; i += kWarp) tr += pan.S[i * ld + i];
#pragma unroll
      for (int o = kWarp / 2; o > 0; o >>= 1)
        tr += __shfl_xor_sync(kFull, tr, o);
      const float ridge = 1e-7f * tr / static_cast<float>(nv);
      for (int i = lane; i < nv; i += kWarp)
        pan.S[i * ld + i] = pan.S[i * ld + i] + ridge;
      __syncwarp();
    }
    factor_panels<true>(pan);
    backward_panels(pan);
    for (int i = tid; i < nv; i += kThreads) {
      const float pi = -pan.y[i];
      pv[i] = isfinite(pi) ? pi : 0.0f;
    }
    __syncthreads();

    // ---- J p a row, M p a column; p'Mp, p'M da, da'M da, f'Jp
    float s4[kRed] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = tid; r < nefc; r += kThreads) {
      float s = 0.0f;
      for (int c0 = 0; c0 < nv; c0 += 4) {
        const float4 v = j4<kStaged>(J, ldj, r, c0, nv);
        s = fmaf(v.x, pv[c0], s);
        s = fmaf(v.y, pv[c0 + 1], s);
        s = fmaf(v.z, pv[c0 + 2], s);
        s = fmaf(v.w, pv[c0 + 3], s);
      }
      Jp[r] = s;
      s4[3] += f[r] * s;
    }
    for (int i = tid; i < nv; i += kThreads) {
      const float* mi = Ms + i * ldm;
      float s = 0.0f;
      for (int k = 0; k < nv; ++k) s = fmaf(mi[k], pv[k], s);
      Mp[i] = s;
      s4[0] += pv[i] * s;
      s4[1] += pv[i] * Mda[i];
      s4[2] += da[i] * Mda[i];
    }
    block_sum(s4, red, buf);
    const float pMp = s4[0], pM_da = s4[1], c0M = 0.5f * s4[2];
    const float d1_0 = (pM_da + 0.0f * pMp) + s4[3];
    const float gtol = g.ls_tol * tmax(fabsf(d1_0), 1e-8f);
    const float curv_floor = 1e-8f * tmax(pMp, 1e-12f);

    // ---- the line search: 1-D Newton on phi'(alpha)
    float alpha = 1.0f, d1 = 1e30f;
    int lit = 0;
    while (lit < g.max_ls && fabsf(d1) > gtol && isfinite(d1)) {
      float s2[2] = {0.0f, 0.0f};
      for (int r = tid; r < nefc; r += kThreads) {
        const float jp = Jp[r];
        float fr, cr;
        row_fc(x[r] + alpha * jp, D[r], fl[r], flags[r], fr, cr);
        s2[0] += fr * jp;
        s2[1] += cr * (jp * jp);
      }
      block_sum(s2, red, buf);
      const float d1n = (pM_da + alpha * pMp) + s2[0];
      const float d2n = pMp + s2[1];
      const float step = d1n / tmax(d2n, curv_floor);
      alpha = tclamp(alpha - step, 0.0f, 8.0f);
      ++lit;
      d1 = d1n;
    }
    ls_total += lit;
    alpha = tclamp(isfinite(alpha) ? alpha : 0.0f, 0.0f, 8.0f);

    // ---- phi(alpha) and phi(0.5); accept, halve or reject
    float c2[2] = {0.0f, 0.0f};
    for (int r = tid; r < nefc; r += kThreads) {
      const float jp = Jp[r];
      c2[0] += row_cost(x[r] + alpha * jp, D[r], fl[r], flags[r]);
      c2[1] += row_cost(x[r] + 0.5f * jp, D[r], fl[r], flags[r]);
    }
    block_sum(c2, red, buf);
    float new_cost =
        ((c0M + alpha * pM_da) + 0.5f * alpha * alpha * pMp) + c2[0];
    const float half_cost =
        ((c0M + 0.5f * pM_da) + 0.5f * 0.5f * 0.5f * pMp) + c2[1];
    const bool use_half = (new_cost > cost) && (half_cost < cost);
    float alpha_eff = use_half ? 0.5f : alpha;
    if (use_half) new_cost = half_cost;
    if (new_cost > cost) {
      alpha_eff = 0.0f;
      new_cost = cost;
    }
    for (int i = tid; i < nv; i += kThreads) a[i] = a[i] + alpha_eff * pv[i];
    for (int r = tid; r < nefc; r += kThreads)
      x[r] = x[r] + alpha_eff * Jp[r];
    const float improved = cost - new_cost;
    done = improved < g.tol * tmax(fabsf(new_cost), 1.0f);
    cost = new_cost;
    ++it;
    __syncthreads();
  }

  for (int i = tid; i < nv; i += kThreads) g.a[env * nv + i] = a[i];
  for (int r = tid; r < nefc; r += kThreads) g.x[env * nefc + r] = x[r];
  if (tid == 0) {
    g.iters[env] = it;
    g.ls_iters[env] = ls_total;
  }
}

// Bytes of dynamic shared memory at (nv, nefc), staged or not.
size_t smem_bytes(int nv, int nefc, bool staged) {
  return static_cast<size_t>(Sizes(nv, nefc, staged).total()) * sizeof(float);
}

template <bool kStaged>
int launch(const Args& g, cudaStream_t stream) {
  const size_t bytes = smem_bytes(g.nv, g.nefc, kStaged);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        newton_solve_kernel<kStaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  newton_solve_kernel<kStaged><<<g.N, kThreads, bytes, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Where the kernel keeps J at (nv, nefc) on the current device: 1 staged
// in shared memory, 0 read from device memory, -1 not taken (nv out of
// 1..64, nefc < 1, or the rest of an env's parts past the shared memory).
extern "C" int newton_solve_staged(int nv, int nefc) {
  if (nv < 1 || nv > kMaxNv || nefc < 1 || nefc > (1 << 20)) return -1;
  const size_t optin = static_cast<size_t>(asynccopy::smem_optin());
  if (smem_bytes(nv, nefc, true) <= optin) return 1;
  if (smem_bytes(nv, nefc, false) <= optin) return 0;
  return -1;
}

// M (N, nv, nv), a_smooth (N, nv), J (N, nefc, nv), D, floss (N, nefc)
// float32; type (N, nefc) int32; fon (N, nefc) bool; a0 (N, nv), x0 (N,
// nefc), c0 (N,): the carry after the init; out: a (N, nv), x (N, nefc),
// iters and ls_iters (N,) int32.  All contiguous on the device.  Returns
// the cudaError_t of the launch (0 = cudaSuccess); 1 for a shape the
// kernel does not take (newton_solve_staged -1).
extern "C" int newton_solve_f32(const float* M, const float* as,
                                const float* J, const float* D,
                                const int* type, const float* floss,
                                const unsigned char* fon, const float* a0,
                                const float* x0, const float* c0, float* a,
                                float* x, int* iters, int* ls_iters, int N,
                                int nv, int nefc, float tol, float ls_tol,
                                int max_it, int max_ls, void* stream) {
  if (N < 0) return 1;
  const int where = newton_solve_staged(nv, nefc);
  if (where < 0) return 1;
  if (N == 0) return 0;
  const Args g{M,  as, J,     D,     type, floss, fon,    a0,     x0,
               c0, a,  x,     iters, ls_iters,    N,      nv,     nefc,
               tol, ls_tol, max_it, max_ls};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return where == 1 ? launch<true>(g, s) : launch<false>(g, s);
}
