"""Where the time of the Newton solve kernel (csrc/newton_solve.cu) goes, on
one NVIDIA GPU.

    PYTHONPATH=. python3 scripts/torch_newton_stamps.py [nenv ...]

For each batch size (default 1024 and 8192) it runs 40 stirred steps of
the manip bin (tests/fixtures/manip_bin6.xml) through the step graph,
runs the forward stages before the solve, and captures the kernel's
inputs at that state.  It then builds a stamped copy of the kernel at run
time from the checkout's source into the build directory (thread 0 of
every block reads clock64 at the end of each phase of a Newton iteration
and sums the cycles by phase), and prints one JSON line per batch: the
blocks an SM holds, the mean Newton and line-search iterations an env,
the cycles an env spends staging its inputs, the cycles an iteration
spends in each phase (summed over the envs, over their iterations), and
the shipped kernel's time alone (CUDA events over 20 launches).

The shipped kernel carries no stamps; the copy differs from it only in
the clock reads and one store per block.  Needs a CUDA device and nvcc;
imports no jax.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import mujoco_sim_tpu_torch as mst  # noqa: E402
from mujoco_sim_tpu_torch import engine  # noqa: E402
from mujoco_sim_tpu_torch.ops import (cuda_build, newton_solve,  # noqa: E402
                                      solver)

PHASES = ("rows", "grad_list", "hessian", "factor", "backward", "jp_reduce",
          "linesearch", "cost_update")
# (text of csrc/newton_solve.cu, stamped replacement): each must occur
_STAMPS = [
    ('#include "chol_factor.cuh"\n',
     '#include "chol_factor.cuh"\n__device__ long long* g_st = nullptr;\n'
     '#define STP(k) { const long long t_ = clock64(); acc_[k] += t_ - tp_;'
     ' tp_ = t_; }\n'),
    ("  extern __shared__ __align__(16) float smem[];\n"
     "  const int nv = g.nv, nefc = g.nefc, tid = threadIdx.x;\n",
     "  long long acc_[9] = {}; long long tp_ = clock64();\n"
     "  extern __shared__ __align__(16) float smem[];\n"
     "  const int nv = g.nv, nefc = g.nefc, tid = threadIdx.x;\n"),
    ("  asynccopy::wait_all();\n  __syncthreads();\n\n  const int T",
     "  asynccopy::wait_all();\n  __syncthreads(); STP(0)\n\n  const int T"),
    ("da[i] = a[i] - as[i];\n    __syncthreads();\n",
     "da[i] = a[i] - as[i];\n    __syncthreads(); STP(1)\n"),
    ("        pan.y[i] = s + t;\n      }\n    }\n    __syncthreads();\n",
     "        pan.y[i] = s + t;\n      }\n    }\n"
     "    __syncthreads(); STP(2)\n"),
    ("    __syncthreads();\n\n    // ---- the ridge",
     "    __syncthreads(); STP(3)\n\n    // ---- the ridge"),
    ("    factor_panels<true>(pan);\n    backward_panels(pan);\n",
     "    factor_panels<true>(pan); STP(4)\n"
     "    backward_panels(pan); STP(5)\n"),
    ("    block_sum(s4, red, buf);\n",
     "    block_sum(s4, red, buf); STP(6)\n"),
    ("    ls_total += lit;\n", "    STP(7) ls_total += lit;\n"),
    ("    ++it;\n    __syncthreads();\n  }\n",
     "    ++it;\n    __syncthreads(); STP(8)\n  }\n"),
    ("  if (tid == 0) {\n    g.iters[env] = it;",
     "  if (tid == 0) {\n    if (g_st) for (int k = 0; k < 9; ++k) "
     "g_st[env * 9 + k] = acc_[k];\n    g.iters[env] = it;"),
]
_TAIL = """
extern "C" int ns_set_stamps(long long* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_st, &p, sizeof(p)));
}
extern "C" int ns_occupancy(int nv, int nefc) {
  int n = 0;
  const size_t b = smem_bytes(nv, nefc, true);
  cudaFuncSetAttribute(newton_solve_kernel<true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, newton_solve_kernel<true>,
                                                kThreads, b);
  return n;
}
"""


def _set_argtypes(lib):
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.newton_solve_f32.restype = i
    lib.newton_solve_f32.argtypes = [vp] * 14 + [i, i, i, f, f, i, i, vp]
    return lib


def build_stamped():
    with open(cuda_build.source_path("newton_solve")) as f:
        end = f.read()[-200:]
    lib = cuda_build.build_variant("newton_solve", "stamps",
                                   _STAMPS + [(end, end + _TAIL)])
    lib.ns_set_stamps.argtypes = [ctypes.c_void_p]
    lib.ns_occupancy.argtypes = [ctypes.c_int, ctypes.c_int]
    return _set_argtypes(lib)


def captured(nenv, nsteps=40, seed=1):
    """The kernel's arguments at the state of a stirred manip rollout."""
    m = mst.put_model(mst.load_model(
        os.path.join(ROOT, "tests", "fixtures", "manip_bin6.xml")))
    phase = torch.tensor(np.random.default_rng(seed).uniform(
        0, 6.28, (nenv, m.nu)), dtype=torch.float32, device="cuda")
    ctrl = lambda d_: torch.sin(4.0 * d_.time[:, None] + phase)  # noqa
    d = mst.rollout(m, mst.make_data(m, nenv), nsteps, ctrl_fn=ctrl)
    d = engine.fwd_position(m, d.replace(ctrl=ctrl(d)))
    d = engine.fwd_acceleration(m, engine.fwd_actuation(
        m, engine.fwd_velocity(m, d)))
    got = {}
    launch = newton_solve.newton_solve_cuda

    def grab(*args):
        got["args"] = args
        return launch(*args)

    newton_solve.newton_solve_cuda = grab
    try:
        solver.solve(m, d)
    finally:
        newton_solve.newton_solve_cuda = launch
    return got["args"]


def run(lib, args, stamps=None):
    M, a_s, J, D, typ, fl, fon, a, x, cost, tol, ls_tol, it, ls_it = args
    B, nefc, nv = J.shape
    outs = [torch.empty_like(a), torch.empty_like(x),
            torch.empty(B, dtype=torch.int32, device="cuda"),
            torch.empty(B, dtype=torch.int32, device="cuda")]
    if hasattr(lib, "ns_set_stamps"):
        lib.ns_set_stamps(None if stamps is None else stamps.data_ptr())
    ptrs = [M, a_s, J, D, typ, fl, fon, a, x, cost] + outs
    rc = lib.newton_solve_f32(*[t.data_ptr() for t in ptrs], B, nv, nefc,
                              tol, ls_tol, it, ls_it,
                              torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"newton_solve launch failed: cudaError {rc}")
    return outs


def main(sizes):
    stamped, shipped = build_stamped(), newton_solve._load()
    for nenv in sizes:
        args = captured(nenv)
        B, nefc, nv = args[2].shape
        st = torch.zeros(B * 9, dtype=torch.int64, device="cuda")
        outs = run(stamped, args, st)
        ref = run(shipped, args)
        torch.cuda.synchronize()
        if not (torch.equal(outs[0], ref[0]) and torch.equal(outs[2],
                                                             ref[2])):
            raise AssertionError("the stamped copy does not equal the kernel")
        t = st.view(B, 9).double()
        its = outs[2].double()
        per_it = (t[:, 1:].sum(0) / its.sum()).tolist()
        for _ in range(3):
            run(shipped, args)
        e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
        e0.record()
        for _ in range(20):
            run(shipped, args)
        e1.record()
        torch.cuda.synchronize()
        print(json.dumps(dict(
            card=torch.cuda.get_device_name(0), nenv=nenv, nefc=nefc, nv=nv,
            blocks_per_sm=stamped.ns_occupancy(nv, nefc),
            newton_iters_mean=float(its.mean()),
            linesearch_steps_mean=float(outs[3].double().mean()),
            stage_cycles=float(t[:, 0].mean()),
            cycles_per_iteration={k: round(v) for k, v in zip(PHASES,
                                                              per_it)},
            kernel_ms=e0.elapsed_time(e1) / 20)), flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [1024, 8192])
