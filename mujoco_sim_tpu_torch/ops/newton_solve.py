"""The pyramidal Newton solve as one hand-written CUDA kernel.

``ops/solver.solve`` hands the carry after its best-of-two init (a, the jar
x = J a - aref, the cost) to ``newton_solve_cuda`` where
``solver.takes_kernel`` holds: a pyramidal or frictionless model with
nv <= 64 on a CUDA tensor.
The kernel (csrc/newton_solve.cu) runs each env's Newton iterations and
line searches to that env's own stop, an env a block, in one launch: the
lockstep loops of ``solver._newton_lockstep`` (a WHILE node over the whole
batch, the line search's nested in it) are its plain twin, which the CPU,
elliptic models and nv > 64 keep.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mujoco_sim_tpu_torch.ops import cuda_build
from mujoco_sim_tpu_torch.runtime import profiler

MAX_NV = 64           # csrc/newton_solve.cu's kMaxNv


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = cuda_build.load("newton_solve")
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.newton_solve_f32.restype = i
    lib.newton_solve_f32.argtypes = [vp] * 14 + [i, i, i, f, f, i, i, vp]
    lib.newton_solve_staged.restype = i
    lib.newton_solve_staged.argtypes = [i, i]
    return lib


def staged(nv: int, nefc: int) -> int:
    """Where the kernel keeps an env's J at (nv, nefc) on the current
    device: 1 in shared memory, 0 in device memory, -1 not taken."""
    return _load().newton_solve_staged(nv, nefc)


def newton_solve_cuda(M, a_smooth, J, D, efc_type, floss, floss_active,
                      a, x, cost, tolerance: float, ls_tolerance: float,
                      iterations: int, ls_iterations: int):
    """Launch the kernel.  M (B, nv, nv), a_smooth (B, nv), J (B, nefc,
    nv), D, floss (B, nefc) float32; efc_type (B, nefc) int32;
    floss_active (B, nefc) bool; the carry a (B, nv), x (B, nefc), cost
    (B,) float32; all on one CUDA device, 1 <= nv <= 64.  Returns (a, x,
    iterations, line-search steps summed), the last two (B,) int32."""
    fn = "newton_solve_cuda"
    if J.dim() != 3:
        raise ValueError(f"{fn}: J must be (B, nefc, nv), got "
                         f"{tuple(J.shape)}")
    B, nefc, nv = J.shape
    want = dict(M=(B, nv, nv), a_smooth=(B, nv), D=(B, nefc),
                efc_type=(B, nefc), floss=(B, nefc), floss_active=(B, nefc),
                a=(B, nv), x=(B, nefc), cost=(B,))
    got = dict(M=M, a_smooth=a_smooth, D=D, efc_type=efc_type, floss=floss,
               floss_active=floss_active, a=a, x=x, cost=cost)
    for k, shape in want.items():
        if tuple(got[k].shape) != shape:
            raise ValueError(f"{fn}: {k} is {tuple(got[k].shape)}, expected "
                             f"{shape}")
    if not 1 <= nv <= MAX_NV or nefc < 1:
        raise ValueError(f"{fn}: nv={nv} (1..{MAX_NV}), nefc={nefc} (>= 1)")
    M, a_smooth, J, D, floss, a, x, cost, efc_type, floss_active = (
        t.contiguous() for t in (M, a_smooth, J, D, floss, a, x, cost,
                                 efc_type, floss_active))
    dev = cuda_build.check_f32_cuda(fn, M=M, a_smooth=a_smooth, J=J, D=D,
                                    floss=floss, a=a, x=x, cost=cost)
    if efc_type.dtype != torch.int32 or floss_active.dtype != torch.bool:
        raise TypeError(f"{fn}: efc_type int32 and floss_active bool, got "
                        f"{efc_type.dtype} / {floss_active.dtype}")
    if efc_type.device != dev or floss_active.device != dev:
        raise ValueError(f"{fn}: efc_type / floss_active not on {dev}")
    lib = _load()
    a_out = torch.empty_like(a)
    x_out = torch.empty_like(x)
    iters = torch.empty(B, dtype=torch.int32, device=dev)
    ls_iters = torch.empty(B, dtype=torch.int32, device=dev)
    ptrs = [M, a_smooth, J, D, efc_type, floss, floss_active, a, x, cost,
            a_out, x_out, iters, ls_iters]
    cuda_build.launch(dev, lib.newton_solve_f32,
                      *[t.data_ptr() for t in ptrs], B, nv, nefc,
                      float(tolerance), float(ls_tolerance), int(iterations),
                      int(ls_iterations))
    profiler.count("newton_solve", dev)
    return a_out, x_out, iters, ls_iters

