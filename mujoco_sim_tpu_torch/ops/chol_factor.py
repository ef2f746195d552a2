"""Batched Cholesky factor L = chol(A): hand-written CUDA kernel + twin.

Port of the TPU kernel benchmarks/pallas_chol_proto.py ``make_chol_kernel``
(a factor only, pivot floored at 1e-30, zeros above the diagonal).  The
step needs the factor itself in one place: with ``noslip_iterations > 0``
``engine.fwd_position`` stores ``qLD = factor_chol(qM)`` and ops/noslip.py
solves a matrix right-hand side with it.

``chol_factor`` picks its path from the tensor's device, never from a
switch: a CUDA tensor launches csrc/chol_factor.cu (built by
ops/cuda_build.py at first use; its factor is the one chol_solve.cu runs,
shared through csrc/chol_factor.cuh: register-resident up to n = 64, one
block a system factored in panels of 32 columns above, any n >= 1) or raises; a CPU
tensor takes the plain twin ``chol_factor_plain`` (ops/linalg.cholesky).
``LAUNCHES`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mujoco_sim_tpu_torch.ops import cuda_build, linalg
from mujoco_sim_tpu_torch.runtime import profiler

LAUNCHES = 0

SOURCE = cuda_build.source_path("chol_factor")


def chol_factor_plain(A: torch.Tensor) -> torch.Tensor:
    """Lower factor of SPD A (..., n, n) via ops/linalg.cholesky (any
    device, any float dtype)."""
    return linalg.cholesky(A)


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = cuda_build.load("chol_factor")
    lib.chol_factor_f32.restype = ctypes.c_int
    lib.chol_factor_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    return lib


def chol_factor_cuda(A: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: A (..., n, n) SPD -> L (..., n, n) lower,
    float32, contiguous, on a CUDA device, n >= 1."""
    global LAUNCHES
    fn = "chol_factor_cuda"
    if A.dim() < 2 or A.shape[-2] != A.shape[-1]:
        raise ValueError(f"{fn}: shape {tuple(A.shape)}")
    n = A.shape[-1]
    if n < 1:
        raise ValueError(f"{fn}: n={n} must be at least 1")
    dev = cuda_build.check_f32_cuda(fn, A=A)
    L = torch.empty_like(A)
    rc = cuda_build.launch(dev, _load().chol_factor_f32, A.data_ptr(),
                           L.data_ptr(), A.numel() // (n * n), n)
    if rc != 0:
        raise RuntimeError(f"chol_factor kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    profiler.count("chol_factor", dev)
    return L


def chol_factor(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor over leading batch dims, pivot floor 1e-30.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    twin."""
    if A.device.type == "cuda":
        return chol_factor_cuda(A)
    if A.device.type == "cpu":
        return chol_factor_plain(A)
    raise ValueError(f"chol_factor: unsupported device {A.device}")
