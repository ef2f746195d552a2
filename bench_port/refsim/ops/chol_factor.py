"""Frozen copy of mujoco_sim_tpu_torch's CPU path for the benchmark's
plain reference (bench_port/refsim): imports rewritten, CUDA wrappers
and graph capture removed.  Do not import the program from here.

Batched Cholesky factor L = chol(A): hand-written CUDA kernel + twin.

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


import torch

from refsim.ops import linalg



def chol_factor_plain(A: torch.Tensor) -> torch.Tensor:
    """Lower factor of SPD A (..., n, n) via ops/linalg.cholesky (any
    device, any float dtype)."""
    return linalg.cholesky(A)



def chol_factor(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor over leading batch dims, pivot floor 1e-30.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    twin."""
    if A.device.type == "cpu":
        return chol_factor_plain(A)
    raise ValueError(f"chol_factor: unsupported device {A.device}")
