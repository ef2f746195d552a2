"""Frozen copy of mujoco_sim_tpu_torch's CPU path for the benchmark's
plain reference (bench_port/refsim): imports rewritten, CUDA wrappers
and graph capture removed.  Do not import the program from here.

Fused batched Cholesky factor + solve: hand-written CUDA kernel + twin.

Port of mujoco_sim_tpu/ops/pallas_chol.py.  The step solves small SPD
systems constantly: qacc_smooth (M x = qfrc), the Euler velocity update
((M + h B) x = rhs) and the Newton direction (H p = -g) on every solver
iteration.  ``chol_solve`` picks its path from the tensor's device, never
from a switch:

* a CUDA tensor launches the kernel in csrc/chol_solve.cu (built by
  ops/cuda_build.py with nvcc at first use into ``_build/``, loaded with
  ctypes) or raises.  The kernel keeps each matrix in the registers of the
  lanes that own its rows (size classes 8, 16, 32, 48, 64; several systems
  a warp below n = 16); above n = 64 it factors each system in one block,
  in panels of 32 columns in shared memory, or past the card's shared
  memory (n > 236 on the H100) with a column loop in a device-memory
  workspace this wrapper allocates.  Any n >= 1;
* a CPU tensor takes the plain twin ``chol_solve_plain`` (ops/linalg.py
  cholesky + cho_solve, the JAX package's CPU path).

``LAUNCHES`` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations


import torch

from refsim.ops import linalg


CLASS_MAX_N = 64      # the register-resident size classes; above, a block


def chol_solve_plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b via linalg.cholesky + linalg.cho_solve (any device)."""
    return linalg.cho_solve(linalg.cholesky(A), b)



def chol_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fused SPD solve x = A^-1 b over leading batch dims.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    twin.  Semantics match linalg.cholesky + linalg.cho_solve with the same
    1e-30 pivot floor.
    """
    if A.device.type == "cpu":
        return chol_solve_plain(A, b)
    raise ValueError(f"chol_solve: unsupported device {A.device}")
