"""Fused batched Cholesky factor + solve: hand-written CUDA kernel + twin.

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
  in shared memory, or past the card's shared memory (n > 239 on the
  H100) in a device-memory workspace this wrapper allocates.  Any n >= 1;
* a CPU tensor takes the plain twin ``chol_solve_plain`` (ops/linalg.py
  cholesky + cho_solve, the JAX package's CPU path).

``LAUNCHES`` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mujoco_sim_tpu_torch.ops import cuda_build, linalg

LAUNCHES = 0

CLASS_MAX_N = 64      # the register-resident size classes; above, a block
SOURCE = cuda_build.source_path("chol_solve")


def chol_solve_plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b via linalg.cholesky + linalg.cho_solve (any device)."""
    return linalg.cho_solve(linalg.cholesky(A), b)


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    lib = cuda_build.load("chol_solve")
    lib.chol_solve_f32.restype = ctypes.c_int
    lib.chol_solve_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.chol_solve_work_floats.restype = ctypes.c_longlong
    lib.chol_solve_work_floats.argtypes = [ctypes.c_int]
    return lib


def chol_solve_cuda(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: A (..., n, n) SPD, b (..., n) -> x (..., n),
    float32, contiguous, on one CUDA device, n >= 1."""
    global LAUNCHES
    n = A.shape[-1]
    if A.dim() < 2 or A.shape[-2] != n or b.shape != A.shape[:-1]:
        raise ValueError(f"chol_solve_cuda: shapes {tuple(A.shape)} / "
                         f"{tuple(b.shape)}")
    if n < 1:
        raise ValueError(f"chol_solve_cuda: n={n} must be at least 1")
    dev = cuda_build.check_f32_cuda("chol_solve_cuda", A=A, b=b)
    lib = _load()
    x = torch.empty_like(b)
    N = b.numel() // n
    work = None
    if n > CLASS_MAX_N:
        per = lib.chol_solve_work_floats(n)
        if per:
            work = torch.empty(N * per, dtype=torch.float32, device=dev)
    rc = cuda_build.launch(dev, lib.chol_solve_f32, A.data_ptr(),
                           b.data_ptr(), x.data_ptr(),
                           None if work is None else work.data_ptr(), N, n)
    if rc != 0:
        raise RuntimeError(f"chol_solve kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    cuda_build.count_launch("chol_solve", dev)
    return x


def chol_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Fused SPD solve x = A^-1 b over leading batch dims.

    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    twin.  Semantics match linalg.cholesky + linalg.cho_solve with the same
    1e-30 pivot floor.
    """
    if A.device.type == "cuda":
        return chol_solve_cuda(A, b)
    if A.device.type == "cpu":
        return chol_solve_plain(A, b)
    raise ValueError(f"chol_solve: unsupported device {A.device}")
