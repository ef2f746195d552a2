"""Fused batched Cholesky factor + solve: hand-written CUDA kernel + twin.

Port of mujoco_sim_tpu/ops/pallas_chol.py.  The step solves small SPD
systems constantly: qacc_smooth (M x = qfrc), the Euler velocity update
((M + h B) x = rhs) and the Newton direction (H p = -g) on every solver
iteration.  ``chol_solve`` picks its path from the tensor's device, never
from a switch:

* a CUDA tensor launches the kernel in csrc/chol_solve.cu (built with nvcc
  at first use into ``_build/``, loaded with ctypes) or raises;
* a CPU tensor takes the plain twin ``chol_solve_plain`` (ops/linalg.py
  cholesky + cho_solve, the JAX package's CPU path).

``LAUNCHES`` counts kernel launches (and nothing else), so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

from mujoco_sim_tpu_torch.ops import linalg

LAUNCHES = 0

MAX_N = 64
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "chol_solve.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")


def chol_solve_plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b via linalg.cholesky + linalg.cho_solve (any device)."""
    return linalg.cho_solve(linalg.cholesky(A), b)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> str:
    """Compile csrc/chol_solve.cu into _build/ (keyed by the source hash)
    unless already built; returns the shared library's path."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"chol_solve_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", tmp, SOURCE],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, out)     # atomic: a concurrent build never sees half
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    lib = ctypes.CDLL(build())
    lib.chol_solve_f32.restype = ctypes.c_int
    lib.chol_solve_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def chol_solve_cuda(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel: A (..., n, n) SPD, b (..., n) -> x (..., n),
    float32, contiguous, on one CUDA device."""
    global LAUNCHES
    if not (A.is_cuda and b.is_cuda and A.device == b.device):
        raise ValueError(f"chol_solve_cuda: tensors on {A.device}/{b.device}")
    if A.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"chol_solve_cuda: float32 only, got {A.dtype}/{b.dtype}")
    n = A.shape[-1]
    if A.dim() < 2 or A.shape[-2] != n or b.shape != A.shape[:-1]:
        raise ValueError(f"chol_solve_cuda: shapes {tuple(A.shape)} / "
                         f"{tuple(b.shape)}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"chol_solve_cuda: n={n} outside 1..{MAX_N}")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("chol_solve_cuda: inputs must be contiguous")
    lib = _load()
    N = b.numel() // n
    x = torch.empty_like(b)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = lib.chol_solve_f32(A.data_ptr(), b.data_ptr(), x.data_ptr(),
                                N, n, stream)
    if rc != 0:
        raise RuntimeError(f"chol_solve kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
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
