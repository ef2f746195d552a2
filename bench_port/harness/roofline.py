"""Peaks of the card and the least time of a kernel's work.

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit:
3.35 TB/s of HBM and 67 TFLOP/s in float32 outside the tensor cores.  A
kernel's bound is the larger of its bytes (each input read once, each
output written once) over the memory rate and its flops over the f32
rate, computed from the shapes a call saw.  The arithmetic is the one the
port's chip checks use for the same kernels.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """Least seconds for the work: the larger of the two times."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def chol_solve_bound_s(N: int, n: int) -> float:
    """chol_solve over N systems of size n: A and b read and x written
    once (float32); the factor's n^3/3 and the two substitutions' 2 n^2
    flops a system."""
    return bound_s(4 * N * (n * n + 2 * n), N * (n ** 3 / 3 + 2 * n * n))


def hull_sat_bound_s(N: int, V: int, F: int, k: int, mask: bool,
                     lateral: bool, slack: bool) -> float:
    """hull_ref_face_depth over N instances of V points against F planes:
    points and planes read once, the point mask and the per-instance
    slack where passed (float32, as the kernel takes them), the outputs
    written once; the support tensor and the depths computed once (twice
    with the lateral filter)."""
    nbytes = (4 * N * (3 * V + 4 * F) + N * (12 * k + 16)
              + (4 * N * V if mask else 0) + (4 * N if slack else 0))
    return bound_s(nbytes, N * (6 * V * F * (2 if lateral else 1) + 6 * V))
