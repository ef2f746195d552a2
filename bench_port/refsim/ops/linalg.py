"""Frozen copy of mujoco_sim_tpu_torch's CPU path for the benchmark's
plain reference (bench_port/refsim): imports rewritten, CUDA wrappers
and graph capture removed.  Do not import the program from here.

Batched small-matrix linear algebra (port of mujoco_sim_tpu/ops/linalg.py).

Static unrolled column-Cholesky / substitution code for small n and a
blocked recursive scheme (leaf = unrolled, off-diagonal updates = batched
matmuls) for larger n, with the same 1e-30 pivot floor as the JAX package.

This is the plain-torch twin of the hand-written CUDA kernel in
ops/chol.py: the CPU path of the engine and the kernel's oracle on the
card.  All functions operate on the trailing dims and broadcast over any
leading batch dims.
"""

from __future__ import annotations

import torch

_LEAF = 16  # max n for fully-unrolled kernels


def _chol_unrolled(A: torch.Tensor) -> torch.Tensor:
    """Column Cholesky, fully unrolled (n <= _LEAF)."""
    n = A.shape[-1]
    cols = []
    for j in range(n):
        c = A[..., :, j]
        for k in range(j):
            c = c - cols[k] * cols[k][..., j][..., None]
        pivot = torch.sqrt(torch.clamp(c[..., j], min=1e-30))
        c = c / pivot[..., None]
        # rows above the diagonal are zero in the factor
        c = torch.cat([torch.zeros_like(c[..., :j]), c[..., j:]], dim=-1)
        cols.append(c)
    return torch.stack(cols, dim=-1)


def _solve_lower_unrolled(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """L X = B with L lower-triangular (..., n, n), B (..., n, m)."""
    n = L.shape[-1]
    xs = []
    for i in range(n):
        v = B[..., i, :]
        for k in range(i):
            v = v - L[..., i, k][..., None] * xs[k]
        xs.append(v / L[..., i, i][..., None])
    return torch.stack(xs, dim=-2)


def _solve_upper_unrolled(U: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """U X = B with U upper-triangular."""
    n = U.shape[-1]
    xs = [None] * n
    for i in range(n - 1, -1, -1):
        v = B[..., i, :]
        for k in range(i + 1, n):
            v = v - U[..., i, k][..., None] * xs[k]
        xs[i] = v / U[..., i, i][..., None]
    return torch.stack(xs, dim=-2)


def _split(n: int) -> int:
    """Split point: smallest multiple of _LEAF >= n/2 (keeps leaves full)."""
    h = (n + 1) // 2
    return min(((h + _LEAF - 1) // _LEAF) * _LEAF, n - 1) if n > _LEAF else n


def solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L X = B, L lower-triangular (..., n, n), B (..., n, m)."""
    n = L.shape[-1]
    if n <= _LEAF:
        return _solve_lower_unrolled(L, B)
    s = _split(n)
    L11 = L[..., :s, :s]
    L21 = L[..., s:, :s]
    L22 = L[..., s:, s:]
    X1 = solve_lower(L11, B[..., :s, :])
    rhs2 = B[..., s:, :] - L21 @ X1
    X2 = solve_lower(L22, rhs2)
    return torch.cat([X1, X2], dim=-2)


def solve_upper(U: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve U X = B, U upper-triangular."""
    n = U.shape[-1]
    if n <= _LEAF:
        return _solve_upper_unrolled(U, B)
    s = _split(n)
    U11 = U[..., :s, :s]
    U12 = U[..., :s, s:]
    U22 = U[..., s:, s:]
    X2 = solve_upper(U22, B[..., s:, :])
    rhs1 = B[..., :s, :] - U12 @ X2
    X1 = solve_upper(U11, rhs1)
    return torch.cat([X1, X2], dim=-2)


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of SPD A (..., n, n); blocked recursive."""
    n = A.shape[-1]
    if n <= _LEAF:
        return _chol_unrolled(A)
    s = _split(n)
    A11 = A[..., :s, :s]
    A21 = A[..., s:, :s]
    A22 = A[..., s:, s:]
    L11 = cholesky(A11)
    # L21 L11^T = A21  =>  L11 (L21^T) = A21^T
    L21T = solve_lower(L11, A21.transpose(-1, -2))
    L21 = L21T.transpose(-1, -2)
    S = A22 - L21 @ L21T
    L22 = cholesky(S)
    top = torch.cat(
        [L11, torch.zeros(L21T.shape[:-2] + (s, n - s), dtype=A.dtype,
                          device=A.device)], dim=-1)
    bot = torch.cat([L21, L22], dim=-1)
    return torch.cat([top, bot], dim=-2)


def cho_solve(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = rhs for vector rhs (..., n)."""
    y = solve_lower(L, rhs[..., None])
    x = solve_upper(L.transpose(-1, -2), y)
    return x[..., 0]


def cho_solve_mat(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) X = B for matrix B (..., n, m)."""
    y = solve_lower(L, B)
    return solve_upper(L.transpose(-1, -2), y)
