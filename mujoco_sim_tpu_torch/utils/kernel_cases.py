"""Seeded edge-case inputs of the chol_solve and mtv_query kernels.

One set of cases, made with numpy from a seed, so that the same inputs go
through three comparisons: the plain twins against the JAX package on the
CPU (tests/test_torch_kernels_twins.py), the CUDA kernels against their
twins on a card (tests/test_torch_cuda.py), and the same in chip_smoke.py.
The cases pin what the kernels' designs lean on: the size classes of the
register-resident Cholesky (8, 16, 32, 48, 64: both sides of every edge),
batches that fill no warp evenly, a stiff row, a pivot at the 1e-30 floor;
for the MTV query the edge ranking's corner cases (fewer edges than K, a
hull with every edge masked, exactly tied scores) and the analytic
cylinder support on either side.

Everything is float64 numpy; callers cast.
"""

from __future__ import annotations

import numpy as np

from mujoco_sim_tpu_torch.ops.mtv_query import ARG_NAMES as MTV_ORDER

CHOL_BATCH = 37          # a multiple of nothing the kernels tile by
CHOL_EDGE_SIZES = (1, 2, 8, 9, 16, 17, 32, 33, 48, 49, 63, 64)
CHOL_CASES = tuple(f"n{n}" for n in CHOL_EDGE_SIZES) + ("stiff_n33", "floor")

MTV_BATCH = 37
MTV_CASES = ("e_lt_k", "masked_A", "masked_B", "duplicates", "cyl_A", "cyl_B",
             "cyl_both")


def _spd(rng, N, n):
    A = rng.standard_normal((N, n, n))
    return A @ A.transpose(0, 2, 1) + n * np.eye(n)


def chol_case(name: str, seed: int = 0):
    """(A (37, n, n), b (37, n)) of one of CHOL_CASES.

    ``stiff_n33``: a 1e9 diagonal entry in row 5 of a 33 x 33 system (two
    rows a lane).  ``floor``: the leading 2 x 2 block [[4 s, 2 s], [2 s,
    s (1 - 2^-10)]] has a second pivot of -s 2^-10, clearly below zero in
    any rounding, so every implementation floors its square root to
    sqrt(1e-30) and stores the diagonal entry as pivot / sqrt(1e-30)
    (~ -1e12 s); the solution stays finite and x_2 is ~ 0.
    """
    rng = np.random.default_rng([seed, CHOL_CASES.index(name)])
    N = CHOL_BATCH
    if name == "stiff_n33":
        A = _spd(rng, N, 33)
        A[:, 5, 5] += 1e9
        return A, rng.standard_normal((N, 33))
    if name == "floor":
        n = 5
        s = 4.0 ** (np.arange(N) % 3)
        A = np.zeros((N, n, n))
        A[:, 0, 0], A[:, 0, 1], A[:, 1, 0] = 4 * s, 2 * s, 2 * s
        A[:, 1, 1] = s * (1.0 - 2.0 ** -10)
        A[:, 2:, 2:] = _spd(rng, N, 3)
        b = rng.standard_normal((N, n))
        b[:, 0] = 0.0
        b[:, 1] = (1.0 + np.arange(N)) * 2.0 ** -84
        return A, b
    n = int(name[1:])
    return _spd(rng, N, n), rng.standard_normal((N, n))


def mtv_case(name: str, seed: int = 0):
    """{tensor name: array} (the 16 of MTV_ORDER, 37 instances) of one of
    MTV_CASES, from the random-hull generator of tests/test_pallas_refine.py.

    ``e_lt_k``: 10 edges a hull, fewer than K = 16.  ``masked_A`` /
    ``masked_B``: every edge of that hull masked (all its directions zero,
    every cross axis invalid).  ``duplicates``: each hull's edges 1, 5 and
    9 repeat edge 0, 4 and 8 exactly, so their scores tie and the lower
    index must come first.  ``cyl_*``: that hull takes the analytic
    cylinder support.
    """
    rng = np.random.default_rng([seed, MTV_CASES.index(name)])
    N = MTV_BATCH
    V, E, F = (9, 10, 5) if name == "e_lt_k" else (24, 56, 34)

    def hull(masked, cyl):
        pts = rng.normal(size=(N, V, 3)) * 0.3
        R = np.linalg.qr(rng.normal(size=(N, 3, 3)))[0]
        R[:, :, 0] *= np.sign(np.linalg.det(R))[:, None]
        p = rng.normal(size=(N, 3)) * 0.1
        w = p[:, None] + pts @ R.transpose(0, 2, 1)
        he = rng.normal(size=(N, E, 2, 3)) * 0.3
        hm = (rng.uniform(size=(N, E)) > 0.2).astype(np.float64)
        if name == "duplicates":
            he[:, 1], he[:, 5], he[:, 9] = he[:, 0], he[:, 4], he[:, 8]
            hm[:, [0, 1, 4, 5, 8, 9]] = 1.0
        if masked:
            hm[:] = 0.0
        nf = rng.normal(size=(N, F, 3))
        nf /= np.linalg.norm(nf, axis=-1, keepdims=True)
        fm = (rng.uniform(size=(N, F)) > 0.15).astype(np.float64)
        fm[:, 0] = 1.0
        cylv = np.zeros((N, 3))
        if cyl:
            cylv[:] = [1.0, 0.2, 0.35]
        return dict(w=w, he=he, hm=hm, nf=nf, fm=fm, R=R, p=p, cyl=cylv)

    A = hull(name == "masked_A", name in ("cyl_A", "cyl_both"))
    B = hull(name == "masked_B", name in ("cyl_B", "cyl_both"))
    out = {k + "A": v for k, v in A.items()}
    out.update({k + "B": v for k, v in B.items()})
    return out
