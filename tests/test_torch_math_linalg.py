"""Port parity: ops/math.py, ops/linalg.py and the chol_solve plain path
against the JAX package on seeded numpy inputs (f64, 1e-12).  The CUDA
kernel against its plain twin is tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_sim_tpu.ops import linalg as jlinalg
from mujoco_sim_tpu.ops import math as jmath
from mujoco_sim_tpu_torch.ops import chol
from mujoco_sim_tpu_torch.ops import linalg as tlinalg
from mujoco_sim_tpu_torch.ops import math as tmath
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

TOL = 1e-12


def _quat(rng, *shape):
    q = rng.standard_normal(shape + (4,))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _inputs(name, rng):
    v3 = lambda: rng.standard_normal((6, 3))            # noqa: E731
    v6 = lambda: rng.standard_normal((6, 6))            # noqa: E731
    if name in ("quat_mul", "quat_sub"):
        return (_quat(rng, 6), _quat(rng, 6))
    if name == "quat_inv":
        return (_quat(rng, 6),)
    if name == "quat_normalize":
        q = rng.standard_normal((6, 4))
        q[0] = 0.0                           # degenerate -> identity
        return (q,)
    if name in ("rot_vec_quat", "rot_vec_quat_inv"):
        return (v3(), _quat(rng, 6))
    if name == "quat_to_mat":
        return (_quat(rng, 6),)
    if name == "mat_to_quat":
        # every branch of the best-conditioned candidate pick
        q = np.concatenate([_quat(rng, 8), np.eye(4)])
        return (np.array(jmath.quat_to_mat(jnp.asarray(q))),)
    if name == "axis_angle_to_quat":
        return (v3(), rng.standard_normal(6))
    if name == "quat_integrate":
        return (_quat(rng, 6), v3(), 0.01)
    if name in ("motion_cross", "force_cross"):
        return (v6(), v6())
    if name in ("skew", "normalize_with_norm"):
        return (v3(),)
    if name == "spatial_inertia":
        A = rng.standard_normal((6, 3, 3))
        return (rng.uniform(0.5, 2.0, 6), A @ A.transpose(0, 2, 1), v3())
    if name == "transform_motion":
        return (v6(), v3(), np.array(jmath.quat_to_mat(
            jnp.asarray(_quat(rng, 6)))))
    raise KeyError(name)


MATH_FNS = ["quat_mul", "quat_inv", "quat_normalize", "rot_vec_quat",
            "rot_vec_quat_inv", "quat_to_mat", "mat_to_quat",
            "axis_angle_to_quat", "quat_integrate", "quat_sub",
            "motion_cross", "force_cross", "skew", "spatial_inertia",
            "transform_motion", "normalize_with_norm"]


@pytest.mark.parametrize("name", MATH_FNS)
def test_math_matches_jax(name):
    args = _inputs(name, np.random.default_rng(MATH_FNS.index(name)))
    ref = getattr(jmath, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray)
                                 else a for a in args])
    out = getattr(tmath, name)(*[torch.as_tensor(a)
                                 if isinstance(a, np.ndarray) else a
                                 for a in args])
    refs = ref if isinstance(ref, tuple) else (ref,)
    outs = out if isinstance(out, tuple) else (out,)
    for r, o in zip(refs, outs):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                   atol=TOL)


def _spd(rng, n, scale=1.0):
    A = rng.standard_normal((n, n))
    return (A @ A.T + n * np.eye(n)) * scale


@pytest.mark.parametrize("n", [3, 16, 20, 41])
def test_linalg_matches_jax(n):
    """Unrolled (n <= 16) and blocked (n > 16) factor and solves."""
    rng = np.random.default_rng(n)
    A = np.stack([_spd(rng, n) for _ in range(5)])
    b = rng.standard_normal((5, n))
    Bm = rng.standard_normal((5, n, 2))
    Lj = jlinalg.cholesky(jnp.asarray(A))
    Lt = tlinalg.cholesky(torch.as_tensor(A))
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), rtol=0, atol=TOL)
    L = np.array(Lj)
    pairs = [
        (tlinalg.solve_lower(torch.as_tensor(L), torch.as_tensor(Bm)),
         jlinalg.solve_lower(Lj, jnp.asarray(Bm))),
        (tlinalg.solve_upper(torch.as_tensor(L).transpose(-1, -2),
                             torch.as_tensor(Bm)),
         jlinalg.solve_upper(jnp.swapaxes(Lj, -1, -2), jnp.asarray(Bm))),
        (tlinalg.cho_solve(torch.as_tensor(L), torch.as_tensor(b)),
         jlinalg.cho_solve(Lj, jnp.asarray(b))),
        (tlinalg.cho_solve_mat(torch.as_tensor(L), torch.as_tensor(Bm)),
         jlinalg.cho_solve_mat(Lj, jnp.asarray(Bm))),
    ]
    for out, ref in pairs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL)


def _chol_cases():
    """The cases of tests/test_pallas_chol.py, in f64."""
    rng = np.random.default_rng(0)
    n, N = 49, 130
    big = (np.stack([_spd(rng, n) for _ in range(N)]),
           rng.standard_normal((N, n)))
    rng = np.random.default_rng(1)
    A = np.stack([_spd(rng, 12) for _ in range(4)])
    A[:, 0, 0] += 1e9                    # stiff Newton-Hessian rows
    stiff = (A, rng.standard_normal((4, 12)))
    rng = np.random.default_rng(2)
    n, B, E = 7, 3, 5
    batched = (np.stack([[_spd(rng, n) for _ in range(B)]
                         for _ in range(E)]),
               rng.standard_normal((E, B, n)))
    return {"n49_N130": big, "stiff_1e9": stiff, "batched_ExB": batched}


@pytest.mark.parametrize("case", ["n49_N130", "stiff_1e9", "batched_ExB"])
def test_chol_solve_plain_path_matches_jax(case):
    A, b = _chol_cases()[case]
    x = chol.chol_solve(torch.as_tensor(A), torch.as_tensor(b))
    ref = jlinalg.cho_solve(jlinalg.cholesky(jnp.asarray(A)), jnp.asarray(b))
    np.testing.assert_allclose(x.numpy(), np.asarray(ref), rtol=0, atol=TOL)
    r = np.einsum("...ij,...j->...i", A, x.numpy()) - b
    assert np.abs(r).max() < 1e-6, np.abs(r).max()


def test_chol_solve_rejects_unsupported_device():
    A = torch.eye(3, device="meta")[None]
    with pytest.raises(ValueError):
        chol.chol_solve(A, torch.zeros(1, 3, device="meta"))

