"""Port parity of the noslip pass and of the qLD factor it needs
(mujoco_sim_tpu_torch/ops/noslip.py, engine.fwd_position) with the JAX
package (CPU, f64), on tests/fixtures/noslip_box.xml (pyramidal pairs) and
elliptic_noslip.xml (elliptic friction rows).

Tolerances.  The noslip function itself, fed the JAX package's solved
state, agrees to 1e-10 (its B = M^-1 Jd^T comes from torch.cholesky_solve
instead of the unrolled substitution).  Whole steps are compared on qLD,
qacc, efc_force, qpos and qvel at 1e-7 after one step and 1e-5 after 20:
the Newton solver stops on `improved < tolerance` (1e-8) and rejects a
step whose cost rises by one ulp, so two implementations that differ in
the last bit can stop one iteration apart and then agree to the solver's
tolerance, not to rounding (measured: 9.5e-9 on qacc after one step of
elliptic_noslip.xml, 1e-15 on noslip_box.xml).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_sim_tpu import engine as jengine
from mujoco_sim_tpu.models.compile import load_model as jax_load_model
from mujoco_sim_tpu.ops import noslip as jnoslip
from mujoco_sim_tpu.parallel import mesh as jmesh
from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.convert import from_jax_data, from_jax_model
from mujoco_sim_tpu_torch.ops import noslip
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
NENV = 3


@pytest.fixture(scope="module", params=["noslip_box.xml",
                                        "elliptic_noslip.xml"])
def scene(request):
    mj = jax_load_model(str(FIXTURES / request.param))
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    rng = np.random.default_rng(0)
    dj = jmesh.make_batch(mj, NENV, dtype=jnp.float64)
    # a gentle push along the floor: friction inside its bounds, with slip
    # left for the noslip pass to null
    qvel = np.zeros((NENV, mj.nv))
    qvel[:, :2] = rng.uniform(-0.01, 0.01, (NENV, 2))
    return mj, mt, dj.replace(qvel=jnp.asarray(qvel))


def test_plan_matches_jax(scene):
    mj, mt, _ = scene
    rows_p, rows_m, kinds, con_k, con_a = jnoslip._plan(mj)
    pl = noslip._plan(mt)
    np.testing.assert_array_equal(pl["rows_p"], rows_p)
    np.testing.assert_array_equal(pl["rows_m"], rows_m)
    np.testing.assert_array_equal(pl["is_pair"], kinds == 1)
    np.testing.assert_array_equal(pl["is_ell"], kinds == 2)
    np.testing.assert_array_equal(pl["con_k"], con_k)
    np.testing.assert_array_equal(pl["con_a"], con_a)
    assert len(rows_p) > 0 and mj.opt.noslip_iterations > 0


def test_noslip_function_matches_jax_on_the_same_solved_state(scene):
    mj, mt, dj = scene

    def solved(m, d):
        d = jengine.forward_core(m, d.replace(qacc_warmstart=d.qacc))
        return d

    # forward_core includes noslip; undo it by solving without noslip
    m0 = mj.replace(opt=mj.opt.replace(noslip_iterations=0))
    pre = jax.vmap(solved, in_axes=(None, 0))(m0, dj)
    # the no-noslip path leaves qLD as the factor too on the CPU
    ref = jax.vmap(jnoslip.noslip, in_axes=(None, 0))(mj, pre)
    out = noslip.noslip(mt, from_jax_data(pre))
    assert float(jnp.abs(ref.efc_force - pre.efc_force).max()) > 1e-6
    for name in ("qacc", "efc_force", "qfrc_constraint"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-10, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("nsteps,tol", [(1, 1e-7), (20, 1e-5)])
def test_steps_match_jax(scene, nsteps, tol):
    mj, mt, dj = scene
    step = jax.jit(jmesh.batched_step)
    dt = from_jax_data(dj)
    for _ in range(nsteps):
        dj = step(mj, dj)
        dt = engine.step(mt, dt)
    assert int(dt.ncon.min()) > 0
    assert float(dt.qLD.abs().max()) > 0
    for name in ("qLD", "qacc", "efc_force", "qpos", "qvel"):
        np.testing.assert_allclose(getattr(dt, name).numpy(),
                                   np.asarray(getattr(dj, name)),
                                   rtol=tol, atol=tol, err_msg=name)
    # qLD is the factor of qM
    np.testing.assert_allclose(
        (dt.qLD @ dt.qLD.transpose(-1, -2)).numpy(), dt.qM.numpy(),
        rtol=1e-12, atol=1e-12)


def test_factor_chol_takes_the_twin_on_cpu_tensors(scene):
    """smooth.factor_chol dispatches by device: on a CPU tensor it is
    ops/linalg.cholesky (the JAX package's factor_chol)."""
    from mujoco_sim_tpu.ops import smooth as jsmooth
    from mujoco_sim_tpu_torch.ops import smooth
    from mujoco_sim_tpu_torch.runtime import profiler
    rng = np.random.default_rng(1)
    M = rng.standard_normal((5, 9, 9))
    A = M @ M.transpose(0, 2, 1) + 9 * np.eye(9)
    with profiler.counting("cpu"):
        before = profiler.counts("cpu")["chol_factor"]
        L = smooth.factor_chol(torch.tensor(A))
        # no kernel on the CPU
        assert profiler.counts("cpu")["chol_factor"] == before
    ref = jax.vmap(jsmooth.factor_chol)(jnp.asarray(A))
    np.testing.assert_allclose(L.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)
