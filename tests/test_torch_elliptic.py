"""Port parity of the elliptic friction cone (ops/constraint.py rows,
ops/solver.py _EllipticCone, the bracketing line search,
constraint_force_from_qacc) with the JAX package (CPU, f64) on
tests/fixtures/elliptic_box.xml.

Tolerances: the cone's cost / gradient / Hessian and the constraint rows
are the same arithmetic: 1e-12 relative.  One Newton iteration (which
exposes the line search's alpha: qacc = a0 + alpha p) agrees to 1e-9.
Converged solves and rollouts are held to 1e-6: the solver's own stopping
tolerance is 1e-8 and its accept / reject test flips on the last bit.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_sim_tpu import engine as jengine
from mujoco_sim_tpu.models.compile import load_model as jax_load_model
from mujoco_sim_tpu.ops import solver as jsolver
from mujoco_sim_tpu.parallel import mesh as jmesh
from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.convert import from_jax_data, from_jax_model
from mujoco_sim_tpu_torch.ops import solver
from mujoco_sim_tpu_torch.parallel.rollout import rollout
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIXTURE = str(pathlib.Path(__file__).resolve().parent / "fixtures"
              / "elliptic_box.xml")
NENV = 3


def _pre(m, d):
    d = jengine.fwd_position(m, d)
    d = jengine.fwd_velocity(m, d)
    d = jengine.fwd_actuation(m, d)
    return jengine.fwd_acceleration(m, d)


@pytest.fixture(scope="module")
def scene():
    """(JAX model, port model, JAX batch pushed along the floor, the JAX
    state just before the solve)."""
    mj = jax_load_model(FIXTURE)
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    rng = np.random.default_rng(0)
    qvel = np.zeros((NENV, mj.nv))
    qvel[:, :2] = rng.uniform(-0.3, 0.3, (NENV, 2))
    qvel[:, 5] = rng.uniform(-0.5, 0.5, NENV)
    dj = jmesh.make_batch(mj, NENV, dtype=jnp.float64).replace(
        qvel=jnp.asarray(qvel))
    pre = jax.vmap(_pre, in_axes=(None, 0))(mj, dj)
    return mj, mt, dj, pre


def test_elliptic_rows_match_jax(scene):
    mj, mt, dj, pre = scene
    out = engine.fwd_position(mt, from_jax_data(dj))
    assert int(out.ncon.min()) > 0
    for name in ("efc_J", "efc_D", "efc_R", "efc_aref", "efc_active",
                 "efc_type", "efc_frictionloss"):
        np.testing.assert_allclose(
            getattr(out, name).numpy().astype(float),
            np.asarray(getattr(pre, name)).astype(float),
            rtol=1e-12, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("zone", ["top", "middle", "bottom", "frictionless"])
def test_cone_terms_match_jax_in_every_zone(scene, zone):
    """Random jar vectors placed in one zone of the cone: N >= mu T (top),
    T <= -mu N (bottom), between (middle), and contacts of dim 1."""
    mj, mt, _, pre = scene
    crows, _ = jsolver._cone_plan(mj)
    rp = crows.shape[1]
    K = crows.shape[0]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((NENV, K, rp))
    x[..., 0] = {"top": 50.0, "bottom": -50.0}.get(zone, 0.0) \
        + 0.1 * rng.standard_normal((NENV, K))
    if zone == "frictionless":
        con = pre.contact.replace(dim=jnp.ones_like(pre.contact.dim))
        pre = pre.replace(contact=con)
    dt = from_jax_data(pre)

    def jterms(d, xc):
        return jsolver._EllipticCone(mj, d, crows).terms(xc)

    ref = jax.vmap(jterms)(pre, jnp.asarray(x))
    cone = solver._EllipticCone(mt, dt, solver._cone_plan(mt, torch.float64))
    out = cone.terms(torch.tensor(x))
    # the jar really lies in the zone asked for
    N, T = x[..., 0], np.linalg.norm(x[..., 1:] * cone.s.numpy(), axis=-1)
    muv = cone.muv.numpy()
    act = np.asarray(pre.contact.active)
    want = {"top": N >= muv * T, "bottom": T <= -muv * N,
            "middle": ~(N >= muv * T) & ~(T <= -muv * N),
            "frictionless": np.ones_like(act)}[zone]
    assert want[act].all() and act.any()
    for o, r, name in zip(out, ref, ("cost", "grad", "hess")):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12, err_msg=name)
    if zone != "top":
        assert float(out[0].abs().max()) > 0
    no_hess = cone.terms(torch.tensor(x), need_hess=False)
    assert no_hess[2] is None and torch.equal(no_hess[1], out[1])


def test_one_newton_iteration_matches_jax(scene):
    """solver_iterations = 1: qacc = a0 + alpha p, so this holds the
    bracket-then-safeguarded-Newton line search's alpha."""
    mj, mt, _, pre = scene
    m1 = mj.replace(opt=mj.opt.replace(solver_iterations=1))
    t1 = mt.replace(opt=mt.opt.replace(solver_iterations=1))
    ref = jax.vmap(jsolver.solve, in_axes=(None, 0))(m1, pre)
    out = solver.solve(t1, from_jax_data(pre))
    assert float(jnp.abs(ref.qacc - pre.qacc_smooth).max()) > 1e-3
    for name in ("qacc", "efc_force", "qfrc_constraint"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-9, atol=1e-9, err_msg=name)


def test_converged_solve_and_inverse_force_match_jax(scene):
    mj, mt, _, pre = scene
    ref = jax.vmap(jsolver.solve, in_axes=(None, 0))(mj, pre)
    dt = from_jax_data(pre)
    out = solver.solve(mt, dt)
    np.testing.assert_allclose(out.qacc.numpy(), np.asarray(ref.qacc),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(out.efc_force.numpy(),
                               np.asarray(ref.efc_force), rtol=1e-6,
                               atol=1e-5)
    # the inverse constraint solver at a given qacc: same arithmetic
    qacc = np.random.default_rng(5).standard_normal((NENV, mj.nv))
    rf, rq = jax.vmap(
        lambda d, a: jsolver.constraint_force_from_qacc(mj, d, a))(
            pre, jnp.asarray(qacc))
    of, oq = solver.constraint_force_from_qacc(mt, dt, torch.tensor(qacc))
    np.testing.assert_allclose(of.numpy(), np.asarray(rf), rtol=1e-12,
                               atol=1e-9)
    np.testing.assert_allclose(oq.numpy(), np.asarray(rq), rtol=1e-12,
                               atol=1e-9)


def test_rollout_matches_jax():
    """A box dropped flat from 2 mm and left to settle for 60 steps."""
    mj = jax_load_model(FIXTURE)
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    dj = jmesh.make_batch(mj, 2, dtype=jnp.float64)
    dj = dj.replace(qpos=dj.qpos.at[:, 2].add(jnp.asarray([0.0, 0.002])))
    ref = jax.jit(jmesh.rollout, static_argnums=2)(mj, dj, 60)
    out = rollout(mt, from_jax_data(dj), 60)
    assert int(out.ncon.min()) > 0
    np.testing.assert_allclose(out.qpos.numpy(), np.asarray(ref.qpos),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.qvel.numpy(), np.asarray(ref.qvel),
                               rtol=0, atol=1e-5)
