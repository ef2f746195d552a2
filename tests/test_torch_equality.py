"""Port parity of the equality rows (ops/constraint.py: joint polycoef,
connect, weld, tendon polycoef; the row permutation) with the JAX package
(CPU, f64): the efc rows after fwd_position, then a rollout.  On
tests/fixtures/efc_scene.xml (a joint couple beside friction-loss, limit
and contact rows), on a scene written here that interleaves a weld, a
connect and a joint couple, so the [JOINT | CONNECT | WELD] block order
has to be permuted back into address order, and on tests/test_tendons.py's
tendon-equality arm.

Tolerances: rows 1e-12 (same arithmetic); rollouts 1e-6 (40 steps through
the Newton solver, whose stopping rule flips on the last bit).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_sim_tpu import engine as jengine
from mujoco_sim_tpu.models.compile import compile_spec as jax_compile
from mujoco_sim_tpu.models.compile import load_model as jax_load_model
from mujoco_sim_tpu.models.mjcf import parse_mjcf_string as jax_parse
from mujoco_sim_tpu.parallel import mesh as jmesh
from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.convert import from_jax_data, from_jax_model
from mujoco_sim_tpu_torch.ops import constraint
from mujoco_sim_tpu_torch.parallel.rollout import rollout
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
NENV = 3

MIXED = """
<mujoco>
  <option timestep="0.004" gravity="0 0 -9.81"/>
  <worldbody>
    <geom type="plane" size="0 0 .05"/>
    <body name="a" pos="0 0 0.6">
      <joint name="a1" type="hinge" axis="0 1 0" damping="0.05"/>
      <geom type="capsule" size=".02" fromto="0 0 0 .2 0 0"/>
      <body name="b" pos=".2 0 0">
        <joint name="b1" type="hinge" axis="0 1 0" damping="0.05"/>
        <geom type="capsule" size=".02" fromto="0 0 0 .2 0 0"/>
      </body>
    </body>
    <body name="c" pos="0.4 0.1 0.6"><freejoint/>
      <geom type="box" size=".05 .04 .03"/></body>
    <body name="e" pos="-0.3 0 0.5"><freejoint/>
      <geom type="sphere" size=".05"/></body>
    <body name="f" pos="-0.3 0 0.7"><freejoint/>
      <geom type="sphere" size=".04"/></body>
  </worldbody>
  <equality>
    <weld body1="b" body2="c" anchor="0.2 0 0" torquescale="0.7"/>
    <joint joint1="b1" joint2="a1" polycoef="0.05 -0.5 0.1 0 0"/>
    <connect body1="e" body2="f" anchor="0 0 0.1"/>
    <joint joint1="a1" polycoef="0.1 0 0 0 0" active="false"/>
  </equality>
</mujoco>
"""


@pytest.fixture(scope="module", params=["efc_scene", "mixed"])
def scene(request, tmp_path_factory):
    if request.param == "mixed":
        path = tmp_path_factory.mktemp("eq") / "mixed_eq.xml"
        path.write_text(MIXED)
    else:
        path = FIXTURES / "efc_scene.xml"
    mj = jax_load_model(str(path))
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    rng = np.random.default_rng(0)
    dj = jmesh.make_batch(mj, NENV, dtype=jnp.float64)
    qpos = np.asarray(dj.qpos).copy()
    hinge = [int(a) for a, t in zip(mj.layout.jnt_qposadr, mj.layout.jnt_type)
             if int(t) == 3]
    qpos[:, hinge] += rng.uniform(-0.2, 0.2, (NENV, len(hinge)))
    qvel = rng.uniform(-0.2, 0.2, (NENV, mj.nv))
    return mj, mt, dj.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel))


def test_equality_rows_match_jax(scene):
    mj, mt, dj = scene
    ref = jax.vmap(jengine.fwd_position, in_axes=(None, 0))(mj, dj)
    out = engine.fwd_position(mt, from_jax_data(dj))
    assert mj.neq > 0 and bool((np.asarray(ref.efc_type) == 0).any())
    for name in ("efc_J", "efc_D", "efc_R", "efc_aref", "efc_active",
                 "efc_type", "efc_frictionloss", "efc_floss_active"):
        np.testing.assert_allclose(
            getattr(out, name).numpy().astype(float),
            np.asarray(getattr(ref, name)).astype(float),
            rtol=1e-12, atol=1e-12, err_msg=name)


def test_equality_plan_matches_jax(scene):
    from mujoco_sim_tpu.ops import constraint as jconstraint
    mj, mt, _ = scene
    ref = jconstraint._eq_plan(mj)
    plan = constraint._eq_plan_np(mt)
    np.testing.assert_array_equal(plan["perm"], ref.perm)
    assert plan["perm_is_identity"] == ref.perm_is_identity
    for ours, theirs in (("jsel", "jsel"), ("csel", "csel"),
                         ("wsel", "wsel")):
        np.testing.assert_array_equal(plan[ours], getattr(ref, theirs))


def test_equality_disabled_by_flag(scene):
    from mujoco_sim_tpu_torch.models.model import DisableBit
    mj, mt, dj = scene
    off = mt.replace(opt=mt.opt.replace(
        disableflags=mt.opt.disableflags | int(DisableBit.EQUALITY)))
    out = engine.fwd_position(off, from_jax_data(dj))
    assert not bool(out.efc_active[:, out.efc_type[0] == 0].any())


def test_rollout_matches_jax(scene):
    mj, mt, dj = scene
    n = 40
    ref = jax.jit(jmesh.rollout, static_argnums=2)(mj, dj, n)
    out = rollout(mt, from_jax_data(dj), n)
    np.testing.assert_allclose(out.qpos.numpy(), np.asarray(ref.qpos),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.qvel.numpy(), np.asarray(ref.qvel),
                               rtol=0, atol=1e-5)


def test_tendon_equality_rows_match_jax():
    """Tendon couples (L1 - L1_0) = poly(L2 - L2_0): the efc rows after
    fwd_position and a 40-step rollout, on tests/test_tendons.py's
    tendon-equality arm."""
    from tests.test_torch_tendons import TEN_EQ
    mj = jengine.set_const(jax_compile(jax_parse(TEN_EQ)))
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    rng = np.random.default_rng(2)
    dj = jmesh.make_batch(mj, NENV, dtype=jnp.float64)
    dj = dj.replace(
        qpos=jnp.asarray(rng.uniform(-0.3, 0.3, (NENV, mj.nq))),
        qvel=jnp.asarray(rng.uniform(-0.5, 0.5, (NENV, mj.nv))))
    ref = jax.jit(jax.vmap(jengine.forward, in_axes=(None, 0)))(mj, dj)
    out = engine.forward(mt, from_jax_data(dj))
    assert np.asarray(ref.efc_active).any()
    for f in ("efc_J", "efc_R", "efc_D", "efc_aref"):
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-12,
                                   atol=1e-12, err_msg=f)
    np.testing.assert_array_equal(out.efc_active.numpy(),
                                  np.asarray(ref.efc_active))
    n = 40
    ref = jax.jit(jmesh.rollout, static_argnums=2)(mj, dj, n)
    out = rollout(mt, from_jax_data(dj), n)
    np.testing.assert_allclose(out.qpos.numpy(), np.asarray(ref.qpos),
                               rtol=0, atol=1e-6)
