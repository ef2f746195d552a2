"""Port parity of the RK4 and implicit integrators, of engine.inverse and
of make_data(keyframe=) with the JAX package (CPU, f64).

Scenes: tests/fixtures/implicit_implicit.xml (full implicit: the RNE
derivative by nv forward-mode jvp columns in the port, jax.jacfwd in the
JAX package), implicit_implicitfast.xml, and RK4 forced on arm.xml and on
floor_box.xml (contacts in every stage).  Tolerances: one step 1e-10
(same arithmetic; forward-mode AD sums in another order), 30 steps 1e-7
(1e-6 through contacts, where the Newton solver's stopping rule flips on
the last bit).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_sim_tpu import engine as jengine
from mujoco_sim_tpu.models.compile import load_model as jax_load_model
from mujoco_sim_tpu.models.model import Integrator
from mujoco_sim_tpu.parallel import mesh as jmesh
from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.convert import from_jax_data, from_jax_model
from mujoco_sim_tpu_torch.parallel.rollout import rollout
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
NENV = 3
CASES = {
    "implicit": ("implicit_implicit.xml", None, 1e-7),
    "implicitfast": ("implicit_implicitfast.xml", None, 1e-7),
    "rk4_arm": ("arm.xml", Integrator.RK4, 1e-7),
    "rk4_box_contacts": ("floor_box.xml", Integrator.RK4, 1e-6),
    "implicit_box_contacts": ("floor_box.xml", Integrator.IMPLICIT, 1e-6),
}


@pytest.fixture(scope="module", params=list(CASES))
def scene(request):
    xml, integ, tol = CASES[request.param]
    mj = jax_load_model(str(FIXTURES / xml))
    if integ is not None:
        mj = mj.replace(opt=mj.opt.replace(integrator=int(integ)))
    assert mj.opt.integrator != int(Integrator.EULER)
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    rng = np.random.default_rng(0)
    dj = jmesh.make_batch(mj, NENV, dtype=jnp.float64)
    qvel = rng.uniform(-0.5, 0.5, (NENV, mj.nv))
    if "box" in request.param:
        qvel[:, :3] = 0.0           # spin in place on the floor
    dj = dj.replace(qvel=jnp.asarray(qvel))
    if mj.nu:
        dj = dj.replace(ctrl=jnp.asarray(rng.uniform(-1, 1, (NENV, mj.nu))))
    return mj, mt, dj, tol


def test_one_step_matches_jax(scene):
    mj, mt, dj, _ = scene
    ref = jax.jit(jmesh.batched_step)(mj, dj)
    out = engine.step(mt, from_jax_data(dj))
    for name in ("qpos", "qvel", "act", "time", "qacc", "qacc_warmstart"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-10, atol=1e-10, err_msg=name)
    assert float(np.abs(np.asarray(ref.qvel - dj.qvel)).max()) > 1e-4


def test_rollout_matches_jax(scene):
    mj, mt, dj, tol = scene
    ref = jax.jit(jmesh.rollout, static_argnums=2)(mj, dj, 30)
    out = rollout(mt, from_jax_data(dj), 30)
    np.testing.assert_allclose(out.qpos.numpy(), np.asarray(ref.qpos),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(out.qvel.numpy(), np.asarray(ref.qvel),
                               rtol=0, atol=10 * tol)


def test_step2_dispatches_on_the_integrator(scene):
    """step1 -> step2 is the step for every integrator."""
    _, mt, dj, _ = scene
    d0 = from_jax_data(dj)
    want = engine.step(mt, d0)
    got = engine.step2(mt, engine.step1(mt, d0))
    assert torch.equal(want.qpos, got.qpos)
    assert torch.equal(want.qvel, got.qvel)


@pytest.mark.parametrize("xml", ["efc_scene.xml", "elliptic_box.xml",
                                 "arm.xml"])
def test_inverse_matches_jax(xml):
    """engine.inverse at an arbitrary (state, qacc): friction-loss, limit,
    equality and contact rows of both cones."""
    mj = jax_load_model(str(FIXTURES / xml))
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    rng = np.random.default_rng(4)
    dj = jmesh.make_batch(mj, NENV, dtype=jnp.float64).replace(
        qvel=jnp.asarray(rng.uniform(-0.3, 0.3, (NENV, mj.nv))))
    qacc = rng.standard_normal((NENV, mj.nv))
    ref = jax.vmap(jengine.inverse, in_axes=(None, 0, 0))(
        mj, dj, jnp.asarray(qacc))
    out = engine.inverse(mt, from_jax_data(dj), torch.tensor(qacc))
    assert out.shape == (NENV, mj.nv)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10,
                               atol=1e-9)
    # at the solved state, inverse(forward) returns the applied force
    fwd = engine.forward(mt, from_jax_data(dj))
    back = engine.inverse(mt, from_jax_data(dj), fwd.qacc)
    np.testing.assert_allclose(
        back.numpy(), (fwd.qfrc_applied + fwd.qfrc_actuator).numpy(),
        rtol=0, atol=1e-5)


KEYED = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002"/>
  <worldbody>
    <geom type="plane" size="2 2 0.1"/>
    <body pos="0 0 0.5"><freejoint/>
      <geom type="box" size="0.1 0.08 0.06" mass="1"/></body>
    <body pos="0.5 0 0.3">
      <joint name="h" type="hinge" axis="0 1 0" damping="0.2"/>
      <geom type="capsule" size="0.02" fromto="0 0 0 0.2 0 0" mass="0.4"/>
    </body>
  </worldbody>
  <actuator><motor joint="h" gear="1.5"/></actuator>
  <keyframe>
    <key name="tossed" time="0.5"
         qpos="0.1 -0.05 0.8 0.9689124 0.2474040 0 0 0.4"
         qvel="1 0 2 0.5 0 0 -0.8" ctrl="0.3"/>
    <key name="rest" qpos="0 0 0.161 1 0 0 0 0"/>
  </keyframe>
</mujoco>
"""


@pytest.mark.parametrize("key", ["tossed", "rest", 0, 1])
def test_make_data_keyframe_matches_jax(key, tmp_path):
    path = tmp_path / "keyed.xml"
    path.write_text(KEYED)
    mj = jax_load_model(str(path))
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    ref = jengine.make_data(mj, dtype=jnp.float64, keyframe=key)
    out = engine.make_data(mt, 2, keyframe=key)
    for name in ("time", "qpos", "qvel", "act", "ctrl", "mocap_pos",
                 "mocap_quat"):
        o = getattr(out, name).numpy()
        r = np.asarray(getattr(ref, name))
        assert o.shape == (2,) + r.shape, name
        np.testing.assert_array_equal(o[0], r, err_msg=name)
        np.testing.assert_array_equal(o[1], r, err_msg=name)
    # and it steps like the JAX package from there
    sj = jengine.step(mj, ref)
    st = engine.step(mt, out)
    np.testing.assert_allclose(st.qpos[0].numpy(), np.asarray(sj.qpos),
                               rtol=1e-10, atol=1e-10)


def test_make_data_unknown_keyframe_raises(tmp_path):
    path = tmp_path / "keyed.xml"
    path.write_text(KEYED)
    mt = engine.put_model(from_jax_model(jax_load_model(str(path))),
                          torch.float64, "cpu")
    with pytest.raises(ValueError, match="keyframe"):
        engine.make_data(mt, 1, keyframe=7)
