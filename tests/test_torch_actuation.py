"""Port parity of the actuation pipeline (engine.fwd_actuation, the act
advance of the Euler update, the actuator branch of set_const) against the
JAX package, f64, 1e-10: same formulas, summation order aside.

Models are in-file XML strings covering motor, position, velocity, damper,
integrator, filter, filterexact and muscle actuators, ctrl / force / act
clamps, ball and free joint transmissions, and one site and one tendon
transmission (tests/test_torch_site_tendon_actuation.py holds those in
depth).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_sim_tpu import engine as jengine
from mujoco_sim_tpu.models.compile import compile_spec as jax_compile
from mujoco_sim_tpu.models.mjcf import parse_mjcf_string as jax_parse
from mujoco_sim_tpu.parallel.mesh import make_batch
from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.compile import compile_spec
from mujoco_sim_tpu_torch.models.convert import from_jax_data, from_jax_model
from mujoco_sim_tpu_torch.models.mjcf import parse_mjcf_string
from mujoco_sim_tpu_torch.parallel.rollout import rollout
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

TOL = 1e-10
NENV = 3

ARM = """
<mujoco>
  <option timestep="0.002" integrator="Euler"/>
  <compiler angle="radian"/>
  <worldbody>
    <site name="anchor" pos="0 0 1.2"/>
    <body name="b1" pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.2"
             limited="true" range="-2 2"/>
      <geom type="capsule" size="0.05" fromto="0 0 0 0.4 0 0" mass="1"/>
      <body name="b2" pos="0.4 0 0">
        <joint name="j2" type="hinge" axis="0 1 0" damping="0.1"/>
        <geom type="capsule" size="0.04" fromto="0 0 0 0.3 0 0" mass="0.5"/>
        <body name="b3" pos="0.3 0 0">
          <joint name="j3" type="slide" axis="1 0 0" damping="0.3"/>
          <geom type="sphere" size="0.04" mass="0.2"/>
          <site name="tip" pos="0 0 0"/>
        </body>
      </body>
    </body>
  </worldbody>
  {extra}
  <actuator>
{actuators}
  </actuator>
</mujoco>
"""

FREE_BALL = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002"/>
  <worldbody>
    <geom type="plane" size="3 3 0.1"/>
    <body pos="0 0 0.5">
      <freejoint name="fj"/>
      <geom type="box" size="0.1 0.1 0.1" mass="1"/>
      <body pos="0 0 0.15">
        <joint name="bj" type="ball" damping="0.1"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0 0 0.2"
              mass="0.3"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor joint="fj" gear="0 0 1 0 0 0"/>
    <motor joint="fj" gear="0 0 0 0.5 0 0.2"/>
    <motor joint="bj" gear="0 1 0"/>
    <position joint="bj" gear="1 0 0.5" kp="3"/>
  </actuator>
</mujoco>
"""

MODELS = {
    "full_set": ARM.format(extra="", actuators="""
    <motor name="a1" joint="j1" gear="2.5" ctrlrange="-1 1"/>
    <position name="a2" joint="j2" kp="15" forcerange="-3 3"/>
    <velocity name="a3" joint="j3" kv="4"/>
    <general name="a4" joint="j1" dyntype="filter" dynprm="0.05"
             gainprm="1.5"/>"""),
    "clamp_damper": ARM.format(extra="", actuators="""
    <motor name="m" joint="j1" ctrlrange="-0.5 0.5"/>
    <damper name="dmp" joint="j2" kv="2" ctrlrange="0 1"/>
    <motor name="m3" joint="j3"/>"""),
    "integrator_filterexact_actrange": ARM.format(extra="", actuators="""
    <general name="gi" joint="j2" dyntype="integrator" gainprm="8"
             biastype="affine" biasprm="0 -8 -1" actlimited="true"
             actrange="-0.02 0.02"/>
    <general name="fe" joint="j1" dyntype="filterexact" dynprm="0.03"
             gainprm="2"/>
    <intvelocity name="iv" joint="j3" kp="20" actrange="-0.1 0.1"/>"""),
    "muscle": ARM.format(extra="", actuators="""
    <muscle name="m1" joint="j1" gear="0.05"/>
    <muscle name="m2" joint="j2" force="80" timeconst="0.02 0.06"
            lengthrange="-0.1 0.1" gear="0.05"/>"""),
    "free_ball": FREE_BALL,
}
ACT_FIELDS = ("act_dot", "actuator_length", "actuator_velocity",
              "actuator_force", "qfrc_actuator")


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    """(JAX model, port model, a seeded batch away from qpos0) per model."""
    xml = MODELS[request.param]
    mj = jengine.set_const(jax_compile(jax_parse(xml)))
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    rng = np.random.default_rng(3)
    dj = make_batch(mj, NENV, dtype=jnp.float64)
    qpos = np.array(dj.qpos) + rng.uniform(-0.3, 0.3, dj.qpos.shape)
    if request.param == "free_ball":
        qpos[:, 2] += 1.0                     # clear of the floor
        for a in (3, 7):                      # unit quaternions
            qpos[:, a:a + 4] /= np.linalg.norm(qpos[:, a:a + 4], axis=1,
                                               keepdims=True)
    dj = dj.replace(
        qpos=jnp.asarray(qpos),
        qvel=jnp.asarray(rng.uniform(-1.0, 1.0, dj.qvel.shape)),
        act=jnp.asarray(rng.uniform(0.0, 0.6, dj.act.shape)),
        ctrl=jnp.asarray(rng.uniform(-1.5, 1.5, dj.ctrl.shape)))
    return mj, mt, dj


def test_set_const_actuator_acc0_matches_jax(pair):
    mj, _, _ = pair
    ours = engine.set_const(from_jax_model(mj))
    np.testing.assert_allclose(ours.actuator_acc0,
                               np.asarray(mj.actuator_acc0), rtol=0,
                               atol=1e-12)
    assert np.asarray(mj.actuator_acc0).max() > 0


def test_fwd_actuation_matches_jax(pair):
    mj, mt, dj = pair
    ref = jax.jit(jax.vmap(jengine.forward, in_axes=(None, 0)))(mj, dj)
    out = engine.forward(mt, from_jax_data(dj))
    for name in ACT_FIELDS + ("qacc",):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-10, atol=TOL, err_msg=name)
    assert float(out.actuator_force.abs().max()) > 0


def test_rollout_matches_jax(pair):
    """20 Euler steps: the activation state integrates identically."""
    mj, mt, dj = pair
    step = jax.jit(jax.vmap(jengine.step, in_axes=(None, 0)))
    ref = dj
    for _ in range(20):
        ref = step(mj, ref)
    out = rollout(mt, from_jax_data(dj), 20)
    for name in ("qpos", "qvel", "act") + ACT_FIELDS:
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-10, atol=TOL, err_msg=name)


def test_load_model_of_the_port_compiles_actuators():
    """The port's own compiler + set_const give the JAX package's model."""
    xml = MODELS["muscle"]
    ours = engine.set_const(compile_spec(parse_mjcf_string(xml)))
    ref = jengine.set_const(jax_compile(jax_parse(xml)))
    assert ours.nu == ref.nu == 2
    np.testing.assert_allclose(ours.actuator_acc0,
                               np.asarray(ref.actuator_acc0), atol=1e-12)
    np.testing.assert_allclose(ours.actuator_gainprm,
                               np.asarray(ref.actuator_gainprm), atol=0)


@pytest.mark.parametrize("kind", ["site", "tendon"])
def test_site_and_tendon_transmissions_match_jax(kind):
    """A site and a tendon transmission on the arm: the port's own
    compile + set_const give the JAX package's acc0, and forward() its
    actuator state and forces."""
    if kind == "site":
        extra, act = "", ('<general name="s" site="tip" '
                          'gear="1 0 0 0 0 0"/>')
    else:
        extra = ('<tendon><fixed name="t1"><joint joint="j1" coef="1"/>'
                 '<joint joint="j2" coef="-1"/></fixed></tendon>')
        act = '<motor name="t" tendon="t1"/>'
    xml = ARM.format(extra=extra, actuators=act)
    mj = jengine.set_const(jax_compile(jax_parse(xml)))
    ours = engine.set_const(compile_spec(parse_mjcf_string(xml)))
    np.testing.assert_allclose(ours.actuator_acc0,
                               np.asarray(mj.actuator_acc0), rtol=0,
                               atol=1e-12)
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    rng = np.random.default_rng(4)
    dj = make_batch(mj, NENV, dtype=jnp.float64)
    dj = dj.replace(
        qpos=jnp.asarray(np.array(dj.qpos)
                         + rng.uniform(-0.3, 0.3, dj.qpos.shape)),
        qvel=jnp.asarray(rng.uniform(-1.0, 1.0, dj.qvel.shape)),
        ctrl=jnp.asarray(rng.uniform(-1.5, 1.5, dj.ctrl.shape)))
    ref = jax.jit(jax.vmap(jengine.forward, in_axes=(None, 0)))(mj, dj)
    out = engine.forward(mt, from_jax_data(dj))
    for name in ACT_FIELDS:
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-10, atol=TOL, err_msg=name)
    assert float(out.qfrc_actuator.abs().max()) > 0
