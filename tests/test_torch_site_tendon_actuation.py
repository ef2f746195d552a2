"""Port parity of the site and tendon transmissions (engine.fwd_actuation,
the tendon rows of set_const's actuator_acc0) with the JAX package (CPU,
f64).

Scenes: tests/test_actuators.py's site-transmission arm (one site
actuator without and one with a refsite, 6D gears); fixed tendons with a
tendon actuator (tests/test_tendons.py); a muscle on a fixed tendon with
the default force scale (which reads the tendon row of actuator_acc0)
beside tests/test_muscles.py's joint and tendon muscles; a muscle on a
spatial tendon with an explicit lengthrange.  States are seeded
perturbations of qpos0 with seeded ctrl and act.

The moment rows are compared through qfrc_actuator = sum_k force_k
moment_k at states whose forces differ from env to env.  Tolerances:
actuator_length, velocity, force and qfrc_actuator 1e-10; acc0 1e-10;
100-step rollouts 1e-8 on qpos and act.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_sim_tpu import engine as jengine
from mujoco_sim_tpu.models.compile import compile_spec as jax_compile
from mujoco_sim_tpu.models.mjcf import parse_mjcf_string as jax_parse
from mujoco_sim_tpu.parallel import mesh as jmesh
from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.compile import compile_spec
from mujoco_sim_tpu_torch.models.convert import from_jax_data, from_jax_model
from mujoco_sim_tpu_torch.models.mjcf import parse_mjcf_string
from mujoco_sim_tpu_torch.parallel.rollout import rollout
from tests.test_torch_tendons import ARM as TENDON_ARM, SPATIAL
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

TOL = 1e-10
NENV = 4

SITE_ARM = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002"/>
  <worldbody>
    <site name="ref" pos="0.1 0.2 0.3" euler="0.3 0.2 0.1"/>
    <body pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom type="capsule" size="0.02" fromto="0 0 0 0.3 0 0" mass="1"/>
      <body pos="0.3 0 0">
        <joint name="j2" type="slide" axis="1 0 0" damping="0.2"/>
        <geom type="sphere" size="0.03" mass="0.2"/>
        <site name="tip" pos="0.05 0.02 -0.01" euler="0.1 0.4 0.2"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <general name="a_site" site="tip" gear="1 2 3 0.5 0.4 0.3"/>
    <general name="a_ref"  site="tip" refsite="ref" gear="1 2 3 0.5 0.4 0.3"/>
  </actuator>
</mujoco>
"""

MUSCLES = """
<mujoco>
  <compiler angle="radian" autolimits="true"/>
  <option timestep="0.002"/>
  <worldbody>
    <body pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0" range="-1.2 1.4"
             damping="0.1"/>
      <geom type="capsule" size="0.02" fromto="0 0 0 0.3 0 0" mass="1"/>
      <body pos="0.3 0 0">
        <joint name="j2" type="hinge" axis="0 1 0" range="-0.9 1.1"
               damping="0.05"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0.2 0 0" mass="0.4"/>
      </body>
    </body>
  </worldbody>
  <tendon>
    <fixed name="t1">
      <joint joint="j1" coef="0.03"/><joint joint="j2" coef="-0.02"/>
    </fixed>
  </tendon>
  <actuator>
    <muscle name="m1" joint="j1" gear="0.05"/>
    <muscle name="m2" tendon="t1" force="80" timeconst="0.02 0.06"
            lmin="0.4" lmax="1.7" vmax="2.0"/>
    <muscle name="m3" tendon="t1" gear="2"/>
  </actuator>
</mujoco>
"""

SCENES = {
    "site_refsite": SITE_ARM,
    "tendon_motor": TENDON_ARM,
    "tendon_muscles": MUSCLES,
    "spatial_muscle": SPATIAL.replace(
        '<general name="wind" tendon="cable" gainprm="5"/>',
        '<general name="wind" tendon="cable" gainprm="5"/>'
        '<muscle name="mus" tendon="cable" lengthrange="0.35 0.95"/>'),
}
FIELDS = ("actuator_length", "actuator_velocity", "actuator_force",
          "act_dot", "qfrc_actuator")
_CACHE = {}


def _scene(name):
    if name in _CACHE:
        return _CACHE[name]
    mj = jengine.set_const(jax_compile(jax_parse(SCENES[name])))
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    rng = np.random.default_rng(11)
    dj = jmesh.make_batch(mj, NENV, dtype=jnp.float64)
    qpos = np.array(dj.qpos) + rng.uniform(-0.3, 0.3, dj.qpos.shape)
    dj = dj.replace(
        qpos=jnp.asarray(qpos),
        qvel=jnp.asarray(rng.uniform(-1.0, 1.0, dj.qvel.shape)),
        act=jnp.asarray(rng.uniform(0.0, 0.8, dj.act.shape)),
        ctrl=jnp.asarray(rng.uniform(-1.0, 1.0, dj.ctrl.shape)))
    ref = jax.jit(jax.vmap(jengine.forward, in_axes=(None, 0)))(mj, dj)
    out = engine.forward(mt, from_jax_data(dj))
    _CACHE[name] = (mj, mt, dj, ref, out)
    return _CACHE[name]


@pytest.mark.parametrize("name", list(SCENES))
def test_transmissions_match_jax(name):
    _, _, _, ref, out = _scene(name)
    for f in FIELDS + ("qacc",):
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=TOL,
                                   atol=TOL if f != "qacc" else 1e-9,
                                   err_msg=f)
    # forces differ from env to env, so qfrc_actuator pins the moment rows
    f = out.actuator_force.numpy()
    assert np.abs(f).max() > 0 and np.ptp(f, axis=0).min() > 0


@pytest.mark.parametrize("name", list(SCENES))
def test_set_const_acc0_matches_jax(name):
    ref = _scene(name)[0]
    ours = engine.set_const(compile_spec(parse_mjcf_string(SCENES[name])))
    np.testing.assert_allclose(ours.actuator_acc0,
                               np.asarray(ref.actuator_acc0), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(ours.actuator_lengthrange,
                               np.asarray(ref.actuator_lengthrange), atol=0)


def test_refsite_length_is_nonzero_and_site_length_zero():
    """Without a refsite the site row reads length 0 (mjTRN_SITE); with
    one it reads the gear-weighted pose offset in the refsite frame."""
    _, _, _, _, out = _scene("site_refsite")
    length = out.actuator_length.numpy()
    assert (length[:, 0] == 0).all()
    assert (np.abs(length[:, 1]) > 1e-3).all()


@pytest.mark.parametrize("name", list(SCENES))
def test_rollout_matches_jax(name):
    mj, mt, dj, _, _ = _scene(name)
    n = 100
    ref = jax.jit(jmesh.rollout, static_argnums=2)(mj, dj, n)
    out = rollout(mt, from_jax_data(dj), n)
    for f in ("qpos", "act"):
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=1e-8, err_msg=f)
