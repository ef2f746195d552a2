"""Port parity of the inertia-box fluid drag (ops/passive.fluid, wired
through engine.fwd_velocity) and of the implicit integrator with fluid
drag and tendon damping (engine._implicit) with the JAX package (CPU,
f64), on tests/test_fluid.py's scenes: a tumbling box on a free joint and
a capsule on a hinge in air with viscosity, density and wind, and the
same with the implicit integrator plus a second hinge coupled by a damped
fixed tendon.

Tolerances: qfrc_passive 1e-10 at seeded states; 100-step rollouts 1e-8 on
qpos.
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
from mujoco_sim_tpu_torch.models.convert import from_jax_data, from_jax_model
from mujoco_sim_tpu_torch.ops import passive
from mujoco_sim_tpu_torch.parallel.rollout import rollout
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

NENV = 5

XML = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002" density="1.2" viscosity="0.9"
          wind="0.4 -0.3 0.2"/>
  <worldbody>
    <body pos="0 0 2">
      <freejoint/>
      <geom type="box" size="0.1 0.15 0.2" mass="2" euler="0.3 0.2 0.1"/>
    </body>
    <body pos="1 0 1">
      <joint name="h" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.4 0 0" mass="0.8"/>
    </body>
  </worldbody>
</mujoco>
"""

IMPLICIT = XML.replace(
    '<option timestep="0.002"',
    '<option integrator="implicit" timestep="0.002"').replace(
    "</worldbody>", """
    <body pos="-1 0 1">
      <joint name="h2" type="hinge" axis="0 1 0"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0" mass="0.5"/>
    </body>
  </worldbody>""").replace("</mujoco>", """
  <tendon><fixed name="tt" damping="0.8" stiffness="3">
    <joint joint="h" coef="1.0"/><joint joint="h2" coef="-0.6"/>
  </fixed></tendon>
</mujoco>""")
SCENES = {"euler": XML, "implicit_tendon_damping": IMPLICIT}


def _batch(name):
    mj = jengine.set_const(jax_compile(jax_parse(SCENES[name])))
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    rng = np.random.default_rng(7)
    dj = jmesh.make_batch(mj, NENV, dtype=jnp.float64)
    qpos = np.array(dj.qpos)
    q = rng.standard_normal((NENV, 4))
    qpos[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qpos[:, 7:] = rng.uniform(-1, 1, (NENV, mj.nq - 7))
    return mj, mt, dj.replace(
        qpos=jnp.asarray(qpos),
        qvel=jnp.asarray(rng.uniform(-1.5, 1.5, (NENV, mj.nv))))


@pytest.mark.parametrize("name", list(SCENES))
def test_fluid_forces_match_jax(name):
    mj, mt, dj = _batch(name)
    assert mj.opt.has_fluid
    ref = jax.jit(jax.vmap(jengine.forward, in_axes=(None, 0)))(mj, dj)
    out = engine.forward(mt, from_jax_data(dj))
    for f in ("qfrc_passive", "qfrc_damper", "qfrc_spring"):
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-10,
                                   atol=1e-10, err_msg=f)
    np.testing.assert_allclose(out.qacc.numpy(), np.asarray(ref.qacc),
                               rtol=1e-9, atol=1e-9)
    # the drag is a real part of the passive force here
    drag = out.qfrc_passive - out.qfrc_spring - out.qfrc_damper
    assert float(drag.abs().max()) > 0.1


@pytest.mark.parametrize("name", list(SCENES))
def test_rollout_matches_jax(name):
    """100 steps: Euler with drag and wind; implicit with the drag's and
    the tendon damping's velocity derivatives in the implicit matrix."""
    mj, mt, dj = _batch(name)
    n = 100
    ref = jax.jit(jmesh.rollout, static_argnums=2)(mj, dj, n)
    out = rollout(mt, from_jax_data(dj), n)
    np.testing.assert_allclose(out.qpos.numpy(), np.asarray(ref.qpos),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(out.qvel.numpy(), np.asarray(ref.qvel),
                               rtol=0, atol=1e-8)


def test_drag_derivative_at_rest_is_finite():
    """|v| v at v = 0: abs has a zero derivative there (as in JAX), so
    the implicit matrix's jvp columns stay finite at rest."""
    mj, mt, dj = _batch("implicit_tendon_damping")
    d = engine.fwd_velocity(mt, engine.fwd_position(
        mt, from_jax_data(dj).replace(qvel=torch.zeros(NENV, mj.nv,
                                                       dtype=torch.float64))))
    com = engine._com_dict(mt, d)
    com_full = dict(com, cinert=engine._cinert(mt, d))

    def drag(v):
        vel = engine.smooth.com_vel(mt, com_full, v)
        return passive.fluid(mt, com, d.xipos, vel["cvel"], d.ximat,
                             d.body_mass, d.body_inertia)

    t = torch.zeros_like(d.qvel)
    t[:, 0] = 1.0
    _, col = torch.func.jvp(drag, (d.qvel,), (t,))
    assert torch.isfinite(col).all()
