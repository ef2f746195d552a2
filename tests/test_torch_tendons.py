"""Port parity of the tendon stage (ops/tendon.py, the tendon part of
engine.set_const and fwd_position, tendon springs and dampers in
ops/passive.py, tendon limit and tendon equality rows in
ops/constraint.py) with the JAX package (CPU, f64).

Scenes: the inline scenes of tests/test_tendons.py -- fixed tendons (a
spring, a deadband spring, a limit) with a tendon actuator, a straight
spatial site chain with a limit, a tilted cylinder wrap, a sphere wrap
with a sidesite, a wrap-inside sidesite, a pulley, a tendon equality --
and tests/fixtures/tendon_terrain.xml (six spatial tendons over sphere and
cylinder wraps with sidesites and a pulley, a fixed tendon with a deadband
spring and a limit, a tendon equality) at 8 envs.  States are seeded
perturbations of qpos0 on the hinge and slide joints.

Tolerances: lengths, moment rows, set_const's constants, efc rows and
passive forces 1e-10 (the same formulas; the legs are summed into their
tendons in another order).  One exception: the wrap-inside touch point comes
from 48 ternary-search passes whose last ~20 compare path lengths that
differ by less than an ulp, so two implementations of the same search
(XLA's and torch's sin/cos/atan2 round differently) stop at touch points
up to ~(2/3)^48 = 4e-9 of the bracket apart.  The length is flat there
and agrees to 1e-10; the moment row, and the passive force through it,
are held to 1e-8 in that scene (measured: 1.4e-9).
"""

import pathlib

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
from mujoco_sim_tpu_torch.ops import tendon
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" \
    / "tendon_terrain.xml"
TOL = 1e-10
# the wrap-inside search's resolution (module docstring)
J_TOL = {"wrap_inside": 1e-8}

ARM = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002"/>
  <worldbody>
    <body pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0" mass="1"/>
      <body pos="0.3 0 0">
        <joint name="j2" type="hinge" axis="0 1 0" damping="0.05"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0.25 0 0" mass="0.4"/>
        <body pos="0.25 0 0">
          <joint name="j3" type="slide" axis="1 0 0" damping="0.2"/>
          <geom type="sphere" size="0.03" mass="0.2"/>
        </body>
      </body>
    </body>
  </worldbody>
  <tendon>
    <fixed name="t1" stiffness="25" damping="1.5" springlength="0.05">
      <joint joint="j1" coef="1.0"/>
      <joint joint="j2" coef="-0.7"/>
    </fixed>
    <fixed name="t2" limited="true" range="-0.15 0.2" solreflimit="0.01 1">
      <joint joint="j2" coef="0.5"/>
      <joint joint="j3" coef="2.0"/>
    </fixed>
    <fixed name="db" stiffness="40" springlength="0.1 0.3">
      <joint joint="j1" coef="1"/>
    </fixed>
  </tendon>
  <actuator>
    <general name="at" tendon="t1" gear="1.7" gainprm="3.0"/>
  </actuator>
</mujoco>
"""

SPATIAL = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002"/>
  <worldbody>
    <site name="anchor" pos="0 0 1.5"/>
    <body pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom type="capsule" size="0.02" fromto="0 0 0 0.3 0 0" mass="1"/>
      <site name="mid" pos="0.15 0 0.03"/>
      <body pos="0.3 0 0">
        <joint name="j2" type="hinge" axis="1 0 0" damping="0.05"/>
        <geom type="capsule" size="0.015" fromto="0 0 0 0 0.2 0"
              mass="0.3"/>
        <site name="tip" pos="0 0.2 0"/>
      </body>
    </body>
  </worldbody>
  <tendon>
    <spatial name="cable" stiffness="60" damping="2" springlength="0.4"
             limited="true" range="0 0.9">
      <site site="anchor"/><site site="mid"/><site site="tip"/>
    </spatial>
  </tendon>
  <actuator><general name="wind" tendon="cable" gainprm="5"/></actuator>
</mujoco>
"""

WRAP_CYL = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002"/>
  <worldbody>
    <site name="a" pos="-0.5 0.25 0.1"/>
    <geom name="cyl" type="cylinder" size="0.1 0.8" euler="0.2 -0.15 0"/>
    <site name="side_lo" pos="0.3 0 -0.3"/>
    <body pos="0.5 -0.25 0.4">
      <joint name="jx" type="slide" axis="1 0 0" damping="0.4"/>
      <joint name="jz" type="slide" axis="0 0 1" damping="0.4"/>
      <geom type="sphere" size="0.03" mass="1"/>
      <site name="b"/>
    </body>
  </worldbody>
  <tendon>
    <spatial name="cable" stiffness="25" damping="1.5" springlength="0.9">
      <site site="a"/><geom geom="cyl"/><site site="b"/>
    </spatial>
  </tendon>
</mujoco>
"""

WRAP_SPH = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002"/>
  <worldbody>
    <site name="a" pos="-0.5 0.1 0.3"/>
    <geom name="ball" type="sphere" size="0.12" pos="0 0 0.05"/>
    <site name="below" pos="0 0 -0.4"/>
    <body pos="0.5 -0.1 0.3">
      <joint name="jz" type="slide" axis="0 0 1" damping="0.3"/>
      <geom type="sphere" size="0.03" mass="0.5"/>
      <site name="b"/>
    </body>
  </worldbody>
  <tendon>
    <spatial name="cable" stiffness="40" damping="2" springlength="0.7">
      <site site="a"/><geom geom="ball" sidesite="below"/><site site="b"/>
    </spatial>
  </tendon>
  <actuator><general name="pull" tendon="cable" gainprm="8"/></actuator>
</mujoco>
"""

WRAP_INSIDE = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002"/>
  <worldbody>
    <site name="a" pos="-0.5 0 0.3"/>
    <geom name="cyl" type="cylinder" size="0.1 0.5" euler="1.5707963 0 0"/>
    <site name="inside" pos="0.02 0 0.03"/>
    <body pos="0.5 0 0.2">
      <joint name="jz" type="slide" axis="0 0 1" damping="0.2"/>
      <geom type="sphere" size="0.03" mass="0.5"/>
      <site name="b"/>
    </body>
  </worldbody>
  <tendon>
    <spatial name="cable" stiffness="30" damping="1" springlength="0.8">
      <site site="a"/><geom geom="cyl" sidesite="inside"/>
      <site site="b"/>
    </spatial>
  </tendon>
</mujoco>
"""

PULLEY = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002"/>
  <worldbody>
    <site name="a" pos="0 0 1"/>
    <body pos="0 0 0.5">
      <joint name="j1" type="slide" axis="0 0 1" damping="0.1"/>
      <geom type="sphere" size="0.03" mass="1"/>
      <site name="b"/>
    </body>
    <site name="c" pos="0.3 0 1"/>
    <body pos="0.3 0 0.4">
      <joint name="j2" type="slide" axis="0 0 1" damping="0.1"/>
      <geom type="sphere" size="0.03" mass="0.7"/>
      <site name="e"/>
    </body>
  </worldbody>
  <tendon>
    <spatial name="t" stiffness="50" springlength="0.7"
             limited="true" range="0 0.85">
      <site site="a"/><site site="b"/>
      <pulley divisor="2"/>
      <site site="c"/><site site="e"/>
    </spatial>
  </tendon>
  <actuator><general name="winch" tendon="t" gainprm="10"/></actuator>
</mujoco>
"""

TEN_EQ = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002"/>
  <worldbody>
    <body pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom type="capsule" size="0.03" fromto="0 0 0 0.3 0 0" mass="1"/>
      <body pos="0.3 0 0">
        <joint name="j2" type="hinge" axis="0 1 0" damping="0.05"/>
        <geom type="capsule" size="0.02" fromto="0 0 0 0.25 0 0"
              mass="0.4"/>
        <body pos="0.25 0 0">
          <joint name="j3" type="slide" axis="1 0 0" damping="0.2"/>
          <geom type="sphere" size="0.03" mass="0.2"/>
        </body>
      </body>
    </body>
  </worldbody>
  <tendon>
    <fixed name="ta"><joint joint="j1" coef="0.5"/>
      <joint joint="j2" coef="-0.3"/></fixed>
    <fixed name="tb"><joint joint="j2" coef="1.1"/>
      <joint joint="j3" coef="0.8"/></fixed>
  </tendon>
  <equality>
    <tendon tendon1="ta" tendon2="tb" polycoef="0.02 0.7 0.3 0 0"/>
  </equality>
</mujoco>
"""

SCENES = {"fixed": ARM, "spatial": SPATIAL, "wrap_cylinder": WRAP_CYL,
          "wrap_sphere_sidesite": WRAP_SPH, "wrap_inside": WRAP_INSIDE,
          "pulley": PULLEY, "tendon_equality": TEN_EQ,
          "tendon_terrain": None}
_CACHE = {}


def _xml(name):
    return FIXTURE.read_text() if SCENES[name] is None else SCENES[name]


def _seeded(name):
    """Both models and a seeded batch of the scene (8 envs for the
    fixture, 4 for the inline scenes)."""
    mj = jengine.set_const(jax_compile(jax_parse(_xml(name))))
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    nenv = 8 if SCENES[name] is None else 4
    rng = np.random.default_rng(5)
    dj = jmesh.make_batch(mj, nenv, dtype=jnp.float64)
    lay = mj.layout
    scal = [int(a) for a, t in zip(lay.jnt_qposadr, lay.jnt_type)
            if int(t) in (2, 3)]
    dofs = [int(a) for a, t in zip(lay.jnt_dofadr, lay.jnt_type)
            if int(t) in (2, 3)]
    qpos = np.array(dj.qpos)
    qpos[:, scal] += rng.uniform(-0.3, 0.3, (nenv, len(scal)))
    qvel = np.zeros((nenv, mj.nv))
    qvel[:, dofs] = rng.uniform(-0.8, 0.8, (nenv, len(dofs)))
    dj = dj.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                    ctrl=jnp.asarray(rng.uniform(0.0, 1.0, (nenv, mj.nu))))
    return mj, mt, dj


def _scene(name):
    """Per scene, once: _seeded and both packages' forward() of it."""
    if name in _CACHE:
        return _CACHE[name]
    mj, mt, dj = _seeded(name)
    ref = jax.jit(jax.vmap(jengine.forward, in_axes=(None, 0)))(mj, dj)
    out = engine.forward(mt, from_jax_data(dj))
    _CACHE[name] = (mj, mt, dj, ref, out)
    return _CACHE[name]


def _close(out, ref, names, tol=TOL):
    for name in names:
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("name", list(SCENES))
def test_tendon_length_and_moment_match_jax(name):
    mj, _, _, ref, out = _scene(name)
    assert out.ten_length.shape == (out.qpos.shape[0], mj.ntendon)
    _close(out, ref, ("ten_length",))
    _close(out, ref, ("ten_J", "ten_velocity"), J_TOL.get(name, TOL))


@pytest.mark.parametrize("name", list(SCENES))
def test_set_const_tendon_constants_match_jax(name):
    """The port's own compiler and set_const against the JAX package's."""
    ref = _scene(name)[0]
    ours = engine.set_const(compile_spec(parse_mjcf_string(_xml(name))))
    for f in ("ten_length0", "ten_invweight0", "ten_springlength",
              "actuator_acc0"):
        a, b = np.asarray(getattr(ours, f)), np.asarray(getattr(ref, f))
        assert a.shape == b.shape, f
        assert np.isfinite(a).all(), f
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=f)


@pytest.mark.parametrize("name", list(SCENES))
def test_tendon_efc_rows_match_jax(name):
    """Every efc row, in the same order: J, the regularisation R (from the
    rows' diagApprox), D, aref (from pos and margin), active, type."""
    mj, _, _, ref, out = _scene(name)
    _close(out, ref, ("efc_J", "efc_R", "efc_D", "efc_aref"))
    for f in ("efc_active", "efc_type"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)


@pytest.mark.parametrize("name", list(SCENES))
def test_tendon_passive_forces_match_jax(name):
    _, _, _, ref, out = _scene(name)
    _close(out, ref, ("qfrc_spring", "qfrc_damper", "qfrc_passive"),
           J_TOL.get(name, TOL))


def test_scenes_exercise_their_branches():
    """The seeded states reach what each scene is for: active tendon rows
    (limit or equality), and a sidesite wrap that engages."""
    for name in ("fixed", "pulley", "tendon_equality", "tendon_terrain"):
        mj, _, _, ref, _ = _scene(name)
        act = np.asarray(ref.efc_active)
        tlim = np.asarray(mj.layout.tlim_efcadr)
        eq = np.asarray(mj.layout.eq_efcadr)
        rows = np.concatenate([tlim, eq]).astype(int)
        assert act[:, rows].any(), name
    mj, mt, dj, _, out = _scene("wrap_sphere_sidesite")
    straight = torch.linalg.vector_norm(
        out.site_xpos[:, 1] - out.site_xpos[:, 0], dim=-1)
    assert (out.ten_length[:, 0] > straight + 1e-6).any()


def test_wrap_inside_search_is_a_fixed_loop():
    """The wrap-inside bisection runs its fixed count of passes on every
    leg, whatever the data: no early exit for CUDA-graph capture."""
    A = torch.tensor([[[-0.5, 0.3]]], dtype=torch.float64)
    B = torch.tensor([[[0.5, 0.2]]], dtype=torch.float64)
    c = torch.tensor([[[0.0, 0.25]]], dtype=torch.float64)
    r = torch.tensor([[0.1]], dtype=torch.float64)
    P = tendon._wrap_inside_touch(A, B, c, r)
    assert torch.allclose(torch.linalg.vector_norm(P, dim=-1), r)
    P1 = tendon._wrap_inside_touch(A, B, c, r, iters=1)
    assert not torch.allclose(P, P1)
