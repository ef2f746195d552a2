"""Port parity of the controller law (control/controllers.py) and the
hardware interface (control/hw_interface.py) with the JAX package (CPU,
f64): the JAX functions vmapped over 8 envs against the port's batched
ones, within 1e-12 (the same arithmetic); the computed-torque tracking
test of tests/test_control.py (setpoint within 5e-3 after 1500 steps); and
the odometry base drive on a world written here with the three odom joints
declared directly, set_odom_vels and a 400-step rollout within 1e-10.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mujoco_sim_tpu import engine as jengine
from mujoco_sim_tpu.control import controllers as JC
from mujoco_sim_tpu.control import hw_interface as JHW
from mujoco_sim_tpu.models.compile import compile_spec as jax_compile
from mujoco_sim_tpu.models.compile import load_model as jax_load_model
from mujoco_sim_tpu.models.mjcf import parse_mjcf_string as jax_parse
from mujoco_sim_tpu.parallel import mesh as jmesh
from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.control import controllers as C
from mujoco_sim_tpu_torch.control import hw_interface as HW
from mujoco_sim_tpu_torch.models.compile import compile_spec
from mujoco_sim_tpu_torch.models.convert import (
    from_jax_data, from_jax_model, from_jax_pd_config, from_jax_pd_state)
from mujoco_sim_tpu_torch.models.mjcf import parse_mjcf_string
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

ARM = str(pathlib.Path(__file__).resolve().parent / "fixtures" / "arm.xml")
NENV = 8
TOL = 1e-12

ODOM_WORLD = """
<mujoco model="odom_world">
  <option timestep="0.005"/>
  <worldbody>
    <geom name="floor" type="plane" size="0 0 .05"/>
    <body name="base" pos="0 0 0.1">
      <joint name="base_lin_odom_x_joint" type="slide" axis="1 0 0"/>
      <joint name="base_lin_odom_y_joint" type="slide" axis="0 1 0"/>
      <joint name="base_ang_odom_z_joint" type="hinge" axis="0 0 1"/>
      <geom type="box" size=".2 .15 .05" mass="10"/>
    </body>
  </worldbody>
</mujoco>
"""


def _arm(nenv=NENV):
    """Both models, the JAX package's forward() of a seeded batch, its
    port, and seeded setpoints."""
    mj = jax_load_model(ARM)
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    rng = np.random.default_rng(2)
    dj = jmesh.make_batch(mj, nenv, dtype=jnp.float64)
    dj = dj.replace(qpos=jnp.asarray(rng.uniform(-0.5, 0.5, (nenv, mj.nq))),
                    qvel=jnp.asarray(rng.uniform(-0.5, 0.5, (nenv, mj.nv))))
    dj = jax.jit(jax.vmap(jengine.forward, in_axes=(None, 0)))(mj, dj)
    des = rng.uniform(-0.8, 0.8, (nenv, mj.nv))
    return mj, mt, dj, from_jax_data(dj), des


def test_pd_accel_and_apply_control_match_jax():
    mj, mt, dj, dt_, des = _arm()
    cfg_j = JC.pd_config_for_joints(mj, ["shoulder", "elbow"], kp=200.0,
                                    kd=30.0, ki=4.0)
    cfg = C.pd_config_for_joints(mt, ["shoulder", "elbow"], kp=200.0,
                                 kd=30.0, ki=4.0)
    ref_cfg = from_jax_pd_config(cfg_j)
    for f in ("kp", "kd", "ki", "ctrl_mask", "dof_qposadr"):
        assert torch.equal(getattr(cfg, f), getattr(ref_cfg, f)), f
    rng = np.random.default_rng(3)
    st_j = jax.vmap(lambda _: JC.make_pd_state(mj, jnp.float64))(
        jnp.arange(NENV))
    st_j = st_j.replace(err_int=jnp.asarray(rng.normal(size=(NENV, mj.nv))),
                        dq=jnp.asarray(np.where(rng.uniform(size=(
                            NENV, mj.nv)) > 0.5, 0.3, 0.0)))
    st = from_jax_pd_state(st_j)
    dt = 0.002
    st2_j = jax.vmap(JC.pd_accel, in_axes=(None, 0, 0, 0, None))(
        cfg_j, st_j, dj, jnp.asarray(des), dt)
    st2 = C.pd_accel(cfg, st, dt_, torch.tensor(des), dt)
    for f in ("ddq", "dq", "err_int"):
        np.testing.assert_allclose(getattr(st2, f).numpy(),
                                   np.asarray(getattr(st2_j, f)), rtol=TOL,
                                   atol=TOL, err_msg=f)
    d3_j, st3_j = jax.vmap(JC.apply_control, in_axes=(None, 0, 0, None))(
        mj, dj, st2_j, cfg_j.ctrl_mask)
    d3, st3 = C.apply_control(mt, dt_, st2, cfg.ctrl_mask)
    for f in ("qfrc_applied", "qvel"):
        np.testing.assert_allclose(getattr(d3, f).numpy(),
                                   np.asarray(getattr(d3_j, f)), rtol=TOL,
                                   atol=TOL, err_msg=f)
    assert not st3.ddq.any() and not st3.dq.any()
    assert float(d3.qfrc_applied.abs().max()) > 1.0


def test_hw_read_write_match_jax():
    mj, mt, dj, dt_, _ = _arm()
    dofs = HW.joint_dofs(mt, ["elbow", "shoulder"])
    np.testing.assert_array_equal(dofs, JHW.joint_dofs(mj, ["elbow",
                                                            "shoulder"]))
    want = jax.vmap(JHW.read, in_axes=(None, 0, None))(mj, dj, dofs)
    got = HW.read(mt, dt_, dofs)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    cmd = np.random.default_rng(4).normal(size=(NENV, len(dofs)))
    st_j = jax.vmap(lambda _: JC.make_pd_state(mj, jnp.float64))(
        jnp.arange(NENV))
    st = C.make_pd_state(mt, NENV)
    for mode in (HW.ControlMode.EFFORT, HW.ControlMode.VELOCITY,
                 HW.ControlMode.POSITION):
        w_j = jax.vmap(JHW.write, in_axes=(0, None, 0, None))(
            st_j, dofs, jnp.asarray(cmd), JHW.ControlMode(int(mode)))
        w = HW.write(st, dofs, torch.tensor(cmd), mode)
        for f in ("ddq", "dq"):
            np.testing.assert_array_equal(getattr(w, f).numpy(),
                                          np.asarray(getattr(w_j, f)))


def test_read_effort_equals_inverse_at_the_solved_state():
    """The effort hw_interface.read reports is inverse dynamics at the
    forward solution (the reference's per-read mj_inverse)."""
    _, mt, _, dt_, _ = _arm()
    dofs = np.arange(mt.nv)
    _, _, eff = HW.read(mt, dt_, dofs)
    inv = engine.inverse(mt, dt_, dt_.qacc)
    np.testing.assert_allclose(eff.numpy(), inv.numpy(), rtol=1e-9,
                               atol=1e-9)


def test_pd_computed_torque_tracks_setpoint():
    """tests/test_control.py's tracking test, batched: 1500 steps of
    step1 -> pd_accel -> apply_control -> step2 reach the setpoint in
    every env, and the first 200 steps match the JAX package's."""
    mj = jax_load_model(ARM)
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    cfg = C.pd_config_for_joints(mt, ["shoulder", "elbow"], kp=200.0,
                                 kd=30.0)
    cfg_j = JC.pd_config_for_joints(mj, ["shoulder", "elbow"], kp=200.0,
                                    kd=30.0)
    n = 4
    des = torch.tensor([[0.7, -0.4], [0.3, 0.2], [-0.5, 0.6], [0.0, -0.8]],
                       dtype=torch.float64)

    def ctrl(m_, d_, st_):
        st2 = C.pd_accel(cfg, st_, d_, des, m_.opt.timestep)
        return C.apply_control(m_, d_, st2, cfg.ctrl_mask)

    def jctrl(m_, d_, st_, des_):
        st2 = JC.pd_accel(cfg_j, st_, d_, des_, m_.opt.timestep)
        return JC.apply_control(m_, d_, st2, cfg_j.ctrl_mask)

    jstep = jax.jit(jax.vmap(lambda m_, d_, st_, des_: jengine.
                             step_with_control(m_, d_, jctrl, st_, des_),
                             in_axes=(None, 0, 0, 0)))
    dj = jmesh.make_batch(mj, n, dtype=jnp.float64)
    st_j = jax.vmap(lambda _: JC.make_pd_state(mj, jnp.float64))(
        jnp.arange(n))
    d, st = from_jax_data(dj), C.make_pd_state(mt, n)
    for i in range(1500):
        d, st = engine.step_with_control(mt, d, ctrl, st)
        if i < 200:
            dj, st_j = jstep(mj, dj, st_j, jnp.asarray(des.numpy()))
        if i == 199:
            np.testing.assert_allclose(d.qpos.numpy(), np.asarray(dj.qpos),
                                       rtol=0, atol=1e-10)
    np.testing.assert_allclose(d.qpos.numpy(), des.numpy(), atol=5e-3)


def test_odom_base_drive_matches_jax():
    """cmd_vel in the base frame -> odom qvel, per env: a 400-step drive
    with a different command in each env, the JAX package's and the
    port's within 1e-10; the env driving forward while yawing curves as
    the reference's kinematic base does (yaw 1.6 rad, radius v / w)."""
    mj = jengine.set_const(jax_compile(jax_parse(ODOM_WORLD)))
    mt = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    ours = engine.set_const(compile_spec(parse_mjcf_string(ODOM_WORLD)))
    assert ours.names.joint_id("base_ang_odom_z_joint") >= 0
    ocfg_j = JC.odom_config(mj, "base")
    ocfg = C.odom_config(mt, "base")
    np.testing.assert_array_equal(ocfg.dof_ids, ocfg_j.dof_ids)
    np.testing.assert_array_equal(ocfg.present, ocfg_j.present)
    n = 4
    cmd = np.array([[0.5, 0.0, 0.0, 0.0, 0.0, 0.8],
                    [0.2, -0.3, 0.0, 0.0, 0.0, -0.5],
                    [0.0, 0.4, 0.1, 0.0, 0.0, 1.3],
                    [-0.3, 0.1, 0.0, 0.2, 0.1, 0.0]])

    def jctrl(m_, d_, c_):
        return JC.set_odom_vels(m_, d_, ocfg_j, c_), None

    jstep = jax.jit(jax.vmap(lambda m_, d_, c_: jengine.step_with_control(
        m_, d_, jctrl, c_)[0], in_axes=(None, 0, 0)))
    dj = jmesh.make_batch(mj, n, dtype=jnp.float64)
    d = from_jax_data(dj)
    cmd_t = torch.tensor(cmd)
    one = C.set_odom_vels(mt, d, ocfg, cmd_t)
    one_j = jax.vmap(JC.set_odom_vels, in_axes=(None, 0, None, 0))(
        mj, dj, ocfg_j, jnp.asarray(cmd))
    np.testing.assert_allclose(one.qvel.numpy(), np.asarray(one_j.qvel),
                               rtol=0, atol=1e-12)
    for _ in range(400):
        d = engine.step_with_control(
            mt, d, lambda m_, d_, c_: (C.set_odom_vels(m_, d_, ocfg, c_),
                                       None), cmd_t)[0]
        dj = jstep(mj, dj, jnp.asarray(cmd))
    np.testing.assert_allclose(d.qpos.numpy(), np.asarray(dj.qpos), rtol=0,
                               atol=1e-10)
    x, y, yaw = d.qpos.numpy()[0]
    assert abs(yaw - 1.6) < 0.05, yaw
    R = 0.5 / 0.8
    np.testing.assert_allclose(x, R * np.sin(1.6), atol=0.03)
    np.testing.assert_allclose(y, R * (1 - np.cos(1.6)), atol=0.03)


def test_port_compiled_odom_world_drives_like_the_converted_one():
    """The port's own compiler gives the odom world the JAX package
    compiles: 50 driven steps agree bit for bit."""
    mj = jengine.set_const(jax_compile(jax_parse(ODOM_WORLD)))
    conv = engine.put_model(from_jax_model(mj), torch.float64, "cpu")
    own = engine.put_model(engine.set_const(compile_spec(
        parse_mjcf_string(ODOM_WORLD))), torch.float64, "cpu")
    cmd = torch.tensor([[0.5, 0.1, 0.0, 0.0, 0.0, 0.8]], dtype=torch.float64)
    outs = []
    for m in (conv, own):
        ocfg = C.odom_config(m, "base")
        d = engine.make_data(m, 1)
        for _ in range(50):
            d = engine.step_with_control(
                m, d, lambda m_, d_, c_: (C.set_odom_vels(m_, d_, ocfg, c_),
                                          None), cmd)[0]
        outs.append(d.qpos)
    assert torch.equal(outs[0], outs[1])
    assert float(outs[0][0, 2]) > 0.15          # yaw 0.8 rad/s x 0.25 s
