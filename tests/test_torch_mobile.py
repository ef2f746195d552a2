"""Port parity of BASELINE config 3, the batched mobile base (bench.py's
bench_mobile), with the JAX package on the CPU in f64.

Both packages compose tests/fixtures/world_empty.xml (the in-repo stand-in
for the reference's empty.xml) with tests/fixtures/benchbot.xml and the
three odom joints bench_mobile adds, into the same Model field by field.
bench_mobile's one_env_step (step1, the PD arm on a1-a3 with kp 80 and kd
8, apply_control, set_odom_vels, step2), vmapped and jitted in the JAX
package, and the port's batched step on its own compiled model agree
within 1e-10 (the odom test's band) over 50 steps at 4 envs, Euler as
bench_mobile sets it.  parallel/mesh.scan_reduced (one StepGraph of the
controlled step) gives the Python loop's result bit for bit, and its odom
twist is the command at the base's yaw.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import mujoco_sim_tpu_torch as mst
from mujoco_sim_tpu import engine as jeng
from mujoco_sim_tpu.control import controllers as JC
from mujoco_sim_tpu.models import scene as jscene
from mujoco_sim_tpu.models.compile import compile_spec as jcompile
from mujoco_sim_tpu.models.model import Integrator as JIntegrator
from mujoco_sim_tpu.parallel import mesh as jmesh
from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.control import controllers as C
from mujoco_sim_tpu_torch.models import convert, scene
from mujoco_sim_tpu_torch.models.compile import compile_spec
from mujoco_sim_tpu_torch.models.model import Integrator
from mujoco_sim_tpu_torch.parallel import mesh as pmesh
from tests.test_torch_compile import _assert_same_container
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIX = pathlib.Path(__file__).resolve().parent / "fixtures"
WORLD = str(FIX / "world_empty.xml")
BOT = str(FIX / "benchbot.xml")
ODOM = ("lin_odom_x_joint", "lin_odom_y_joint", "ang_odom_z_joint")
ARM = ["a1", "a2", "a3"]
CMD = [0.4, 0.0, 0.0, 0.0, 0.0, 0.3]
NENV, NSTEPS = 4, 50
TOL = 1e-10
# the odom twist against the command at the base's yaw: the arm's
# reaction moves it (chip_smoke.py's ODOM_TOL)
ODOM_TOL = 1e-4


def _compose(sc, compile_spec_, eng, integrator):
    """bench.py's _mobile_model on world_empty.xml, integrator Euler."""
    spec = sc.compose(WORLD, robots={"benchbot": sc.RobotConfig(
        path=BOT, add_odom_joints=dict.fromkeys(ODOM, True))})
    m = eng.set_const(compile_spec_(spec))
    return m.replace(opt=m.opt.replace(integrator=int(integrator.EULER)))


def _port_model():
    return engine.put_model(_compose(scene, compile_spec, engine, Integrator),
                            torch.float64, "cpu")


def _port_step(m, nenv):
    """The port's config-3 step on a batch: a function of the (Data,
    PDState) carry."""
    ocfg = C.odom_config(m, "benchbot")
    pdc = C.pd_config_for_joints(m, ARM, kp=80.0, kd=8.0)
    qdes = torch.zeros((nenv, m.nv), dtype=m.dtype)
    cmd = torch.tensor(CMD, dtype=m.dtype)

    def step(carry):
        d, st = carry
        d = engine.step1(m, d)
        st = C.pd_accel(pdc, st, d, qdes, m.opt.timestep)
        d, st = C.apply_control(m, d, st, pdc.ctrl_mask)
        d = C.set_odom_vels(m, d, ocfg, cmd)
        return engine.step2(m, d), st

    return step, ocfg


def _start(m, nenv):
    return mst.make_data(m, nenv), C.make_pd_state(m, nenv)


def test_composed_mobile_model_matches_jax():
    jm = _compose(jscene, jcompile, jeng, JIntegrator)
    tm = _compose(scene, compile_spec, engine, Integrator)
    _assert_same_container(tm, convert.from_jax_model(jm), rtol=1e-12)
    for j in ODOM:
        assert tm.names.joint_id(f"benchbot_{j}") >= 0, j
    ocfg, ocfg_j = C.odom_config(_port_model(), "benchbot"), \
        JC.odom_config(jm, "benchbot")
    np.testing.assert_array_equal(ocfg.dof_ids, ocfg_j.dof_ids)
    np.testing.assert_array_equal(ocfg.present, ocfg_j.present)


def test_mobile_step_matches_jax_bench_step():
    """bench_mobile's one_env_step (bench.py:198-205), vmapped, against the
    port's batched step, 50 steps from the same start."""
    jm = _compose(jscene, jcompile, jeng, JIntegrator)
    ocfg_j = JC.odom_config(jm, "benchbot")
    pdc_j = JC.pd_config_for_joints(jm, ARM, kp=80.0, kd=8.0)
    qdes_j = jnp.zeros(jm.nv)
    cmd_j = jnp.asarray(CMD)

    def one_env_step(m_, carry):
        d_, st_ = carry
        d_ = jeng.step1(m_, d_)
        st2 = JC.pd_accel(pdc_j, st_, d_, qdes_j, m_.opt.timestep)
        d_, st3 = JC.apply_control(m_, d_, st2, pdc_j.ctrl_mask)
        d_ = JC.set_odom_vels(m_, d_, ocfg_j, cmd_j)
        d_ = jeng.step2(m_, d_)
        return d_, st3

    jstep = jax.jit(jax.vmap(lambda m_, d_, st_: one_env_step(m_, (d_, st_)),
                             in_axes=(None, 0, 0)))
    dj = jmesh.make_batch(jm, NENV, dtype=jnp.float64)
    stj = jax.vmap(lambda _: JC.make_pd_state(jm, jnp.float64))(
        jnp.arange(NENV))
    for _ in range(NSTEPS):
        dj, stj = jstep(jm, dj, stj)

    m = _port_model()
    step, _ = _port_step(m, NENV)
    c = _start(m, NENV)
    for _ in range(NSTEPS):
        c = step(c)
    for name, ours, ref in (("qpos", c[0].qpos, dj.qpos),
                            ("qvel", c[0].qvel, dj.qvel),
                            ("err_int", c[1].err_int, stj.err_int)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=TOL, err_msg=name)
    assert float(c[0].qpos[0, 2]) > 0.02          # yaw 0.3 rad/s x 0.1 s


def test_mobile_scan_reduced_equals_the_loop():
    """The user's path, scan_reduced over the (Data, PDState) carry, and
    the same step as a Python loop: bit for bit; the base drives at the
    command."""
    m = _port_model()
    step, ocfg = _port_step(m, NENV)
    c0 = _start(m, NENV)
    ce = c0
    for _ in range(NSTEPS):
        ce = step(ce)
    cg = pmesh.scan_reduced(step, c0, NSTEPS)
    for k in ("qpos", "qvel", "act", "qacc_warmstart"):
        assert torch.equal(getattr(cg[0], k), getattr(ce[0], k)), k
    for k in ("ddq", "dq", "err_int"):
        assert torch.equal(getattr(cg[1], k), getattr(ce[1], k)), k
    q, v = cg[0].qpos, cg[0].qvel
    (x, y, yaw), (vx, vy, w) = ((int(ids[i]) for i in (0, 1, 5))
                                for ids in (ocfg.qpos_ids, ocfg.dof_ids))
    yaw0 = q[:, yaw] - float(m.opt.timestep) * v[:, w]
    dev = torch.stack([v[:, vx] - CMD[0] * torch.cos(yaw0),
                       v[:, vy] - CMD[0] * torch.sin(yaw0),
                       v[:, w] - CMD[5]]).abs().max()
    assert float(dev) <= ODOM_TOL, float(dev)
    assert bool((q[:, x] > 0).all() and (q[:, yaw] > 0).all())
