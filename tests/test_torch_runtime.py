"""Parity of the port's runtime (runtime/{sim,health,checkpoint,loop,
profiler}.py) and of its copies of models/{scene,urdf,export_mjcf}.py with
the JAX package, in f64 on the CPU.

Both packages compose the in-repo world (tests/fixtures/world_empty.xml, a
floor plane and RK4) with two spawnable balls (three after a hot swap) and
run the same sequence of service calls.  The integrator is switched to Euler in both, as the
bench's spawn cell does, which keeps the JAX step cheap to compile; the
world's RK4 itself is held to the JAX package by test_torch_integrators.py.
Bookkeeping and request-set state must be exactly equal; stepped state
within 1e-9 absolute and relative, as tests/test_torch_step.py holds one
step, and the contact solve's outputs as ROADMAP §C holds converged
solves.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_sim_tpu import engine as jeng
from mujoco_sim_tpu.models import scene as jscene
from mujoco_sim_tpu.models.compile import compile_spec as jcompile
from mujoco_sim_tpu.models.urdf import compile_urdf as jcompile_urdf
from mujoco_sim_tpu.runtime import checkpoint as jck
from mujoco_sim_tpu.runtime import health as jhealth
from mujoco_sim_tpu.runtime import loop as jloop
from mujoco_sim_tpu.runtime.sim import Simulation as JSim

from mujoco_sim_tpu_torch import engine as teng
from mujoco_sim_tpu_torch.models import convert
from mujoco_sim_tpu_torch.models import scene as tscene
from mujoco_sim_tpu_torch.models.compile import compile_spec as tcompile
from mujoco_sim_tpu_torch.models.model import (Contact as TContact,
                                                Data as TData, Integrator)
from mujoco_sim_tpu_torch.models.urdf import compile_urdf as tcompile_urdf
from mujoco_sim_tpu_torch.runtime import checkpoint as tck
from mujoco_sim_tpu_torch.runtime import health as thealth
from mujoco_sim_tpu_torch.runtime import loop as tloop
from mujoco_sim_tpu_torch.runtime import profiler as tprof
from mujoco_sim_tpu_torch.runtime.sim import Simulation as TSim
from mujoco_sim_tpu_torch.utils.struct import leaf_names

from tests.test_torch_compile import _assert_same_container
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
WORLD = os.path.join(FIX, "world_empty.xml")
BALL = os.path.join(FIX, "spawn_ball.xml")
SLOTS = {"sball": ["sball", "1_sball", "2_sball"]}
SLOTS2 = {"sball": ["sball", "1_sball"]}
STEP_TOL = 1e-9


def ball_models(instances=3, packages=((jscene, jcompile, jeng),
                                        (tscene, tcompile, teng))):
    """(JAX model, port host model) of the world with `instances` balls,
    Euler."""
    out = []
    for sc, compile_spec, eng in packages:
        spec = sc.compose(WORLD, robots={"sball": sc.RobotConfig(path=BALL)},
                          instances=instances)
        m = eng.set_const(compile_spec(spec))
        out.append(m.replace(opt=m.opt.replace(
            integrator=int(Integrator.EULER))))
    return out


def _np(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def leaves(d):
    """{name: numpy} of every leaf of a Data of either package, the nested
    Contact's as "contact.<name>"."""
    out = {}
    for n in leaf_names(TData):
        if n == "contact":
            out.update({f"contact.{c}": _np(getattr(d.contact, c))
                        for c in leaf_names(TContact)})
        else:
            out[n] = _np(getattr(d, n))
    return out


def port_ball_model(instances=3):
    return ball_models(instances, ((tscene, tcompile, teng),))[0]


def port_env0(d):
    return {k: v[0] for k, v in leaves(d).items()}


# request-set state: equal bit for bit
EXACT = ("body_active", "geom_size", "geom_rbound", "geom_rgba",
         "body_mass", "body_inertia")


def assert_books(js, ts):
    """Slot bookkeeping: public names, claimed slots, allocator state."""
    assert sorted(js.by_public_name) == sorted(ts.by_public_name)
    assert js.names.known == ts.names.known
    assert js.names.unique_index == ts.names.unique_index
    for cls in js.slots:
        for a, b in zip(js.slots[cls], ts.slots[cls]):
            assert (a.root_body, a.in_use, a.public_name, a.free_jnt,
                    a.qpos_adr, a.dof_adr) == (
                b.root_body, b.in_use, b.public_name, b.free_jnt,
                b.qpos_adr, b.dof_adr)
            np.testing.assert_array_equal(a.bodies, b.bodies)
            np.testing.assert_array_equal(a.geoms, b.geoms)


def _consts(sim):
    return dict(sim.m.layout._consts)


@pytest.fixture(scope="module")
def seq():
    """One sequence of service calls through both packages; each stage's
    state is recorded for the tests below."""
    jm, tm = ball_models(instances=2)
    js = JSim(jm, spawnable=SLOTS2)
    ts = TSim(tm, spawnable=SLOTS2, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(8)
    rec = {}

    def both(fn):
        return fn(js), fn(ts)

    rec["init"] = (leaves(js.d), port_env0(ts.d))
    qa = np.array([0.3, -0.2, 0.115, 1, 0, 0, 0])
    va = np.r_[rng.uniform(-0.5, 0.5, 3), rng.uniform(-2, 2, 3)]
    rgba = rng.uniform(0, 1, 4)
    names = both(lambda s: s.spawn(
        "sball", "ballA", pose=qa, velocity=va, size=np.array([0.12]),
        rgba=rgba, inertial={"m": 2.0, "ixx": 0.02,
                                             "iyy": 0.03, "izz": 0.04}))
    qb = np.array([-0.3, 0.2, 0.3, np.cos(0.2), 0, np.sin(0.2), 0])
    names += both(lambda s: s.spawn("sball", "ballB", pose=qb,
                                    inertial={"m": 1.5}))
    # destroyed before any step: its final state is the spawn request
    rec["destroy_fresh"] = both(lambda s: s.destroy(names[2]))
    names += both(lambda s: s.spawn("sball", "ball7", pose=qa + 1.0))
    rec["names"] = names
    rec["spawned"] = dict(jm=js.m, tm=ts.m, jd=js.d, td=ts.d,
                          a=leaves(js.d), b=port_env0(ts.d))
    ts.step(1)
    rec["consts_first"] = (ts.m, _consts(ts))
    js.step(30)
    ts.step(29)
    rec["stepped"] = (leaves(js.d), port_env0(ts.d))
    rec["destroy_stepped"] = both(lambda s: s.destroy(names[4]))
    rec["respawn"] = both(lambda s: s.spawn(
        "sball", "ballA", pose=qb + 0.5, velocity=va))
    js.step(5)
    ts.step(5)
    rec["consts_after"] = (ts.m, _consts(ts))
    rec["restepped"] = (leaves(js.d), port_env0(ts.d))
    both(lambda s: s.reset())
    rec["reset"] = (leaves(js.d), port_env0(ts.d))
    both(lambda s: s.reset_full())
    rec["reset_full"] = (leaves(js.d), port_env0(ts.d))
    rec["destroy_reset"] = both(lambda s: s.destroy(rec["respawn"][0]))
    both(lambda s: s.spawn("sball", "ballE", pose=qa, velocity=va))
    js.step(3)
    ts.step(3)
    rec["pre_swap"] = (leaves(js.d), port_env0(ts.d),
                       dict(ts.by_public_name), ts.m)
    jm3, tm3 = ball_models(instances=3)
    js.hot_swap(jm3, SLOTS)
    ts.hot_swap(tm3, SLOTS)
    rec["swapped"] = (js, ts, leaves(js.d), port_env0(ts.d))
    return rec


# the Newton solve's outputs, and the stiff rows' reference accelerations,
# which multiply the state's last bits by the contact stiffness: converged
# solves of the two packages agree to ~1e-7, not 1e-12 (ROADMAP §C), so
# these are held within SOLVED_TOL of each leaf's largest entry
SOLVED = ("qacc", "qacc_warmstart", "qfrc_constraint", "efc_force",
          "efc_aref")
SOLVED_TOL = 1e-6


def _cmp(pair, tol=STEP_TOL):
    a, b = pair
    for k in a:
        if k in EXACT or a[k].dtype.kind in "bi":
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        elif k in SOLVED and tol:
            np.testing.assert_allclose(
                b[k], a[k], rtol=0,
                atol=SOLVED_TOL * max(1.0, float(np.abs(a[k]).max())),
                err_msg=k)
        else:
            np.testing.assert_allclose(b[k], a[k], rtol=tol, atol=tol,
                                       err_msg=k)


def test_spawn_request_state_is_exact(seq):
    a, b = seq["spawned"]["a"], seq["spawned"]["b"]
    assert seq["names"][0::2] == seq["names"][1::2]
    for k in a:          # nothing has been stepped: every leaf bit-equal
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert a["body_active"].tolist() == [True, True, True]


def test_destroy_states_match(seq):
    ja, ta = seq["destroy_fresh"]
    assert sorted(ja) == sorted(ta)
    for k in ja:         # the unstepped spawn request, bit for bit
        np.testing.assert_array_equal(ta[k], np.asarray(ja[k]))
    ja, ta = seq["destroy_reset"]     # back at the fresh Data: exact
    for k in ja:
        np.testing.assert_array_equal(ta[k], np.asarray(ja[k]))
    ja, ta = seq["destroy_stepped"]
    for k in ja:
        np.testing.assert_allclose(ta[k], np.asarray(ja[k]),
                                   rtol=STEP_TOL, atol=STEP_TOL)


def test_stepped_and_respawned_state_match(seq):
    assert seq["names"] and seq["respawn"][0] == seq["respawn"][1]
    a, b = seq["stepped"]
    # ballA starts in contact (z 0.115 at radius 0.12): the solver ran
    assert np.abs(a["efc_force"]).max() > 0
    _cmp(seq["stepped"])
    _cmp(seq["restepped"])


def test_reset_and_reset_full_match(seq):
    _cmp(seq["reset"])
    a, _ = seq["reset"]
    assert a["time"] == 0
    _cmp(seq["reset_full"], tol=0)


def test_spawn_and_destroy_rebuild_nothing(seq):
    """The port's counterpart of the JAX package's no-retrace test: the
    model is the same object and the layout's plan cache holds the same
    entries (the same tensors) after spawns, destroys and steps."""
    m0, c0 = seq["consts_first"]
    m1, c1 = seq["consts_after"]
    assert m1 is m0
    assert c0 and c1.keys() == c0.keys()
    assert all(c1[k] is c0[k] for k in c0)


def test_hot_swap_transplants_exactly(seq):
    js, ts, a, b = seq["swapped"]
    pa, pb, by_name, old_m = seq["pre_swap"]
    assert ts.m is not old_m and ts.m.nbody == old_m.nbody + 1
    assert_books(js, ts)
    # the port's own state crosses bit for bit, by name
    for name, slot in by_name.items():
        new = ts.by_public_name[name]
        for k, w, adr0, adr1 in (("qpos", 7, slot.qpos_adr, new.qpos_adr),
                                 ("qvel", 6, slot.dof_adr, new.dof_adr),
                                 ("qacc_warmstart", 6, slot.dof_adr,
                                  new.dof_adr)):
            np.testing.assert_array_equal(b[k][adr1:adr1 + w],
                                          pb[k][adr0:adr0 + w])
    assert b["time"] == pb["time"]
    # and the two packages' swapped states agree
    for k in ("qpos", "qvel", "qacc", "qacc_warmstart", "body_active",
              "body_mass", "geom_size", "time"):
        np.testing.assert_allclose(b[k], a[k], rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=k)
    assert not b["body_active"][-1]     # the new slot starts inactive


def test_hot_swap_refuses_a_batch():
    tm = port_ball_model()
    ts = TSim(tm, spawnable=SLOTS, dtype=torch.float64, device="cpu")
    ts.d = teng.make_data(ts.m, 2)
    with pytest.raises(ValueError, match="one-env"):
        ts.hot_swap(tm, SLOTS)


def test_simulation_defaults_to_the_card():
    """A host model goes to the card unless the caller names another
    device; without one that raises instead of stepping on the CPU."""
    tm = port_ball_model()
    if torch.cuda.is_available():
        assert TSim(tm).m.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        TSim(tm, spawnable=SLOTS)


def _batch(seq, B=6, poison=(1, 4)):
    jd = seq["spawned"]["jd"]
    dB = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), jd)
    rng = np.random.default_rng(5)
    qvel = np.asarray(dB.qvel) + rng.normal(0, 0.1, dB.qvel.shape)
    qvel[poison[0], 2] = np.nan
    qvel[poison[1], 0] = 1e7
    return dB.replace(qvel=jnp.asarray(qvel))


def test_auto_reset_matches_jax(seq):
    jm, tm = seq["spawned"]["jm"], seq["spawned"]["tm"]
    dB = _batch(seq)
    j2, jmask = jhealth.auto_reset(jm, dB)
    t2, tmask = thealth.auto_reset(tm, convert.from_jax_data(dB))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert tmask.tolist() == [True, False, True, True, False, True]
    a, b = leaves(j2), leaves(t2)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    dT = convert.from_jax_data(dB)
    for k, v in leaves(dT).items():      # healthy envs bit-identical
        np.testing.assert_array_equal(b[k][[0, 2, 3, 5]], v[[0, 2, 3, 5]])
    np.testing.assert_array_equal(
        thealth.contact_saturated(tm, t2).numpy(),
        np.asarray(jhealth.contact_saturated(jm, j2)))
    assert bool(thealth.env_healthy(t2).all())


def test_jax_checkpoint_loads_into_the_port(seq, tmp_path):
    sp = seq["spawned"]
    p = str(tmp_path / "jax.npz")
    jck.save_state(sp["jd"], p, extra={"t": 1})
    d, meta = tck.load_state(sp["tm"], p)
    assert meta == {"t": 1} and d.qpos.shape[0] == 1
    a, b = leaves(sp["jd"]), port_env0(d)
    for k in a:
        assert b[k].dtype == a[k].dtype, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    # and a port checkpoint has the JAX package's keys
    q = str(tmp_path / "port.npz")
    tck.save_state(sp["td"], q)
    with np.load(p) as zj, np.load(q) as zt:
        assert zj.files == zt.files


def test_port_checkpoint_round_trip_is_exact(seq, tmp_path):
    tm = seq["spawned"]["tm"]
    dB = convert.from_jax_data(_batch(seq))
    p = str(tmp_path / "b.npz")
    tck.save_state(dB, p, extra={"why": "test"})
    d2, meta = tck.load_state(tm, p)
    assert meta == {"why": "test"}
    a, b = leaves(dB), leaves(d2)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


class _FakeClock:
    """perf_counter that moves only when told (plus 1 us a read, so the
    loop's busy-wait ends): a deterministic wall clock for the governor."""

    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        self.t += 1e-6
        return self.t


# host cost of each controlled step (s) against a nominal 2 ms step capped
# at 8 ms: behind twice (dt doubles to the cap), held, ahead (busy-wait),
# then within 1 ms of the wall clock twice (dt halves back to nominal)
_COSTS = [0.01, 0.01, 0.0, 0.0, 0.0085, 0.004, 0.0, 0.0]


def _governed(mod, m, d, monkeypatch):
    clock = _FakeClock()
    monkeypatch.setattr(mod, "time", clock)
    seen = []

    def controller(m_, d_):
        seen.append(float(np.asarray(m_.opt.timestep)))
        clock.t += _COSTS[len(seen) - 1]
        return d_

    loop = mod.SimLoop(m, d, max_time_step=0.008, real_time=True,
                       controller=controller)
    loop.run(sim_seconds=0.0375)
    return seen, loop


def test_simloop_governor_matches_jax(seq, monkeypatch):
    sp = seq["spawned"]
    jseen, jl = _governed(jloop, sp["jm"], sp["jd"], monkeypatch)
    tseen, tl = _governed(tloop, sp["tm"], sp["td"], monkeypatch)
    assert jseen == [0.002, 0.004, 0.008, 0.008, 0.008, 0.004, 0.002,
                     0.002]
    assert tseen == jseen
    assert tl.current_dt == jl.current_dt == 0.002
    np.testing.assert_allclose(tl.rtf, jl.rtf, rtol=1e-9)
    np.testing.assert_allclose(float(tl.d.time[0]), float(jl.d.time),
                               rtol=0, atol=1e-12)
    # retiming changed a tensor leaf only: the step's plans were reused
    assert tl.m.layout is sp["tm"].layout


def test_simloop_paces_to_the_wall_clock(seq):
    tm = seq["spawned"]["tm"]
    m = tm.replace(opt=tm.opt.replace(
        timestep=torch.tensor(0.05, dtype=torch.float64)))
    loop = tloop.SimLoop(m, seq["spawned"]["td"], real_time=True)
    t0 = time.perf_counter()
    loop.run(sim_seconds=0.25)
    wall = time.perf_counter() - t0
    assert wall >= 0.24, wall
    assert float(loop.d.time[0]) >= 0.25


def test_profiler_on_the_cpu(seq, tmp_path):
    tm, td = seq["spawned"]["tm"], seq["spawned"]["td"]
    prof = tprof.Profiler()
    d = td
    with prof.step_block(n=3, dt=0.002):
        for _ in range(3):
            d = teng.step(tm, d)
    with prof.stage("extra"):
        pass
    rep = prof.report()
    assert rep["steps"] == 3 and rep["steps_per_sec"] > 0
    assert "extra" in rep["stages"]
    t = tprof.stage_timings(tm, td, repeats=1)
    assert set(t) == {"fwd_position", "fwd_velocity", "fwd_acceleration",
                      "solver", "full_step"}
    assert all(np.isfinite(v) and v > 0 for v in t.values())
    with tprof.device_trace(str(tmp_path)) as p:
        teng.fwd_velocity(tm, td)
    assert os.path.getsize(tmp_path / "trace.json") > 0
    assert len(p.key_averages()) > 0


# ------------------------------------------------------------- the copies

def test_compose_compiles_the_same_model():
    """World + a robot with odom joints + three spawn instances + mocap
    reference twins: the port's copy of scene.py composes the spec that
    compiles to the JAX package's Model, field by field."""
    bot = os.path.join(FIX, "benchbot.xml")
    out = []
    for sc, compile_spec, eng in ((jscene, jcompile, jeng),
                                  (tscene, tcompile, teng)):
        spec = sc.compose(WORLD, robots={"benchbot": sc.RobotConfig(
            path=bot, pose_init=np.array([0.1, 0.0, 0.0, 0, 0, 0.3]),
            add_odom_joints={"lin_odom_x_joint": True,
                             "lin_odom_y_joint": True,
                             "ang_odom_z_joint": True},
            disable_gravity=True)}, instances=3)
        spec = sc.add_reference_bodies(spec, ["arm1"])
        out.append(eng.set_const(compile_spec(spec)))
    jm, tm = out
    _assert_same_container(tm, convert.from_jax_model(jm), rtol=1e-12)
    assert tm.nmocap == 1 and "benchbot_lin_odom_x_joint" in tm.names.joint
    assert "2_benchbot" in tm.names.body


def test_urdf_compiles_the_same_model():
    path = os.path.join(FIX, "two_link.urdf")
    _assert_same_container(tcompile_urdf(path),
                           convert.from_jax_model(jcompile_urdf(path)),
                           rtol=1e-12)


def test_export_and_dumps_write_the_same_text(seq, tmp_path):
    """export_mjcf with live poses, print_model_txt and print_data_txt:
    the port hands its copies a host view of env 0 and must write the JAX
    package's text, given the same state."""
    sp = seq["spawned"]
    spec = tscene.compose(WORLD, robots={
        "sball": tscene.RobotConfig(path=BALL)}, instances=2)
    jspec = jscene.compose(WORLD, robots={
        "sball": jscene.RobotConfig(path=BALL)}, instances=2)
    jd = sp["jd"].replace(time=jnp.asarray(0.25))
    td = sp["td"].replace(time=torch.full((1,), 0.25, dtype=torch.float64))
    tfiles = tck.screenshot(spec, sp["tm"], td, str(tmp_path / "t"), "s")
    jfiles = jck.screenshot(jspec, sp["jm"], jd, str(tmp_path / "j"), "s")
    for k in ("xml", "model_txt", "data_txt"):
        with open(tfiles[k]) as a, open(jfiles[k]) as b:
            assert a.read() == b.read(), k
    d2, meta = tck.load_state(sp["tm"], tfiles["state"])
    assert meta == {"time": 0.25}
    assert torch.equal(d2.qpos, td.qpos) and torch.equal(d2.time, td.time)
    from mujoco_sim_tpu_torch.models.compile import load_model
    assert load_model(tfiles["xml"]).nbody == sp["tm"].nbody
