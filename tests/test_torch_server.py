"""Parity of the port's TCP server (io/server.py), client, config layer and
CLI with the JAX package, on the CPU.

A JAX and a port server are built on the same scene of the in-repo world
(tests/fixtures/world_empty.xml), with the sim thread off so that answers
are deterministic; both are driven over TCP by the port's client and must
answer alike.  Where an answer reads stepped state, the port's state is
stepped and copied into the JAX server's Data, so the answers are compared
bit for bit.  Every server listens on a port the OS picks, every socket has
a short timeout, every wait a deadline, and every server is stopped by its
fixture.
"""

import contextlib
import io
import os
import socket
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_sim_tpu import __main__ as jcli
from mujoco_sim_tpu.models import scene as jscene
from mujoco_sim_tpu.models.compile import load_model as jload
from mujoco_sim_tpu.io.server import SimServer as JServer
from mujoco_sim_tpu.runtime import config as jconfig
from mujoco_sim_tpu.runtime.sim import Simulation as JSim

from mujoco_sim_tpu_torch import __main__ as tcli
from mujoco_sim_tpu_torch import engine as teng
from mujoco_sim_tpu_torch.io.client import SimClient
from mujoco_sim_tpu_torch.io.server import SimServer as TServer
from mujoco_sim_tpu_torch.models import convert
from mujoco_sim_tpu_torch.models import scene as tscene
from mujoco_sim_tpu_torch.models.compile import compile_spec as tcompile
from mujoco_sim_tpu_torch.models.compile import load_model
from mujoco_sim_tpu_torch.models.model import Contact as TContact
from mujoco_sim_tpu_torch.models.model import Data as TData
from mujoco_sim_tpu_torch.runtime import checkpoint as tck
from mujoco_sim_tpu_torch.runtime import config as tconfig
from mujoco_sim_tpu_torch.runtime.sim import Simulation as TSim
from mujoco_sim_tpu_torch.utils.struct import leaf_names

from tests.test_torch_compile import _assert_same_container
from tests.test_torch_runtime import (BALL, FIX, SLOTS, WORLD, ball_models,
                                     port_ball_model)
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

TIMEOUT = 20.0      # every client socket and every wait loop


def _jax_port(srv):
    """The port the OS gave a JAX server started on port 0."""
    return srv._server.sockets[0].getsockname()[1]


def _client(port):
    return SimClient(port=port, timeout=TIMEOUT)


def _wait(cond, what):
    deadline = time.monotonic() + TIMEOUT
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _copy_into_jax(jsim, tsim):
    """Every leaf of the port sim's env 0 into the JAX sim's Data."""
    d = tsim.d
    con = jsim.d.contact.replace(**{
        n: jnp.asarray(getattr(d.contact, n)[0].numpy())
        for n in leaf_names(TContact)})
    jsim.d = jsim.d.replace(contact=con, **{
        n: jnp.asarray(getattr(d, n)[0].numpy())
        for n in leaf_names(TData) if n != "contact"})


@contextlib.contextmanager
def _serving(*servers):
    try:
        for s in servers:
            s.start(run_sim=False)
        yield servers
    finally:
        for s in servers:
            s.stop()


@pytest.fixture(scope="module")
def pair():
    """(JAX sim, port sim, JAX port, port port) of the ball scene."""
    jm, tm = ball_models()
    js = JSim(jm, spawnable=SLOTS)
    ts = TSim(tm, spawnable=SLOTS, dtype=torch.float64, device="cpu")
    spec = tscene.compose(WORLD, robots={
        "sball": tscene.RobotConfig(path=BALL)}, instances=3)
    jsrv = JServer(js, port=0, spec=spec)
    tsrv = TServer(ts, port=0, spec=spec)
    with _serving(jsrv, tsrv):
        yield js, ts, _jax_port(jsrv), tsrv.port


def _ask(ports, op, **kw):
    out = []
    for p in ports:
        c = _client(p)
        try:
            out.append(c.call(op, **kw))
        finally:
            c.close()
    return out


def test_requests_answer_alike(pair):
    js, ts, jp, tp = pair
    ring = [{"info": {"name": f"obj_{i}", "type": 1}, "class": "sball",
             "pose": [0.6 * np.cos(a), 0.6 * np.sin(a), 0.3, 1, 0, 0, 0]}
            for i, a in enumerate(np.linspace(0, 2 * np.pi, 3,
                                              endpoint=False))]
    ring[1]["info"].update(size=[0.13, 0, 0], rgba=[0.9, 0.1, 0.2, 1.0],
                           inertial={"m": 2.5, "ixx": 0.03, "iyy": 0.03,
                                     "izz": 0.03})
    a, b = _ask((jp, tp), "spawn_objects", objects=ring)
    assert a == b and len(a["names"]) == 3
    spawned = a["names"]
    a, b = _ask((jp, tp), "spawn_objects", objects=ring[:1])
    assert a == b and "error" in a          # all three slots in use
    a, b = _ask((jp, tp), "no_such_op")
    assert a == b and "error" in a
    ts.step(12)                             # the balls fall
    _copy_into_jax(js, ts)
    for names in (None, spawned[:2] + ["sball", "nobody"]):
        a, b = _ask((jp, tp), "get_state", names=names)
        assert a == b, names
    # a slot's root body answers to its body name too
    assert [o["name"] for o in a["objects"]] == spawned[:2] + ["sball"]
    assert b["time"] == pytest.approx(12 * 0.002)
    a, b = _ask((jp, tp), "destroy_objects", names=["unknown"])
    assert a == b and "error" in a
    a, b = _ask((jp, tp), "destroy_objects", names=spawned[2:])
    assert a == b and len(a["object_states"][0]["pose"]) == 7
    a, b = _ask((jp, tp), "get_state")
    assert a == b and [o["name"] for o in a["objects"]] == [
        "sball", "1_sball"] + spawned[:2]
    # a malformed line gets the same answer
    out = []
    for p in (jp, tp):
        with socket.create_connection(("127.0.0.1", p),
                                      timeout=TIMEOUT) as s:
            s.sendall(b"{not json\n")
            out.append(s.makefile().readline())
    assert out[0] == out[1] and "bad json" in out[0]


def test_sensor_answers_alike():
    xml = os.path.join(FIX, "force_sensor_srv.xml")
    js = JSim(jload(xml))
    ts = TSim(load_model(xml), dtype=torch.float64, device="cpu")
    ts.step(20)
    _copy_into_jax(js, ts)
    jsrv, tsrv = JServer(js, port=0), TServer(ts, port=0)
    with _serving(jsrv, tsrv):
        msgs = []
        for p in (_jax_port(jsrv), tsrv.port):
            c = _client(p)
            msgs.append(next(iter(c.subscribe(["sensors", "joint_states",
                                               "markers", "base_pose"],
                                              rate=30.0))))
            c.close()
    assert msgs[0] == msgs[1]
    named = msgs[1]["sensors"]["sensors"]
    assert set(named) == {"f_blk", "t_blk", "clk"}
    # the weight of the resting block shows on the force sensor
    assert abs(abs(named["f_blk"][2]) - 2 * 9.81) < 0.5, named["f_blk"]


def _bot_cfg():
    return {"world": WORLD, "robot": os.path.join(FIX, "benchbot.xml"),
            "add_odom_joints": {"benchbot": True},
            "joint_inits": {"benchbot": {"a1": 0.3, "a2": -0.2}}}


def test_config_build_matches_jax():
    """build(dict) needs no YAML file; the model it puts on the device is
    the JAX package's, and the robot meta names the same joints."""
    spec, m, sim, meta = tconfig.build(_bot_cfg(), device="cpu",
                                       dtype=torch.float64)
    jspec, jm, jsim, jmeta = jconfig.build(_bot_cfg())
    assert m.device.type == "cpu" and m.dtype == torch.float64
    assert sim.m is m
    _assert_same_container(m, convert.from_jax_model(jm), rtol=1e-12)
    assert meta["benchbot"]["joints"] == jmeta["benchbot"]["joints"]
    np.testing.assert_array_equal(meta["benchbot"]["odom"].dof_ids,
                                  jmeta["benchbot"]["odom"].dof_ids)
    assert sim._joint_inits == jsim._joint_inits == {"a1": 0.3, "a2": -0.2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tconfig.build(_bot_cfg())


def test_screenshot_service(pair, tmp_path):
    js, ts, jp, tp = pair
    c = _client(tp)
    try:
        resp = c.screenshot(out_dir=str(tmp_path), name="snap")
    finally:
        c.close()
    assert resp["success"]
    files = resp["files"]
    assert sorted(files) == ["data_txt", "model_txt", "state", "xml"]
    assert all(os.path.getsize(f) > 0 for f in files.values())
    assert load_model(files["xml"]).nbody == ts.m.nbody
    d, meta = tck.load_state(ts.m, files["state"])
    assert torch.equal(d.qpos, ts.d.qpos)
    assert meta["time"] == float(ts.d.time[0])


def test_per_class_publisher_rates():
    """World bodies at rate 0 are never published; spawned objects stream
    at their own rate (robot.yaml:62-92)."""
    tm = port_ball_model(instances=2)
    sim = TSim(tm, spawnable={"sball": ["sball", "1_sball"]},
               dtype=torch.float64, device="cpu")
    srv = TServer(sim, port=0, pub_config={
        "pub_object_state_array": {"free_bodies_only": False,
                                   "robot_bodies_rate": 0.0,
                                   "world_bodies_rate": 0.0,
                                   "spawned_object_bodies_rate": 60.0}})
    with _serving(srv):
        public = sim.spawn("sball", "streamball",
                           pose=np.array([0, 0, 0.5, 1, 0, 0, 0]))
        c = _client(srv.port)
        got = []
        for msg in c.subscribe(["object_states"], rate=60.0):
            got.append(msg["object_states"]["objects"])
            if len(got) >= 3:
                break
        c.close()
    names = {o["name"] for objs in got for o in objs}
    assert public in names
    for n in names:
        slot = sim.by_public_name.get(n)
        bid = slot.root_body if slot is not None else tm.names.body_id(n)
        assert srv._body_class[bid] == "spawned", (n, bid)


def test_receiver_drives_the_reference_mocap():
    """A peer's object_states set the receiver's '<name>_ref' mocap pose
    (the reference's multi-instance coupling, mj_sim.cpp:847-960)."""
    cube = os.path.join(FIX, "sync_cube.xml")
    sims = []
    for ref in (False, True):
        spec = tscene.compose(WORLD, robots={
            "cube": tscene.RobotConfig(path=cube)})
        if ref:
            spec = tscene.add_reference_bodies(spec, ["cube"])
        sims.append(TSim(teng.set_const(tcompile(spec)),
                         dtype=torch.float64, device="cpu"))
    a, b = sims
    q = a.d.qpos.clone()
    q[0, :7] = torch.tensor([0.3, -0.2, 0.45, np.cos(0.3), 0, 0,
                             np.sin(0.3)], dtype=q.dtype)
    a.d = teng.forward(a.m, a.d.replace(qpos=q))
    sender = TServer(a, port=0)
    with _serving(sender):
        receiver = TServer(b, port=0, receive={"cube": ["position"]},
                           peer=("127.0.0.1", sender.port),
                           receive_rate=60.0)
        with _serving(receiver):
            mid = receiver._recv_mocap["cube"]
            want = a.d.xpos[0, 1]
            _wait(lambda: torch.equal(b.d.mocap_pos[0, mid], want),
                  "the mocap twin")
            assert torch.equal(b.d.mocap_quat[0, mid], a.d.xquat[0, 1])


def test_runtime_asset_spawn_hot_swaps_exactly(tmp_path):
    """A spawn by an unregistered mesh path (cube.stl, found through
    asset_dirs) recompiles the scene and swaps it in; the landed ball's
    state crosses bit for bit, and the JAX package builds the same
    model for the same request."""
    jm, tm = ball_models(instances=2)
    spec = tscene.compose(WORLD, robots={
        "sball": tscene.RobotConfig(path=BALL)}, instances=2)
    jspec = jscene.compose(WORLD, robots={
        "sball": jscene.RobotConfig(path=BALL)}, instances=2)
    slots = {"sball": ["sball", "1_sball"]}
    ts = TSim(tm, spawnable=slots, dtype=torch.float64, device="cpu")
    js = JSim(jm, spawnable=slots)
    tsrv = TServer(ts, port=0, spec=spec, asset_dirs=[FIX])
    jsrv = JServer(js, port=0, spec=jspec, asset_dirs=[FIX])
    req = {"info": {"name": "mycube", "type": 3, "mesh": "cube.stl"},
           "pose": [0, 0.5, 0.8, 1, 0, 0, 0]}
    with _serving(jsrv, tsrv):
        ball = {"info": {"name": "ball", "type": 1}, "class": "sball",
                "pose": [0.3, 0, 0.4, 1, 0, 0, 0]}
        a, b = _ask((_jax_port(jsrv), tsrv.port), "spawn_objects",
                    objects=[ball])
        assert a == b
        ts.step(8)
        before = ts.d
        old_m = ts.m
        a, b = _ask((_jax_port(jsrv), tsrv.port), "spawn_objects",
                    objects=[req])
        assert a == b and len(b["names"]) == 1
    assert ts.m is not old_m and "cube" in ts.slots
    slot = ts.by_public_name[b["names"][0]]
    assert bool(ts.d.body_active[0, slot.root_body])
    bslot = ts.by_public_name["ball_0"]
    for k, w, adr in (("qpos", 7, bslot.qpos_adr), ("qvel", 6, bslot.dof_adr),
                      ("qacc_warmstart", 6, bslot.dof_adr)):
        np.testing.assert_array_equal(
            getattr(ts.d, k)[0, adr:adr + w].numpy(),
            getattr(before, k)[0, adr:adr + w].numpy())
    assert torch.equal(ts.d.time, before.time)
    _assert_same_container(ts.m, convert.from_jax_model(js.m), rtol=1e-12)


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("path", ["floor_box.xml", "two_link.urdf",
                                  "world_empty.xml"])
def test_cli_info_matches_jax(path, monkeypatch):
    p = os.path.join(FIX, path)
    rc, out = _cli(tcli.main, ["info", p])
    monkeypatch.setattr("sys.argv", ["mujoco_sim_tpu", "info", p])
    jrc, jout = _cli(lambda argv: jcli.main(), None)
    assert (rc, out) == (jrc, jout) == (0, jout)
    assert "nq=" in out


def test_cli_compile_matches_jax(tmp_path, monkeypatch):
    src = os.path.join(FIX, "two_link.urdf")
    t, j = str(tmp_path / "t.xml"), str(tmp_path / "j.xml")
    rc, _ = _cli(tcli.main, ["compile", src, t, "1"])
    monkeypatch.setattr("sys.argv", ["mujoco_sim_tpu", "compile", src, j,
                                     "1"])
    jrc, _ = _cli(lambda argv: jcli.main(), None)
    assert rc == jrc == 0
    with open(t) as a, open(j) as b:
        assert a.read() == b.read()
    assert load_model(t).nbody == load_model(j).nbody


def test_cli_usage_lists_what_exists():
    rc, out = _cli(tcli.main, [])
    assert rc == 1 and all(c in out for c in ("serve", "compile", "render",
                                              "info"))
    assert _cli(tcli.main, ["nosuch", "x.xml"])[0] == 1


def test_live_viewer_headless(pair, tmp_path):
    """The port's copy of the client-side viewer renders frames from the
    markers stream and spawns through the service."""
    from mujoco_sim_tpu_torch.viz.live import LiveViewer

    js, ts, jp, tp = pair
    v = LiveViewer(port=tp, rate=30.0, interactive=False,
                   out_dir=str(tmp_path), spawn_classes={"s": ("sball", 1)})
    try:
        assert v.run(max_frames=2) == 2
        assert len(list(tmp_path.glob("live_*.png"))) >= 2
    finally:
        v.close()


# the bot's sim thread steps until the module ends: its tests come last
@pytest.fixture(scope="module")
def bot():
    """The port's server of the mobile bot (odom joints, RK4 world), with
    its sim thread on."""
    spec, m, sim, meta = tconfig.build(_bot_cfg(), device="cpu",
                                       dtype=torch.float64)
    srv = TServer(sim, port=0, spec=spec, robots=meta)
    srv.start(run_sim=True)
    try:
        yield srv
    finally:
        srv.stop()


def test_cmd_vel_drives_the_odom_joints(bot):
    c = _client(bot.port)
    try:
        assert c.cmd_vel("benchbot", [0.4, 0, 0, 0, 0, 0.3]) == {"ok": True}
        n0 = bot.steps
        _wait(lambda: bot.steps >= n0 + 3, "three steps")
        msg = next(iter(c.subscribe(["base_pose"], rate=30.0)))
    finally:
        c.close()
    odom = msg["base_pose"]["odom"][0]
    # the command is set before each step from the yaw it starts at; the
    # step then moves the yaw by dt * wz and the arm's reaction moves the
    # twist by ~1e-6
    dt = float(bot.sim.m.opt.timestep)
    yaw0 = odom["pose"][5] - dt * odom["twist"][5]
    np.testing.assert_allclose(
        odom["twist"][:2], [0.4 * np.cos(yaw0), 0.4 * np.sin(yaw0)],
        rtol=0, atol=1e-5)
    assert odom["twist"][5] == pytest.approx(0.3, abs=1e-5)
    assert odom["pose"][0] > 0 and odom["pose"][5] > 0
    assert bot._sim_thread.is_alive() and bot.sim_error is None


def test_reset_is_verified(bot):
    m = bot.sim.m
    c = _client(bot.port)
    try:
        resp = c.call("reset")
    finally:
        c.close()
    assert resp == {"success": True, "message": "reset"}
    with bot._lock:
        q = bot.sim.d.qpos[0]
        for jn, want in (("a1", 0.3), ("a2", -0.2)):
            qa = int(m.layout.jnt_qposadr[m.names.joint_id(jn)])
            assert abs(float(q[qa]) - want) < 0.05    # a few steps after
    assert bot._sim_thread.is_alive()
