"""Host API server: the reference's ROS surface over TCP JSON-lines.

Torch port of mujoco_sim_tpu/io/server.py.  Replaces layer L4 (MjRos,
src/mujoco_sim/mj_ros.cpp): services
/mujoco/{spawn_objects,destroy_objects,reset,screenshot}
(mj_ros.cpp:537-547), state/joint/base publishers (:554-564, 1639-1966) and
per-robot /cmd_vel subscription (:522-535).  Protocol: one JSON object per
line; requests carry "op"; subscriptions stream until the client closes.

The sim advances in a background thread; spawn/destroy are applied between
steps under one lock, which preserves the reference's atomicity contract
(the global mutex there, SURVEY §3.3).  The port's step is eager, so the
lock is held for the host time of a whole step; it is handed over in
arrival order, so a request waits for the step in progress and no more.  Data is never written in place (runtime/sim.py), so a snapshot
holds a reference and reads it after the lock is released; each reader
takes one host copy of env 0 of the leaves it needs.
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
import time
import traceback

import numpy as np
import torch

from mujoco_sim_tpu_torch.io.messages import ObjectInfo
from mujoco_sim_tpu_torch.runtime.sim import Simulation


class _FairLock:
    """A lock handed over in the order it was asked for.  The sim thread
    asks again as soon as a step ends; with a plain lock it would win
    again and again while a request waits (the eager step holds the
    interpreter through most of its host time), so each request now
    waits for at most the step in progress."""

    def __init__(self):
        self._cond = threading.Condition()
        self._next = 0      # next ticket to hand out
        self._serving = 0   # ticket that holds the lock

    def __enter__(self):
        with self._cond:
            ticket = self._next
            self._next += 1
            while ticket != self._serving:
                self._cond.wait()

    def __exit__(self, *exc):
        with self._cond:
            self._serving += 1
            self._cond.notify_all()


class SimServer:
    # reference robot.yaml:62-92 schema: per-topic, per-body-class rates
    TOPIC_CFG = {"markers": "pub_object_marker_array", "tf": "pub_tf",
                 "object_states": "pub_object_state_array",
                 "joint_states": "pub_joint_states"}
    CLASS_RATE = {"robot": "robot_bodies_rate",
                  "world": "world_bodies_rate",
                  "spawned": "spawned_object_bodies_rate"}

    def __init__(self, sim: Simulation, host="127.0.0.1", port=7500,
                 spec=None, robots=None, step_hz: float | None = None,
                 receive: dict | None = None, peer: tuple | None = None,
                 receive_rate: float = 60.0, pub_config: dict | None = None,
                 asset_dirs: list | None = None,
                 runtime_asset_instances: int = 2):
        """receive/peer implement the reference's multi-instance coupling
        (src/config/sim_1.yaml send:/receive:, mj_sim.cpp:847-960): `receive`
        maps body names (whose '<name>_ref' mocap twins exist in the model,
        models/scene.py add_reference_bodies) to received attrs; `peer` is
        (host, port) of the sending SimServer whose object_states stream
        drives the twins.  The send side needs no config — object_states is
        always published.  port 0 takes a free port from the OS; `port`
        holds the bound one once start() returns."""
        self.sim = sim
        self.host = host
        self.port = port
        self.spec = spec            # SpecTree for screenshot export
        self.robots = robots or {}  # robot -> {"joints": [...], "odom": cfg}
        self.cmd_vel = {}           # robot -> (6,) tensor on the sim device
        self._lock = _FairLock()
        self._running = False
        self._server = None
        self._loop = None
        self._thread = None
        self._sim_thread = None
        self._recv_thread = None
        self.steps = 0              # steps taken by the sim thread
        self.sim_error = None       # traceback that ended the sim thread
        self.step_hz = step_hz
        self.receive = receive or {}
        self.peer = peer
        self.receive_rate = receive_rate
        # per-class publisher config (MjRos::set_params, mj_ros.cpp:380-454)
        self.pub_config = pub_config or {}
        # runtime asset loading (slow path): dirs searched for spawn
        # `mesh` paths not registered at compile (mj_ros.cpp:1340-1363)
        self.asset_dirs = list(asset_dirs or [])
        self.runtime_asset_instances = runtime_asset_instances
        self._rt_count = 0
        self._body_class = self._classify_bodies()
        # body name -> mocap slot of its '_ref' twin
        self._recv_mocap = {}
        lay = sim.m.layout
        for name in self.receive:
            bid = sim.m.names.body_id(f"{name}_ref")
            if bid < 0:
                raise KeyError(f"receive body {name} has no {name}_ref twin "
                               "(compose the scene with reference_bodies)")
            self._recv_mocap[name] = int(lay.body_mocapid[bid])

    # ---------------- sim thread ----------------
    def _sim_worker(self):
        from mujoco_sim_tpu_torch.control import controllers as C

        odom_cfgs = {r: cfg.get("odom") for r, cfg in self.robots.items()
                     if cfg.get("odom") is not None}
        period = 1.0 / self.step_hz if self.step_hz else None
        try:
            while self._running:
                t0 = time.perf_counter()
                with self._lock:
                    d = self.sim.d
                    for robot, ocfg in odom_cfgs.items():
                        cmd = self.cmd_vel.get(robot)
                        if cmd is not None:
                            d = C.set_odom_vels(self.sim.m, d, ocfg, cmd)
                    # the step graph (captured here, under the lock, on
                    # the first step and after a hot swap)
                    self.sim.d = d
                    self.sim.step()
                    self.steps += 1
                if period:
                    rest = period - (time.perf_counter() - t0)
                    if rest > 0:
                        time.sleep(rest)
        except Exception:
            self.sim_error = traceback.format_exc()
            raise

    def _classify_bodies(self):
        """body id -> 'robot' | 'world' | 'spawned' (the reference's three
        publisher object classes {Robot, World, SpawnedObject})."""
        from mujoco_sim_tpu_torch.runtime.sim import subtree_bodies
        m = self.sim.m
        cls = ["world"] * m.nbody
        for slots in self.sim.slots.values():
            for slot in slots:
                for b in slot.bodies:
                    cls[int(b)] = "spawned"
        for robot in self.robots:
            bid = m.names.body_id(robot)
            if bid >= 0:
                for b in subtree_bodies(m, bid):
                    if cls[int(b)] == "world":
                        cls[int(b)] = "robot"
        return cls

    # ---------------- receive-side sync thread ----------------
    def _receiver_worker(self):
        """Subscribe to the peer's object_states and drive the local '_ref'
        mocap twins (reference: external instance sets the grey clones'
        poses; the weld drags the local body, mj_sim.cpp:847-960)."""
        from mujoco_sim_tpu_torch.io.client import SimClient

        while self._running:
            try:
                cli = SimClient(self.peer[0], self.peer[1])
            except OSError:
                time.sleep(0.2)
                continue
            try:
                # latest-wins: the per-message mocap update is slower than
                # the publish rate; subscribe() would replay an unbounded
                # backlog of stale poses
                for msg in cli.subscribe_latest(["object_states"],
                                                rate=self.receive_rate):
                    if not self._running:
                        break
                    objs = msg.get("object_states", {}).get("objects", [])
                    updates = []
                    for o in objs:
                        mid = self._recv_mocap.get(o.get("name"))
                        if mid is None:
                            continue
                        pose = o.get("pose", {})
                        updates.append((mid, pose.get("position"),
                                        pose.get("orientation")))
                    if not updates:
                        continue
                    with self._lock:
                        d = self.sim.d
                        mp, mq = d.mocap_pos.clone(), d.mocap_quat.clone()
                        for mid, pos, quat in updates:
                            if pos is not None:
                                mp[0, mid] = torch.tensor(pos, dtype=mp.dtype)
                            if quat is not None:
                                mq[0, mid] = torch.tensor(quat,
                                                          dtype=mq.dtype)
                        self.sim.d = d.replace(mocap_pos=mp, mocap_quat=mq)
            except (OSError, ConnectionError, ValueError):
                time.sleep(0.2)
            finally:
                cli.close()

    # ---------------- request handling ----------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                try:
                    req = json.loads(line)
                except json.JSONDecodeError:
                    writer.write(b'{"error": "bad json"}\n')
                    await writer.drain()
                    continue
                op = req.get("op")
                if op == "subscribe":
                    await self._stream(writer, req)
                    break
                resp = self._dispatch(req)
                writer.write((json.dumps(resp) + "\n").encode())
                await writer.drain()
        except (ConnectionResetError, asyncio.CancelledError):
            pass
        finally:
            writer.close()

    def _resolve_class(self, info) -> str:
        """Map an ObjectInfo to a registered spawn class.

        The reference's spawn service accepts `mesh: "../test/cup.xml"`
        and loads arbitrary assets at runtime
        (mj_ros.cpp:1340-1363).  Mesh PATHS resolve by basename against
        the classes registered at compile; an unregistered path raises
        (the caller then tries the runtime-asset slow path)."""
        mesh = info.mesh or ""
        if not mesh:
            return ["cube", "sphere", "cylinder", "mesh"][info.type]
        key = mesh
        if "/" in mesh or "." in mesh:
            key = os.path.splitext(os.path.basename(mesh))[0]
        if key in self.sim.slots:
            return key
        raise KeyError(
            f"spawn mesh {mesh!r} is not a registered spawn class "
            f"(have: {sorted(self.sim.slots)}).  Runtime asset loading is "
            f"incompatible with the static-shape contract: register the "
            f"model at compile time via MaskedSim(spawnable={{'{key}': "
            f"[...paths...]}}) / the server's spawnable config, then spawn "
            f"by class name or mesh basename.")

    def _find_asset(self, mesh: str):
        """Resolve a spawn-request mesh path to a real file: absolute, or
        relative against asset_dirs (the reference resolves against its
        model directory)."""
        if not mesh or not ("/" in mesh or "." in mesh):
            return None
        if os.path.isabs(mesh):
            return mesh if os.path.exists(mesh) else None
        for d in self.asset_dirs:
            p = os.path.normpath(os.path.join(d, mesh))
            if os.path.exists(p):
                return p
        return None

    def register_runtime_asset(self, mesh: str, path: str,
                               instances: int | None = None) -> str:
        """Load a never-registered asset into the LIVE sim (slow path).

        The reference contract (save -> modify -> reload ->
        `add_old_state` transplant -> swap, mj_sim.cpp:465-558,804-845;
        service behavior mj_ros.cpp:1340-1363): the running scene is
        re-composed with `instances` masked spawn slots of the new asset
        (scene .xml via scene.add_robot; raw .stl/.obj wrapped in a
        free body), recompiled, put on the sim's device, survivors' state
        transplanted BIT-exact (Simulation.hot_swap), and (m, d) swapped
        under the lock.  The new layout's plans are built once, on its
        first step; registered-class spawns stay on the fast path.
        Returns the new class name."""
        import copy as _copy
        from mujoco_sim_tpu_torch.engine import set_const
        from mujoco_sim_tpu_torch.models import mjcf, scene as scene_mod
        from mujoco_sim_tpu_torch.models.compile import compile_spec

        if self.spec is None:
            raise RuntimeError(
                "runtime asset loading needs the server's scene spec "
                "(SimServer(spec=...))")
        cls = os.path.splitext(os.path.basename(mesh))[0]
        n_inst = instances or self.runtime_asset_instances
        spec2 = _copy.deepcopy(self.spec)
        roots = []
        if path.lower().endswith((".stl", ".obj")):
            mname = f"rt{self._rt_count}_{cls}"
            spec2.meshes.append(mjcf.MeshSpec(name=mname, file=path))
            for i in range(n_inst):
                name = f"rt{self._rt_count}_{i}_{cls}"
                body = mjcf.BodySpec(name=name)
                body.joints.append(mjcf.JointSpec(name=f"{name}_free",
                                                  type="free"))
                body.geoms.append(mjcf.GeomSpec(name=f"{name}_geom",
                                                type="mesh", mesh=mname))
                spec2.world.children.append(body)
                roots.append(name)
        else:
            for i in range(n_inst):
                scene_mod.add_robot(spec2, cls,
                                    scene_mod.RobotConfig(path=path),
                                    prefix=f"rt{self._rt_count}_{i}_")
                roots.append(spec2.world.children[-1].name)
        self._rt_count += 1
        m2 = set_const(compile_spec(spec2))
        # carry every existing class's slot roots forward by name
        old_names = self.sim.m.names
        spawnable = {c: [old_names.body[s.root_body] for s in lst]
                     for c, lst in self.sim.slots.items()}
        spawnable.setdefault(cls, []).extend(roots)
        self.sim.hot_swap(m2, spawnable)
        self.spec = spec2
        self._body_class = self._classify_bodies()
        return cls

    def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        try:
            if op == "spawn_objects":
                names = []
                with self._lock:
                    for obj in req.get("objects", []):
                        info = ObjectInfo.from_dict(obj.get("info", obj))
                        pose = obj.get("pose")
                        vel = obj.get("velocity")
                        try:
                            cls = obj.get("class") or \
                                self._resolve_class(info)
                        except KeyError:
                            # runtime loading of an UNREGISTERED asset:
                            # the reference reload-and-transplant path
                            # (mj_ros.cpp:1340-1363); recompile + exact
                            # state transplant
                            path = self._find_asset(info.mesh)
                            if path is None:
                                raise
                            cls = self.register_runtime_asset(
                                info.mesh, path)
                        inertial = None
                        if info.inertial is not None and info.inertial.m > 0:
                            inertial = {"m": info.inertial.m,
                                        "ixx": info.inertial.ixx,
                                        "iyy": info.inertial.iyy,
                                        "izz": info.inertial.izz}
                        names.append(self.sim.spawn(
                            cls, info.name,
                            pose=np.asarray(pose) if pose else None,
                            velocity=np.asarray(vel) if vel else None,
                            size=(np.asarray(info.size)
                                  if obj.get("info", {}).get("size")
                                  or "size" in obj else None),
                            rgba=(np.asarray(info.rgba)
                                  if obj.get("info", {}).get("rgba")
                                  or "rgba" in obj else None),
                            inertial=inertial))
                return {"names": names}
            if op == "destroy_objects":
                states = []
                with self._lock:
                    for name in req.get("names", []):
                        st = self.sim.destroy(name)
                        states.append({
                            "name": name,
                            "pose": np.asarray(st.get("pose", [])).tolist(),
                            "velocity": np.asarray(
                                st.get("velocity", [])).tolist()})
                return {"object_states": states}
            if op == "reset":
                with self._lock:
                    self.sim.reset({r: cfg.get("joints", [])
                                    for r, cfg in self.robots.items()})
                    # verify post-reset joint error like the reference
                    # (mj_ros.cpp:815-845: total error < 0.1 * njoints)
                    err = self._reset_error()
                ok = err < 0.1 * max(1, self.sim.m.njnt)
                return {"success": bool(ok),
                        "message": "reset" if ok else
                        f"reset verification failed (err={err:.4f})"}
            if op == "screenshot":
                from mujoco_sim_tpu_torch.runtime.checkpoint import screenshot
                out = req.get("out_dir", "/tmp/mst_screenshot")
                with self._lock:
                    files = screenshot(self.spec, self.sim.m, self.sim.d,
                                       out, req.get("name", "snapshot"))
                return {"success": True, "files": files}
            if op == "cmd_vel":
                robot = req.get("robot")
                tw = req.get("twist", [0, 0, 0, 0, 0, 0])
                # locked: _sim_worker reads cmd_vel under the same lock
                with self._lock:
                    m = self.sim.m
                    self.cmd_vel[robot] = torch.tensor(
                        [float(v) for v in tw], dtype=m.dtype,
                        device=m.device)
                return {"ok": True}
            if op == "get_state":
                return self._world_state(req.get("names"))
            return {"error": f"unknown op {op}"}
        except Exception as e:  # service errors -> failure response
            return {"error": str(e), "success": False}

    def _reset_error(self) -> float:
        m, d = self.sim.m, self.sim.d
        lay = m.layout
        qpos = d.qpos[0].cpu().numpy()
        err = 0.0
        for r, cfg in self.robots.items():
            for jn in cfg.get("joints", []):
                j = m.names.joint_id(jn)
                if j >= 0 and int(lay.jnt_type[j]) in (2, 3):
                    init = self.sim._joint_inits.get(jn, 0.0)
                    err += abs(float(qpos[lay.jnt_qposadr[j]]) - init)
        return err

    def _snapshot(self, *leaves):
        """Consistent publisher snapshot: one locked read of the data ref
        plus a copy of the spawned-name map, then one host copy of env 0
        of each named leaf (numpy) and of the sim time (a float).  Data is never
        written in place, so reading it after the lock is race-free; the
        lock only prevents tearing between d and by_public_name (the
        reference's publisher threads read m/d UNLOCKED, a
        benign-by-convention race closed here — PARITY §2.5)."""
        with self._lock:
            m, d, by_name = self.sim.m, self.sim.d, dict(
                self.sim.by_public_name)
        host = {k: getattr(d, k)[0].cpu().numpy() for k in leaves}
        host["time"] = float(d.time[0])
        return m, host, by_name

    def _free_jnt_vel(self, bid: int, qvel: np.ndarray):
        """Root free-joint twist of a body, if any (the reference reads
        d->qvel at the freejoint for ObjectState velocity)."""
        lay = self.sim.m.layout
        if lay.body_jntnum[bid] > 0:
            j0 = int(lay.body_jntadr[bid])
            if int(lay.jnt_type[j0]) == 0:
                da = int(lay.jnt_dofadr[j0])
                v = qvel[da:da + 6]
                return {"linear": v[:3].tolist(), "angular": v[3:].tolist()}
        return None

    def _is_free_body(self, bid: int) -> bool:
        lay = self.sim.m.layout
        return (lay.body_jntnum[bid] > 0
                and int(lay.jnt_type[lay.body_jntadr[bid]]) == 0)

    def _world_state(self, names=None, free_bodies_only=False,
                     classes=None) -> dict:
        m, h, by_name = self._snapshot("xpos", "xquat",
                                       "body_active", "qvel")
        xpos, xquat, active = h["xpos"], h["xquat"], h["body_active"]
        out = []
        if names is None:
            sel = [m.names.body[i] for i in range(1, m.nbody)]
            sel += list(by_name)
        else:
            sel = names
        for name in sel:
            # spawned objects are addressed by their allocated public name
            slot = by_name.get(name)
            bid = slot.root_body if slot is not None else m.names.body_id(name)
            if bid < 0 or not active[bid]:
                continue
            if classes is not None and self._body_class[bid] not in classes:
                continue
            if free_bodies_only and not self._is_free_body(bid):
                continue
            entry = {"name": name, "pose": {
                "position": xpos[bid].tolist(),
                "orientation": xquat[bid].tolist()}}
            vel = self._free_jnt_vel(bid, h["qvel"])
            if vel is not None:
                entry["velocity"] = vel
            out.append(entry)
        return {"time": h["time"], "objects": out}

    def _base_pose(self) -> dict:
        """Odometry for robots with odom joints (publish_base_pose,
        mj_ros.cpp:1862-1931)."""
        m, h, _ = self._snapshot("qpos", "qvel")
        qpos, qvel = h["qpos"], h["qvel"]
        out = []
        for robot, cfg in self.robots.items():
            ocfg = cfg.get("odom")
            if ocfg is None:
                continue
            pose = [0.0] * 6
            twist = [0.0] * 6
            for i in range(6):
                if ocfg.present[i]:
                    pose[i] = float(qpos[ocfg.qpos_ids[i]])
                    twist[i] = float(qvel[ocfg.dof_ids[i]])
            out.append({"robot": robot, "pose": pose, "twist": twist})
        return {"time": h["time"], "odom": out}

    def _markers(self, classes=None, free_bodies_only=False) -> dict:
        """Marker-array equivalent: geom shapes + world transforms for viz
        clients (publish_marker_array, mj_ros.cpp:1706-1755)."""
        m, h, _ = self._snapshot("geom_xpos", "geom_xmat",
                                 "geom_size", "geom_rgba", "body_active")
        lay = m.layout
        gx, active = h["geom_xpos"], h["body_active"]
        markers = []
        for g in range(m.ngeom):
            bid = int(lay.geom_bodyid[g])
            if not active[bid]:
                continue
            if classes is not None and self._body_class[bid] not in classes:
                continue
            if free_bodies_only and not self._is_free_body(bid):
                continue
            markers.append({
                "name": m.names.geom[g],
                "type": int(lay.geom_type[g]),
                "size": h["geom_size"][g].tolist(),
                "position": gx[g].tolist(),
                "mat": h["geom_xmat"][g].reshape(9).tolist(),
                "rgba": h["geom_rgba"][g].tolist()})
        return {"time": h["time"], "markers": markers}

    def _joint_states(self, robot=None, classes=None) -> dict:
        m, h, _ = self._snapshot("qpos", "qvel")
        lay = m.layout
        qpos, qvel = h["qpos"], h["qvel"]
        joints = []
        for j in range(m.njnt):
            if classes is not None and self._body_class[
                    int(lay.jnt_bodyid[j])] not in classes:
                continue
            if int(lay.jnt_type[j]) in (2, 3):  # slide/hinge
                joints.append({
                    "name": m.names.joint[j],
                    "position": float(qpos[lay.jnt_qposadr[j]]),
                    "velocity": float(qvel[lay.jnt_dofadr[j]])})
        return {"time": h["time"], "joints": joints}

    def _sensors(self) -> dict:
        """Named per-sensor readout (reference publishes one named 3-D
        vector per FORCE/TORQUE sensor, mj_ros.cpp:1933-1966; here EVERY
        sensor is named).  `sensors` maps name -> value slice via the
        model's sensor_adr table; the flat `sensordata` stays for bulk
        clients."""
        m, h, _ = self._snapshot("sensordata")
        data = h["sensordata"]
        adr = m.sensor_adr.cpu().numpy().astype(int)
        named = {}
        for i in range(m.nsensor):
            lo = adr[i]
            hi = adr[i + 1] if i + 1 < m.nsensor else m.nsensordata
            named[m.names.sensor[i]] = data[lo:hi].tolist()
        return {"time": h["time"], "sensors": named,
                "sensordata": data.tolist()}

    def _due_classes(self, topic: str, now: float, next_due: dict,
                     default_rate: float):
        """Per-body-class scheduling from pub_config (robot.yaml:62-92):
        each class {robot, world, spawned} publishes at its own rate; a rate
        of 0 disables the class.  Without config, all classes tick at the
        subscription rate."""
        cfg = self.pub_config.get(self.TOPIC_CFG.get(topic, ""), None)
        due = []
        for cls, key in self.CLASS_RATE.items():
            rate = (float(cfg.get(key, 0.0)) if cfg is not None
                    else default_rate)
            if rate <= 0:
                continue
            slot = (topic, cls)
            if now >= next_due.get(slot, 0.0):
                due.append(cls)
                next_due[slot] = max(next_due.get(slot, now),
                                     now) + 1.0 / rate
        fbo = bool(cfg.get("free_bodies_only", False)) if cfg else False
        return due, fbo

    async def _stream(self, writer: asyncio.StreamWriter, req: dict):
        topics = req.get("topics", ["object_states"])
        rate = float(req.get("rate", 60.0))
        period = 1.0 / max(rate, 1e-3)
        next_due: dict = {}
        try:
            while self._running:
                now = time.monotonic()
                msg = {}
                if "object_states" in topics or "tf" in topics:
                    due, fbo = self._due_classes("object_states", now,
                                                 next_due, rate)
                    if due:
                        msg["object_states"] = self._world_state(
                            free_bodies_only=bool(req.get(
                                "free_bodies_only", fbo)),
                            classes=set(due))
                if "base_pose" in topics:
                    msg["base_pose"] = self._base_pose()
                if "markers" in topics:
                    due, fbo = self._due_classes("markers", now, next_due,
                                                 rate)
                    if due:
                        msg["markers"] = self._markers(
                            classes=set(due), free_bodies_only=fbo)
                if "joint_states" in topics:
                    due, _ = self._due_classes("joint_states", now,
                                               next_due, rate)
                    if due:
                        msg["joint_states"] = self._joint_states(
                            classes=set(due))
                if "sensors" in topics:
                    msg["sensors"] = self._sensors()
                if msg:
                    writer.write((json.dumps(msg) + "\n").encode())
                    await writer.drain()
                await asyncio.sleep(period)
        except (ConnectionResetError, BrokenPipeError):
            pass

    # ---------------- lifecycle ----------------
    def start(self, run_sim: bool = True):
        self._running = True
        ready = threading.Event()

        def runner():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)

            async def main():
                self._server = await asyncio.start_server(
                    self._handle, self.host, self.port)
                self.port = self._server.sockets[0].getsockname()[1]
                ready.set()
                async with self._server:
                    await self._server.serve_forever()

            try:
                self._loop.run_until_complete(main())
            except asyncio.CancelledError:
                pass

        self._thread = threading.Thread(target=runner, daemon=True)
        self._thread.start()
        if not ready.wait(timeout=10):
            raise RuntimeError(f"SimServer: could not listen on "
                               f"{self.host}:{self.port}")
        if run_sim:
            self._sim_thread = threading.Thread(target=self._sim_worker,
                                                daemon=True)
            self._sim_thread.start()
        if self.receive and self.peer:
            self._recv_thread = threading.Thread(
                target=self._receiver_worker, daemon=True)
            self._recv_thread.start()

    def stop(self):
        self._running = False
        if self._loop is not None:
            def _shutdown():
                for task in asyncio.all_tasks(self._loop):
                    task.cancel()
            self._loop.call_soon_threadsafe(_shutdown)
        for t in (self._sim_thread, self._thread, self._recv_thread):
            if t is not None:
                t.join(timeout=5)
