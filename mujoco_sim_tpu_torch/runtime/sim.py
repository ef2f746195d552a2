"""Simulation runtime: masked spawn/destroy, reset, hot swap, name allocation.

Torch port of mujoco_sim_tpu/runtime/sim.py.  Replaces the reference's
reload-and-transplant scene mutation (MjRos::spawn_objects ->
MjSim::add_data -> load_tmp_model -> add_old_state, SURVEY.md §3.3) with
pre-allocated padded slots toggled by Data.body_active masks: survivors'
state is preserved exactly, spawn is atomic w.r.t. stepping, destroy
returns final states, and the model and its plans are not rebuilt.

The port's Data always carries a leading env axis, so a ``Simulation``
holds one env as ``make_data(m, 1)``.  Its step and its reset's forward
run through utils/graph.StepGraph (one CUDA graph a step on the card, as
the JAX package jits them); spawn and destroy flip Data masks and
overrides between steps, which the graph copies in on every call, and a
hot swap makes new graphs for the new model.  Every edit is functional: a leaf is
cloned before it is written and the clone is ``replace``d into a new Data,
because a server snapshot or the sim thread may still hold the old one.

Capacity planning: the scene is composed with N spawnable instances per
object class (models/scene.py ``instances=``); spawn claims a free slot,
destroy releases it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np
import torch

from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.model import Model, Data, GeomType, JointType
from mujoco_sim_tpu_torch.utils.graph import StepGraph


class NameAllocator:
    """The reference's name-uniquing behavior (add_index/check_index,
    src/mujoco_sim/mj_ros.cpp:137-187): requested names get a numeric
    suffix; existing trailing digits are replaced; collisions bump a global
    per-class counter until unique."""

    def __init__(self, existing=()):
        self.known = set(existing)
        self.unique_index = 0

    def allocate(self, requested: str) -> str:
        name = requested
        while True:
            m_ = re.search(r"(\d+)$", name)
            if m_ is None or name.endswith("_"):
                candidate = f"{name}_{self.unique_index}"
            else:
                candidate = name[: m_.start(1)] + str(self.unique_index)
            if candidate not in self.known:
                self.known.add(candidate)
                return candidate
            self.unique_index += 1

    def release(self, name: str):
        self.known.discard(name)


@dataclasses.dataclass
class SpawnSlot:
    """One pre-allocated object instance (a subtree rooted at root_body)."""

    root_body: int                 # body id of the instance root
    bodies: np.ndarray             # all body ids in the subtree
    free_jnt: int                  # free joint id of the root (-1 if none)
    qpos_adr: int                  # its qpos address
    dof_adr: int
    geoms: np.ndarray = None       # geom ids of the subtree
    in_use: bool = False
    public_name: str = ""


def _rbound_of(gtype: int, s: np.ndarray) -> float:
    """Bounding radius by geom type (matches models/compile.py:451-469)."""
    t = GeomType(gtype)
    if t == GeomType.SPHERE:
        return float(s[0])
    if t == GeomType.CAPSULE:
        return float(s[0] + s[1])
    if t == GeomType.CYLINDER:
        return float(np.sqrt(s[0] ** 2 + s[1] ** 2))
    if t == GeomType.BOX:
        return float(np.linalg.norm(s))
    if t == GeomType.ELLIPSOID:
        return float(s.max())
    return 0.0


def _mass_inertia_of(gtype: int, s: np.ndarray, density: float):
    """(mass, diagonal inertia) from geometry + density (the MJCF compiler's
    behavior the reference relies on when the request has no inertial,
    mj_ros.cpp:941-966 building a plain <geom>)."""
    t = GeomType(gtype)
    if t == GeomType.SPHERE:
        r = float(s[0])
        mass = density * 4.0 / 3.0 * np.pi * r ** 3
        i = 0.4 * mass * r * r
        return mass, np.array([i, i, i])
    if t == GeomType.BOX:
        sx, sy, sz = float(s[0]), float(s[1]), float(s[2])
        mass = density * 8.0 * sx * sy * sz
        return mass, mass / 3.0 * np.array(
            [sy * sy + sz * sz, sx * sx + sz * sz, sx * sx + sy * sy])
    if t == GeomType.CYLINDER:
        r, h = float(s[0]), float(s[1])
        mass = density * np.pi * r * r * (2.0 * h)
        ixy = mass * (3.0 * r * r + 4.0 * h * h) / 12.0
        return mass, np.array([ixy, ixy, 0.5 * mass * r * r])
    if t == GeomType.CAPSULE:
        r, h = float(s[0]), float(s[1])
        m_cyl = density * np.pi * r * r * (2.0 * h)
        m_sph = density * 4.0 / 3.0 * np.pi * r ** 3
        mass = m_cyl + m_sph
        iz = 0.5 * m_cyl * r * r + 0.4 * m_sph * r * r
        ixy = (m_cyl * (3.0 * r * r + 4.0 * h * h) / 12.0
               + m_sph * (0.4 * r * r + h * h + 0.75 * h * r))
        return mass, np.array([ixy, ixy, iz])
    if t == GeomType.ELLIPSOID:
        a, b, c = float(s[0]), float(s[1]), float(s[2])
        mass = density * 4.0 / 3.0 * np.pi * a * b * c
        return mass, 0.2 * mass * np.array(
            [b * b + c * c, a * a + c * c, a * a + b * b])
    raise ValueError(f"cannot derive inertia for geom type {t}")


_JNT_WIDTHS = {int(JointType.FREE): (7, 6), int(JointType.BALL): (4, 3),
               int(JointType.SLIDE): (1, 1), int(JointType.HINGE): (1, 1)}

_TRANSPLANTED = ("qpos", "qvel", "qacc", "qacc_warmstart", "qfrc_applied",
                 "xfrc_applied", "body_active", "body_mass", "body_inertia",
                 "geom_size", "geom_rbound", "geom_rgba", "ctrl", "act",
                 "mocap_pos", "mocap_quat")


def transplant_state(old_m: Model, old_d: Data, new_m: Model,
                     new_d: Data) -> Data:
    """Name-matched exact state transplant across a model recompile (the
    reference's `add_old_state`, mj_sim.cpp:465-558): every joint, body,
    geom and actuator present in BOTH models carries its state over
    bit-exactly (host copies, no arithmetic, one move to the device per
    leaf); entities only in the new model keep their compiled defaults.
    Copied state mirrors the reference's list — time,
    qpos/qvel/qacc/qacc_warmstart/qfrc_applied (by joint), xfrc_applied +
    active mask + runtime mass/inertia (by body), runtime geom
    size/rbound/rgba (by geom), ctrl/act (by actuator), mocap pose (by
    mocap body).  Both Data hold one env."""
    lo, ln = old_m.layout, new_m.layout
    out = {k: getattr(new_d, k)[0].cpu().numpy().copy()
           for k in _TRANSPLANTED}
    olds = {k: getattr(old_d, k)[0].cpu().numpy() for k in _TRANSPLANTED}
    for jname in old_m.names.joint:
        j_o = old_m.names.joint_id(jname)
        j_n = new_m.names.joint_id(jname)
        if j_o < 0 or j_n < 0:
            continue
        nq_w, nv_w = _JNT_WIDTHS[int(lo.jnt_type[j_o])]
        qa_o, qa_n = int(lo.jnt_qposadr[j_o]), int(ln.jnt_qposadr[j_n])
        da_o, da_n = int(lo.jnt_dofadr[j_o]), int(ln.jnt_dofadr[j_n])
        out["qpos"][qa_n:qa_n + nq_w] = olds["qpos"][qa_o:qa_o + nq_w]
        for k in ("qvel", "qacc", "qacc_warmstart", "qfrc_applied"):
            out[k][da_n:da_n + nv_w] = olds[k][da_o:da_o + nv_w]
    for bname in old_m.names.body:
        b_o = old_m.names.body_id(bname)
        b_n = new_m.names.body_id(bname)
        if b_o <= 0 or b_n <= 0:    # skip world
            continue
        for k in ("xfrc_applied", "body_active", "body_mass",
                  "body_inertia"):
            out[k][b_n] = olds[k][b_o]
        mo, mn = int(lo.body_mocapid[b_o]), int(ln.body_mocapid[b_n])
        if mo >= 0 and mn >= 0:
            out["mocap_pos"][mn] = olds["mocap_pos"][mo]
            out["mocap_quat"][mn] = olds["mocap_quat"][mo]
    for gname in old_m.names.geom:
        if not gname:
            continue
        g_o = old_m.names.geom_id(gname)
        g_n = new_m.names.geom_id(gname)
        if g_o < 0 or g_n < 0:
            continue
        for k in ("geom_size", "geom_rbound", "geom_rgba"):
            out[k][g_n] = olds[k][g_o]
    for aname in old_m.names.actuator:
        a_o = old_m.names.actuator_id(aname)
        a_n = new_m.names.actuator_id(aname)
        if a_o < 0 or a_n < 0:
            continue
        out["ctrl"][a_n] = olds["ctrl"][a_o]
        out["act"][a_n] = olds["act"][a_o]
    leaves = {k: torch.as_tensor(v[None], dtype=getattr(new_d, k).dtype,
                                 device=new_d.qpos.device)
              for k, v in out.items()}
    return new_d.replace(time=old_d.time.clone(), **leaves)


def subtree_bodies(m: Model, root: int) -> np.ndarray:
    lay = m.layout
    out = [root]
    for b in range(root + 1, m.nbody):
        i = b
        while i > root:
            i = int(lay.body_parentid[i])
        if i == root:
            out.append(b)
    return np.asarray(sorted(set(out)), dtype=int)


def _on_device(m: Model, dtype, device) -> Model:
    """A host model (numpy leaves, as compile_spec/set_const build it) is
    put on ``device``; a model already put is used as it is."""
    if isinstance(m.qpos0, np.ndarray):
        return engine.put_model(
            m, torch.float32 if dtype is None else dtype, device)
    return m


def _set_rows(x: torch.Tensor, idx, value) -> torch.Tensor:
    """A copy of x (1, ...) with x[0, idx] = value; x itself is untouched."""
    x = x.clone()
    x[0, idx] = torch.as_tensor(value, dtype=x.dtype, device=x.device)
    return x


class Simulation:
    """Host-side stateful wrapper over (Model, Data) providing the service
    surface of the reference node: spawn/destroy/reset (mj_ros.cpp:859-1518,
    569-609).  Data itself stays an immutable container of one env; this
    class orchestrates."""

    def __init__(self, m: Model, spawnable: dict[str, list[str]] | None = None,
                 dtype=None, device="cuda"):
        """m: a model put on a device (engine.put_model), or a host model,
        which is put on ``device`` (the card unless the caller names
        another; without a CUDA device that raises) in ``dtype`` (float32
        by default).  spawnable: class name -> list of pre-allocated root
        body names (e.g. {"pr2": ["1_pr2", "2_pr2"]}); those start
        inactive."""
        m = _on_device(m, dtype, device)
        self.m = m
        self.d = engine.make_data(m, 1, dtype)
        self.step_graph = StepGraph(engine.step)
        self.forward_graph = StepGraph(engine.forward)
        self.names = NameAllocator(m.names.body)
        self.slots: dict[str, list[SpawnSlot]] = {}
        self.by_public_name: dict[str, SpawnSlot] = {}
        self._joint_inits: dict[str, float] = {}
        lay = m.layout
        inactive = []
        for cls, roots in (spawnable or {}).items():
            lst = []
            for rn in roots:
                bid = m.names.body_id(rn)
                if bid < 0:
                    raise KeyError(f"spawn slot body {rn} not in model")
                bodies = subtree_bodies(m, bid)
                fj = -1
                qa = da = -1
                if lay.body_jntnum[bid] > 0:
                    j0 = int(lay.body_jntadr[bid])
                    if lay.jnt_type[j0] == int(JointType.FREE):
                        fj = j0
                        qa = int(lay.jnt_qposadr[j0])
                        da = int(lay.jnt_dofadr[j0])
                geoms = np.nonzero(np.isin(lay.geom_bodyid, bodies))[0]
                lst.append(SpawnSlot(bid, bodies, fj, qa, da, geoms))
                inactive.extend(bodies.tolist())
            self.slots[cls] = lst
        if inactive:
            ba = np.ones((1, m.nbody), dtype=bool)
            ba[0, np.asarray(inactive)] = False
            self.d = self.d.replace(
                body_active=torch.as_tensor(ba, device=m.device))

    # ------------------------------------------------------------------
    def set_joint_inits(self, joint_inits: dict[str, float]):
        self._joint_inits = dict(joint_inits)

    def spawn(self, object_class: str, requested_name: str = "",
              pose: Optional[np.ndarray] = None,
              velocity: Optional[np.ndarray] = None,
              size: Optional[np.ndarray] = None,
              rgba: Optional[np.ndarray] = None,
              inertial: Optional[dict] = None,
              density: float = 1000.0) -> str:
        """Claim a free slot; returns the allocated unique name.

        pose: (7,) [x y z qw qx qy qz]; velocity: (6,) [v w] — applied to
        the slot's free joint.  size/rgba/inertial parameterize the slot's
        geometry per request like the reference's spawn building a geom from
        ObjectInfo (mj_ros.cpp:941-966,1340-1412): geom size/rbound/rgba and
        body mass/inertia are Data leaves, so this never rebuilds the model.
        size applies to single-geom slots (primitive classes); inertial is
        {"m": float, "ixx"/"iyy"/"izz": float} (com offsets unsupported);
        without inertial, mass/inertia follow geometry at `density` (the
        MJCF-compiler default the reference inherits).  Mesh-hull collision
        shapes are compile-time; resizing mesh slots is rejected.
        """
        slots = self.slots.get(object_class)
        if not slots:
            raise KeyError(f"no spawn slots for class {object_class}")
        slot = next((s for s in slots if not s.in_use), None)
        if slot is None:
            raise RuntimeError(f"all {object_class} slots in use")
        # checked before the slot is claimed, so a refused request leaves
        # the simulation as it was
        if size is not None:
            if slot.geoms is None or len(slot.geoms) != 1:
                raise ValueError(
                    f"size override requires a single-geom slot; "
                    f"class {object_class} has {len(slot.geoms or [])} geoms")
            if int(self.m.layout.geom_type[int(slot.geoms[0])]) == int(
                    GeomType.MESH):
                raise ValueError("mesh slots cannot be resized at runtime")
        name = self.names.allocate(requested_name or object_class)
        slot.in_use = True
        slot.public_name = name
        self.by_public_name[name] = slot

        d = self.d
        lay = self.m.layout
        d = d.replace(body_active=_set_rows(d.body_active, slot.bodies, True))
        if slot.free_jnt >= 0 and pose is not None:
            d = d.replace(qpos=_set_rows(
                d.qpos, slice(slot.qpos_adr, slot.qpos_adr + 7),
                np.asarray(pose, np.float64)))
        if slot.free_jnt >= 0 and velocity is not None:
            d = d.replace(qvel=_set_rows(
                d.qvel, slice(slot.dof_adr, slot.dof_adr + 6),
                np.asarray(velocity, np.float64)))
        b = slot.root_body
        if size is not None:
            g = int(slot.geoms[0])
            gtype = int(lay.geom_type[g])
            s3 = np.zeros(3)
            s3[: len(np.atleast_1d(size))] = np.atleast_1d(size)
            d = d.replace(geom_size=_set_rows(d.geom_size, g, s3),
                          geom_rbound=_set_rows(d.geom_rbound, g,
                                                _rbound_of(gtype, s3)))
            if inertial is not None:
                mass = float(inertial["m"])
                inert = np.array([inertial.get("ixx", 0.0),
                                  inertial.get("iyy", 0.0),
                                  inertial.get("izz", 0.0)])
                if not inert.any():
                    _, inert = _mass_inertia_of(gtype, s3, density)
                    inert *= mass / max(_mass_inertia_of(
                        gtype, s3, density)[0], 1e-12)
            else:
                mass, inert = _mass_inertia_of(gtype, s3, density)
            d = d.replace(body_mass=_set_rows(d.body_mass, b, mass),
                          body_inertia=_set_rows(d.body_inertia, b, inert))
        elif inertial is not None:
            d = d.replace(body_mass=_set_rows(d.body_mass, b,
                                              float(inertial["m"])))
            inert = np.array([inertial.get("ixx", 0.0),
                              inertial.get("iyy", 0.0),
                              inertial.get("izz", 0.0)])
            if inert.any():
                d = d.replace(body_inertia=_set_rows(d.body_inertia, b,
                                                     inert))
        if rgba is not None and slot.geoms is not None and len(slot.geoms):
            d = d.replace(geom_rgba=_set_rows(
                d.geom_rgba, slot.geoms, np.asarray(rgba, np.float64)))
        self.d = d
        return name

    def destroy(self, name: str) -> dict:
        """Release a slot; returns the final state of the destroyed object
        (the reference's DestroyObject response, mj_ros.cpp:1430-1507)."""
        slot = self.by_public_name.pop(name, None)
        if slot is None:
            raise KeyError(f"unknown object {name}")
        m, d = self.m, self.d
        state = {}
        if slot.free_jnt >= 0:
            qa, da = slot.qpos_adr, slot.dof_adr
            state["pose"] = d.qpos[0, qa:qa + 7].cpu().numpy()
            state["velocity"] = d.qvel[0, da:da + 6].cpu().numpy()
            # park the body far away + zero velocity so its (inactive)
            # contacts never win top-k and its state stays finite
            park = np.array([0.0, 0.0, -1000.0 - 10.0 * slot.root_body,
                             1, 0, 0, 0])
            d = d.replace(qpos=_set_rows(d.qpos, slice(qa, qa + 7), park),
                          qvel=_set_rows(d.qvel, slice(da, da + 6),
                                         np.zeros(6)))
        # restore compiled defaults so the next spawn starts clean
        if slot.geoms is not None and len(slot.geoms):
            gs = torch.as_tensor(slot.geoms, device=m.device)
            d = d.replace(
                geom_size=_set_rows(d.geom_size, gs, m.geom_size[gs]),
                geom_rbound=_set_rows(d.geom_rbound, gs, m.geom_rbound[gs]),
                geom_rgba=_set_rows(d.geom_rgba, gs, m.geom_rgba[gs]))
        bs = torch.as_tensor(slot.bodies, device=m.device)
        d = d.replace(
            body_mass=_set_rows(d.body_mass, bs, m.body_mass[bs]),
            body_inertia=_set_rows(d.body_inertia, bs, m.body_inertia[bs]),
            body_active=_set_rows(d.body_active, bs, False))
        self.d = d
        self.names.release(name)
        slot.in_use = False
        slot.public_name = ""
        return state

    # ------------------------------------------------------------------
    def hot_swap(self, new_m: Model,
                 spawnable: dict[str, list[str]] | None = None):
        """Swap to a RECOMPILED model, transplanting survivors' state
        exactly — the slow path behind runtime loading of unregistered
        assets.

        The reference mutates the live scene by save -> modify XML ->
        reload -> `add_old_state` name-matched state transplant -> swap
        the global (m, d) pointers (mj_sim.cpp:465-558,804-845); its
        spawn service uses that path to load arbitrary asset files at
        runtime (mj_ros.cpp:1340-1363).  The fast path (registered
        classes, masked slots) never rebuilds anything; this slow path
        builds the new layout's plans once, on its first step, in
        exchange for the same capability: every surviving
        joint/body/geom/actuator keeps its state BIT-exactly (host copies
        by name matching, no recompute).

        new_m: a host model is put on the current model's device and
        dtype.  `spawnable` is the full slot registry for the new model;
        occupied slots are re-claimed by their root-body name and keep
        their public names."""
        old_m, old_d = self.m, self.d
        if old_d.qpos.shape[0] != 1:
            raise ValueError("hot_swap operates on one-env Data")
        occupied = {public: old_m.names.body[slot.root_body]
                    for public, slot in self.by_public_name.items()}
        joint_inits = self._joint_inits
        dtype = old_d.qpos.dtype
        self.__init__(new_m, spawnable=spawnable, dtype=dtype,
                      device=old_m.device)
        self._joint_inits = joint_inits
        # re-claim occupied slots by root-body name (public names survive)
        root2slot = {self.m.names.body[s.root_body]: s
                     for lst in self.slots.values() for s in lst}
        for public, rootname in occupied.items():
            slot = root2slot.get(rootname)
            if slot is None:
                continue    # its class shrank away; object is gone
            slot.in_use = True
            slot.public_name = public
            self.by_public_name[public] = slot
            self.names.known.add(public)
        self.d = transplant_state(old_m, old_d, self.m, self.d)
        return self.d

    def reset(self, robot_joint_names: dict[str, list[str]] | None = None):
        """reset_robot semantics (mj_ros.cpp:569-609): robot joints to
        joint_inits (default 0), velocities/accelerations zeroed, then
        forward.  Non-robot state (spawned objects) is preserved."""
        m, d = self.m, self.d
        lay = m.layout
        qa, da, init = [], [], []
        for robot, joints in (robot_joint_names or {}).items():
            for jn in joints:
                j = m.names.joint_id(jn)
                if j < 0:
                    continue
                qa.append(int(lay.jnt_qposadr[j]))
                da.append(int(lay.jnt_dofadr[j]))
                init.append(self._joint_inits.get(jn, 0.0))
        qpos, qvel = d.qpos, d.qvel
        if qa:
            qpos = _set_rows(qpos, qa, np.asarray(init, np.float64))
            qvel = _set_rows(qvel, da, 0.0)
        d = d.replace(qpos=qpos, qvel=qvel,
                      qacc=torch.zeros_like(d.qacc),
                      time=torch.zeros_like(d.time))
        self.d = self.forward_graph(m, d)
        return self.d

    def reset_full(self):
        """Full reset to qpos0 (fresh mj_makeData equivalent)."""
        active = self.d.body_active
        self.d = engine.make_data(self.m, 1, self.d.qpos.dtype)
        self.d = self.d.replace(body_active=active)
        return self.d

    def step(self, n: int = 1):
        """n steps of the step graph from the current Data."""
        if n > 0:
            self.d = self.step_graph.run(self.m, self.d, n=n)
        return self.d
