"""Frozen copy of mujoco_sim_tpu_torch's CPU path for the benchmark's
plain reference (bench_port/refsim): imports rewritten, CUDA wrappers
and graph capture removed.  Do not import the program from here.

Scene composition: world + robots + objects -> one SpecTree.

Equivalent of MjSim::init_tmp (reference: src/mujoco_sim/mj_sim.cpp:185-457),
which composes a tmp XML <include>-ing the robot into the world, applies
pose_init, sets per-body gravcomp from disable_gravity, and injects up to 6
odom slide/hinge joints per robot (mj_sim.cpp:337-420).  Here composition is
programmatic on SpecTrees — no temp files, no reload; the result compiles
once into a padded Model.

Also provides spawn-slot pre-allocation: extra object instances compiled in
up-front and toggled by Data.body_active masks, giving the reference's
spawn/destroy contract (state of survivors preserved, no retrace;
SURVEY.md §3.3).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import numpy as np

from refsim.models import mjcf


@dataclasses.dataclass
class RobotConfig:
    """Per-robot scene options (rosparam equivalents, mj_ros.cpp:212-374)."""

    path: str                                  # MJCF (or URDF-compiled) file
    pose_init: Optional[np.ndarray] = None     # (6,) x y z r p y or (7,) +quat
    add_odom_joints: dict = dataclasses.field(default_factory=dict)
    disable_gravity: bool = False
    joint_inits: dict = dataclasses.field(default_factory=dict)


_ODOM_ORDER = [
    ("lin_odom_x_joint", "slide", np.array([1.0, 0, 0])),
    ("lin_odom_y_joint", "slide", np.array([0.0, 1, 0])),
    ("lin_odom_z_joint", "slide", np.array([0.0, 0, 1])),
    ("ang_odom_x_joint", "hinge", np.array([1.0, 0, 0])),
    ("ang_odom_y_joint", "hinge", np.array([0.0, 1, 0])),
    ("ang_odom_z_joint", "hinge", np.array([0.0, 0, 1])),
]


def _odom_flags(cfg: dict) -> dict:
    """Reference coupling rules: x needs y+yaw etc. (mj_sim.cpp:356-386)."""
    f = {k: bool(cfg.get(k, False)) for k, _, _ in _ODOM_ORDER}
    out = dict(f)
    out["lin_odom_x_joint"] = f["lin_odom_x_joint"] or (
        f["lin_odom_y_joint"] and f["ang_odom_z_joint"])
    out["lin_odom_y_joint"] = f["lin_odom_y_joint"] or (
        f["lin_odom_x_joint"] and f["ang_odom_z_joint"])
    out["lin_odom_z_joint"] = f["lin_odom_z_joint"] or (
        f["lin_odom_x_joint"] and f["ang_odom_y_joint"])
    return out


def _set_gravcomp(body: mjcf.BodySpec, value: float):
    body.gravcomp = value
    for c in body.children:
        _set_gravcomp(c, value)


def _prefix_names(spec: mjcf.SpecTree, body: mjcf.BodySpec, prefix: str):
    """Uniquify names when spawning multiple instances of one model."""
    def walk(b):
        if b.name:
            b.name = prefix + b.name
        for j in b.joints:
            if j.name:
                j.name = prefix + j.name
        for g in b.geoms:
            if g.name:
                g.name = prefix + g.name
        for s in b.sites:
            if s.name:
                s.name = prefix + s.name
        for c in b.children:
            walk(c)
    walk(body)


def _prefix_refs(spec: mjcf.SpecTree, prefix: str):
    for e in spec.equalities:
        if e.obj1:
            e.obj1 = prefix + e.obj1
        if e.obj2:
            e.obj2 = prefix + e.obj2
    spec.excludes = [(prefix + a if a else a, prefix + b if b else b)
                     for a, b in spec.excludes]
    for s in spec.sensors:
        if s.site:
            s.site = prefix + s.site
    for a in spec.actuators:
        if a.name:
            a.name = prefix + a.name
        if a.joint:
            a.joint = prefix + a.joint


def add_robot(world: mjcf.SpecTree, robot_name: str, cfg: RobotConfig,
              prefix: str = "") -> mjcf.SpecTree:
    """Merge one robot model into the world spec (in place) and return it."""
    rspec = mjcf.parse_mjcf(cfg.path)

    if prefix:
        for root in rspec.world.children:
            _prefix_names(rspec, root, prefix)
        _prefix_refs(rspec, prefix)
        for msp in rspec.meshes:
            pass  # mesh assets are shared, not per-instance

    # locate (or designate) the robot root body
    roots = rspec.world.children
    root = None
    for b in roots:
        if b.name == prefix + robot_name:
            root = b
            break
    if root is None and roots:
        root = roots[0]
    if root is None:
        raise ValueError(f"robot model {cfg.path} has no top-level body")

    # pose_init (mj_sim.cpp:312-335)
    if cfg.pose_init is not None:
        p = np.asarray(cfg.pose_init, dtype=float)
        root.pos = p[:3]
        if len(p) == 7:
            root.quat = p[3:7] / np.linalg.norm(p[3:7])
        elif len(p) == 6:
            from refsim.models.rotations import euler_to_quat
            root.quat = euler_to_quat(p[3:6], "xyz")

    # disable_gravity -> gravcomp=1 on all robot bodies (mj_sim.cpp:301-310)
    if cfg.disable_gravity:
        _set_gravcomp(root, 1.0)

    # odom joint injection (mj_sim.cpp:337-420): appended AFTER existing
    # joints of the root body, named <robot>_{lin,ang}_odom_{x,y,z}_joint
    flags = _odom_flags(cfg.add_odom_joints)
    for suffix, jtype, axis in _ODOM_ORDER:
        if flags.get(suffix, False):
            root.joints.append(mjcf.JointSpec(
                name=f"{prefix}{robot_name}_{suffix}", type=jtype,
                axis=axis.copy(), limited=False))

    # merge into world
    world.world.children.append(root)
    # merge assets with dedup by name
    existing = {msp.name for msp in world.meshes}
    for msp in rspec.meshes:
        if msp.name not in existing:
            # resolve file path relative to the robot's base dir
            import os
            msp = copy.copy(msp)
            msp.file = os.path.join(
                rspec.base_dir, rspec.compiler.meshdir, msp.file)
            world.meshes.append(msp)
            existing.add(msp.name)
    # appearance assets merge with dedup by name (shared, not per-instance)
    have_tex = {t.name for t in world.textures}
    world.textures.extend(t for t in rspec.textures
                          if t.name not in have_tex)
    have_mat = {mt.name for mt in world.materials}
    world.materials.extend(mt for mt in rspec.materials
                           if mt.name not in have_mat)
    world.equalities.extend(rspec.equalities)
    world.excludes.extend(rspec.excludes)
    world.sensors.extend(rspec.sensors)
    world.pairs.extend(rspec.pairs)
    world.actuators.extend(rspec.actuators)
    return world


def add_reference_bodies(spec: mjcf.SpecTree, body_names: list[str],
                         torquescale: float = 0.9) -> mjcf.SpecTree:
    """Create '<name>_ref' mocap twins weld-constrained to local bodies.

    The reference's multi-instance receive-side mechanism
    (MjSim::init_references, mj_sim.cpp:847-960): grey semi-transparent
    mocap clones whose poses an external instance sets; a weld equality
    (torquescale 0.9) drags the local body toward them, and contacts with
    them are excluded.  Here mocap poses are set via Data.mocap_pos/quat
    (fed by collectives in-mesh or by the server across processes).
    """
    def find(b, name):
        if b.name == name:
            return b
        for c in b.children:
            r = find(c, name)
            if r is not None:
                return r
        return None

    for name in body_names:
        target = find(spec.world, name)
        if target is None:
            raise KeyError(f"body {name} not found")
        ref = mjcf.BodySpec(name=f"{name}_ref", pos=target.pos.copy(),
                            quat=target.quat.copy(), mocap=True)
        for g in target.geoms:
            gc = copy.deepcopy(g)
            gc.name = f"{g.name}_ref" if g.name else ""
            gc.rgba = np.array([0.5, 0.5, 0.5, 0.3])
            gc.contype = 0
            gc.conaffinity = 0
            gc.density = 0.0
            gc.mass = 0.0
            ref.geoms.append(gc)
        spec.world.children.append(ref)
        eq = mjcf.EqSpec(type="weld", obj1=f"{name}_ref", obj2=name,
                         torquescale=torquescale)
        spec.equalities.append(eq)
        spec.excludes.append((f"{name}_ref", name))
    return spec


def compose(world_path: str, robots: dict[str, RobotConfig] | None = None,
            instances: int = 1) -> mjcf.SpecTree:
    """World + robots -> composed SpecTree (compile with compile_spec).

    instances > 1 pre-allocates that many copies of each robot as masked
    spawn slots (named <i>_<robot> for i >= 1, reference name-uniquing style
    mj_ros.cpp:137-187).
    """
    world = mjcf.parse_mjcf(world_path)
    # world meshdir resolution for its own meshes
    import os
    for msp in world.meshes:
        msp.file = os.path.join(world.base_dir, world.compiler.meshdir,
                                msp.file)
    world.compiler.meshdir = ""
    world.base_dir = ""
    for name, cfg in (robots or {}).items():
        for i in range(instances):
            prefix = "" if i == 0 else f"{i}_"
            add_robot(world, name, cfg, prefix=prefix)
    return world
