"""URDF importer: URDF -> SpecTree (the mujoco_compile equivalent).

Replicates the reference's offline URDF->MJCF compiler semantics
(src/mujoco_compile.cpp): compiler bounds (boundmass/boundinertia 1e-6,
balanceinertia), discarded visuals, mesh path resolution with package://
stripping (load_urdf, :317-399), robot-body wrapping (add_robot_body,
:195-217), mimic -> equality polycoef (add_mimic_joints, :219-248), and
parent-child collision excludes to a configurable level
(disable_parent_child_collision, :250-314).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from mujoco_sim_tpu_torch.models import mjcf
from mujoco_sim_tpu_torch.models.rotations import euler_to_quat

_JOINT_MAP = {"revolute": "hinge", "continuous": "hinge",
              "prismatic": "slide", "floating": "free", "fixed": None}


def _origin(el) -> tuple[np.ndarray, np.ndarray]:
    if el is None:
        return np.zeros(3), np.array([1.0, 0, 0, 0])
    xyz = np.array([float(x) for x in el.get("xyz", "0 0 0").split()])
    rpy = np.array([float(x) for x in el.get("rpy", "0 0 0").split()])
    return xyz, euler_to_quat(rpy, "xyz")


def _strip_package(fn: str) -> str:
    if fn.startswith("package://"):
        fn = fn[len("package://"):]
    return fn


def load_urdf(path: str, collision_level: int = 1,
              mesh_dir: str | None = None,
              discard_visual: bool = True) -> mjcf.SpecTree:
    """Parse a URDF into a SpecTree ready for compile_spec."""
    tree = ET.parse(path)
    robot = tree.getroot()
    assert robot.tag == "robot", f"not a URDF: {path}"
    robot_name = robot.get("name", "robot")
    base_dir = os.path.dirname(os.path.abspath(path))
    mesh_dir = mesh_dir or base_dir

    spec = mjcf.SpecTree(base_dir="")
    spec.model_name = robot_name
    spec.compiler.angle = "radian"
    spec.compiler.boundmass = 1e-6
    spec.compiler.boundinertia = 1e-6
    spec.compiler.balanceinertia = True
    spec.compiler.meshdir = ""

    # ---- links
    links = {}
    for link in robot.findall("link"):
        links[link.get("name")] = link

    # ---- joints -> tree edges
    joints = robot.findall("joint")
    child_of = {}
    for j in joints:
        parent = j.find("parent").get("link")
        child = j.find("child").get("link")
        child_of[child] = j
    roots = [name for name in links if name not in child_of]
    if len(roots) != 1:
        raise ValueError(f"URDF must have exactly one root link, got {roots}")

    mesh_registry = {}

    def add_mesh(filename: str, scale: np.ndarray) -> str:
        fn = _strip_package(filename)
        base = os.path.basename(fn)
        name = os.path.splitext(base)[0]
        if name not in mesh_registry:
            # resolution order mirrors the reference's copy-to-stl dir:
            # exact path, mesh_dir/basename, base_dir/relative
            for cand in (fn, os.path.join(mesh_dir, base),
                         os.path.join(base_dir, fn)):
                if os.path.exists(cand):
                    spec.meshes.append(mjcf.MeshSpec(
                        name=name, file=os.path.abspath(cand), scale=scale))
                    mesh_registry[name] = True
                    break
            else:
                raise FileNotFoundError(f"mesh {filename} for {path}")
        return name

    def geom_from(geom_el, origin_el, group: int) -> mjcf.GeomSpec | None:
        g = mjcf.GeomSpec()
        g.pos, g.quat = _origin(origin_el)
        shape = geom_el[0]
        if shape.tag == "box":
            g.type = "box"
            size = np.array([float(x) for x in shape.get("size").split()])
            g.size = size / 2.0
        elif shape.tag == "cylinder":
            g.type = "cylinder"
            r = float(shape.get("radius"))
            l = float(shape.get("length"))
            g.size = np.array([r, l / 2.0, 0.0])
        elif shape.tag == "sphere":
            g.type = "sphere"
            g.size = np.array([float(shape.get("radius")), 0.0, 0.0])
        elif shape.tag == "mesh":
            g.type = "mesh"
            scale = np.array([float(x) for x in
                              shape.get("scale", "1 1 1").split()])
            g.mesh = add_mesh(shape.get("filename"), scale)
        else:
            return None
        g.group = group
        return g

    def make_body(link_name: str) -> mjcf.BodySpec:
        link = links[link_name]
        b = mjcf.BodySpec(name=link_name)
        ine = link.find("inertial")
        if ine is not None:
            ispec = mjcf.InertialSpec()
            ispec.pos, ispec.quat = _origin(ine.find("origin"))
            mass_el = ine.find("mass")
            ispec.mass = float(mass_el.get("value")) if mass_el is not None else 0.0
            it = ine.find("inertia")
            if it is not None:
                ispec.fullinertia = np.array([
                    float(it.get("ixx", 0)), float(it.get("iyy", 0)),
                    float(it.get("izz", 0)), float(it.get("ixy", 0)),
                    float(it.get("ixz", 0)), float(it.get("iyz", 0))])
            b.inertial = ispec
        for col in link.findall("collision"):
            g = geom_from(col.find("geometry"), col.find("origin"), group=0)
            if g is not None:
                b.geoms.append(g)
        if not discard_visual:
            for vis in link.findall("visual"):
                g = geom_from(vis.find("geometry"), vis.find("origin"),
                              group=1)
                if g is not None:
                    g.contype = 0
                    g.conaffinity = 0
                    g.density = 0.0
                    g.mass = 0.0
                    b.geoms.append(g)
        # children
        for j in joints:
            if j.find("parent").get("link") != link_name:
                continue
            child_name = j.find("child").get("link")
            cb = make_body(child_name)
            cb.pos, cb.quat = _origin(j.find("origin"))
            jtype = _JOINT_MAP.get(j.get("type"))
            if jtype is not None:
                js = mjcf.JointSpec(name=j.get("name"), type=jtype)
                axis_el = j.find("axis")
                if axis_el is not None and jtype in ("hinge", "slide"):
                    ax = np.array([float(x) for x in
                                   axis_el.get("xyz").split()])
                    js.axis = ax / np.linalg.norm(ax)
                lim = j.find("limit")
                if (lim is not None and j.get("type") in
                        ("revolute", "prismatic")):
                    lo = float(lim.get("lower", 0.0))
                    hi = float(lim.get("upper", 0.0))
                    js.range = np.array([lo, hi])
                    js.limited = True
                else:
                    js.limited = False
                dyn = j.find("dynamics")
                if dyn is not None:
                    js.damping = float(dyn.get("damping", 0.0))
                    js.frictionloss = float(dyn.get("friction", 0.0))
                cb.joints.insert(0, js)
            b.children.append(cb)
        return b

    root_body = make_body(roots[0])

    # robot-body wrapping (add_robot_body): MuJoCo's URDF path fuses the
    # root link into the world, so its geoms land directly in the wrapper
    # body (cf. pr2.xml base geoms inside <body name="pr2">); the root
    # link's explicit inertial is discarded and recomputed from geoms.
    wrapper = mjcf.BodySpec(name=robot_name)
    wrapper.geoms = root_body.geoms
    wrapper.children = root_body.children
    spec.world.children.append(wrapper)

    # mimic joints -> equality polycoef (add_mimic_joints)
    for j in joints:
        mimic = j.find("mimic")
        if mimic is not None:
            e = mjcf.EqSpec(type="joint")
            e.obj1 = j.get("name")
            e.obj2 = mimic.get("joint")
            offset = float(mimic.get("offset", 0.0))
            mult = float(mimic.get("multiplier", 1.0))
            e.data[:5] = [offset, mult, 0.0, 0.0, 0.0]
            spec.equalities.append(e)

    # parent-child collision excludes (disable_parent_child_collision)
    name_parent = {}
    def record_parents(b, parent_name):
        name_parent[b.name] = parent_name
        for c in b.children:
            record_parents(c, b.name)
    for c in wrapper.children:
        record_parents(c, robot_name)
    body_names = list(name_parent.keys())
    if collision_level >= 0:
        for bn in body_names:
            cur = bn
            for _ in range(collision_level):
                cur = name_parent.get(cur)
                if cur is None:
                    break
                spec.excludes.append((cur, bn))
                if cur == robot_name:
                    break
    else:
        allb = [robot_name] + body_names
        for i in range(len(allb)):
            for k in range(i + 1, len(allb)):
                spec.excludes.append((allb[i], allb[k]))

    return spec


def compile_urdf(path: str, collision_level: int = 1, **kw):
    """URDF -> compiled Model (the mujoco_compile_node CLI equivalent)."""
    from mujoco_sim_tpu_torch.models.compile import compile_spec
    from mujoco_sim_tpu_torch.engine import set_const

    return set_const(compile_spec(
        load_urdf(path, collision_level=collision_level, **kw)))
