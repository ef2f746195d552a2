"""MJCF export: SpecTree (+ optional live state) -> XML file.

Equivalent of mj_saveLastXML as used by the reference's screenshot service
(src/mujoco_sim/mj_ros.cpp:670-777) and scene-mutation path (modify_xml,
mj_sim.cpp:573-710).  With a Data argument, free-body poses are frozen into
the XML like modify_xml does before reload (mj_sim.cpp:607-624).
"""

from __future__ import annotations

import os
import shutil
import xml.etree.ElementTree as ET

import numpy as np

from mujoco_sim_tpu_torch.models import mjcf


def _fmt(arr) -> str:
    return " ".join(f"{float(x):.17g}" for x in np.atleast_1d(arr))


def export_mjcf(spec: mjcf.SpecTree, path: str, model=None, data=None,
                copy_meshes: bool = True) -> str:
    """Write the spec as an MJCF file; meshes copied next to it.

    If (model, data) are given, top-level free bodies get their current pose
    written as body pos/quat (the screenshot snapshot is relocatable and
    resumable, reference mj_ros.cpp:721-763).
    """
    root = ET.Element("mujoco", {"model": spec.model_name})
    opt = spec.option
    ET.SubElement(root, "compiler", {
        "angle": "radian", "autolimits": "true",
        "meshdir": "assets" if copy_meshes else "",
    })
    o = ET.SubElement(root, "option", {
        "timestep": _fmt(opt.timestep),
        "gravity": _fmt(opt.gravity),
        "integrator": opt.integrator,
        "cone": opt.cone,
        "iterations": str(opt.iterations),
        "tolerance": _fmt(opt.tolerance),
    })
    if opt.energy:
        ET.SubElement(o, "flag", {"energy": "enable"})

    # live poses for top-level free bodies
    live_pose = {}
    if model is not None and data is not None:
        lay = model.layout
        from mujoco_sim_tpu_torch.models.model import JointType
        for j in range(model.njnt):
            if lay.jnt_type[j] == int(JointType.FREE):
                bid = int(lay.jnt_bodyid[j])
                qa = int(lay.jnt_qposadr[j])
                name = model.names.body[bid]
                qpos = np.asarray(data.qpos[qa:qa + 7])
                live_pose[name] = qpos

    # assets
    textures = getattr(spec, "textures", [])
    materials = getattr(spec, "materials", [])
    if spec.meshes or textures or materials:
        asset = ET.SubElement(root, "asset")
        mesh_dir = os.path.join(os.path.dirname(os.path.abspath(path)),
                                "assets")
        if copy_meshes and spec.meshes:
            os.makedirs(mesh_dir, exist_ok=True)
        for msp in spec.meshes:
            fn = os.path.basename(msp.file)
            if copy_meshes and os.path.exists(msp.file):
                shutil.copy2(msp.file, os.path.join(mesh_dir, fn))
            attrs = {"name": msp.name, "file": fn if copy_meshes else msp.file}
            if not np.allclose(msp.scale, 1.0):
                attrs["scale"] = _fmt(msp.scale)
            ET.SubElement(asset, "mesh", attrs)
        for t in textures:
            attrs = {"name": t.name, "type": t.type}
            if t.builtin != "none":
                attrs["builtin"] = t.builtin
                attrs["rgb1"] = _fmt(t.rgb1)
                attrs["rgb2"] = _fmt(t.rgb2)
            if t.file:
                attrs["file"] = t.file
            if t.width:
                attrs["width"] = str(t.width)
            if t.height:
                attrs["height"] = str(t.height)
            ET.SubElement(asset, "texture", attrs)
        for mt in materials:
            attrs = {"name": mt.name}
            if mt.texture:
                attrs["texture"] = mt.texture
            if not np.allclose(mt.texrepeat, 1.0):
                attrs["texrepeat"] = _fmt(mt.texrepeat)
            if mt.texuniform:
                attrs["texuniform"] = "true"
            if mt.reflectance:
                attrs["reflectance"] = str(mt.reflectance)
            if not np.allclose(mt.rgba, 1.0):
                attrs["rgba"] = _fmt(mt.rgba)
            ET.SubElement(asset, "material", attrs)

    wb = ET.SubElement(root, "worldbody")

    def emit_geom(parent, g: mjcf.GeomSpec):
        attrs = {"type": g.type}
        if g.name:
            attrs["name"] = g.name
        if np.any(g.pos):
            attrs["pos"] = _fmt(g.pos)
        if abs(g.quat[0] - 1.0) > 1e-12 or np.any(np.abs(g.quat[1:]) > 1e-12):
            attrs["quat"] = _fmt(g.quat)
        if g.type == "mesh":
            attrs["mesh"] = g.mesh
        else:
            attrs["size"] = _fmt(g.size[:{"plane": 3, "sphere": 1,
                                          "capsule": 2, "cylinder": 2,
                                          "box": 3, "ellipsoid": 3}
                                 .get(g.type, 3)])
        if g.condim != 3:
            attrs["condim"] = str(g.condim)
        if not np.allclose(g.friction, [1.0, 0.005, 0.0001]):
            attrs["friction"] = _fmt(g.friction)
        if g.contype != 1:
            attrs["contype"] = str(g.contype)
        if g.conaffinity != 1:
            attrs["conaffinity"] = str(g.conaffinity)
        if not np.allclose(g.rgba, [0.5, 0.5, 0.5, 1.0]):
            attrs["rgba"] = _fmt(g.rgba)
        if getattr(g, "material", ""):
            attrs["material"] = g.material
        if g.mass is not None:
            attrs["mass"] = _fmt(g.mass)
        ET.SubElement(parent, "geom", attrs)

    def emit_joint(parent, j: mjcf.JointSpec):
        if j.type == "free":
            ET.SubElement(parent, "freejoint",
                          {"name": j.name} if j.name else {})
            return
        attrs = {"type": j.type}
        if j.name:
            attrs["name"] = j.name
        if np.any(j.pos):
            attrs["pos"] = _fmt(j.pos)
        attrs["axis"] = _fmt(j.axis)
        if j.limited and np.any(j.range):
            attrs["range"] = _fmt(j.range)
        for attr, val, dflt in (("stiffness", j.stiffness, 0.0),
                                ("damping", j.damping, 0.0),
                                ("armature", j.armature, 0.0),
                                ("springref", j.springref, 0.0),
                                ("ref", j.ref, 0.0),
                                ("frictionloss", j.frictionloss, 0.0)):
            if val != dflt:
                attrs[attr] = _fmt(val)
        ET.SubElement(parent, "joint", attrs)

    def emit_body(parent, b: mjcf.BodySpec, top_level: bool):
        attrs = {}
        if b.name:
            attrs["name"] = b.name
        pos, quat = b.pos, b.quat
        if top_level and b.name in live_pose:
            qp = live_pose[b.name]
            pos, quat = qp[:3], qp[3:7]
        if np.any(pos):
            attrs["pos"] = _fmt(pos)
        if abs(quat[0] - 1.0) > 1e-12 or np.any(np.abs(quat[1:]) > 1e-12):
            attrs["quat"] = _fmt(quat)
        if b.gravcomp:
            attrs["gravcomp"] = _fmt(b.gravcomp)
        el = ET.SubElement(parent, "body", attrs)
        if b.inertial is not None:
            iat = {"pos": _fmt(b.inertial.pos), "mass": _fmt(b.inertial.mass)}
            if b.inertial.diaginertia is not None:
                iat["diaginertia"] = _fmt(b.inertial.diaginertia)
            elif b.inertial.fullinertia is not None:
                iat["fullinertia"] = _fmt(b.inertial.fullinertia)
            ET.SubElement(el, "inertial", iat)
        for j in b.joints:
            emit_joint(el, j)
        for g in b.geoms:
            emit_geom(el, g)
        for s in b.sites:
            ET.SubElement(el, "site", {"name": s.name, "pos": _fmt(s.pos)})
        for c in b.children:
            emit_body(el, c, False)

    for g in spec.world.geoms:
        emit_geom(wb, g)
    for b in spec.world.children:
        emit_body(wb, b, True)

    if spec.equalities:
        eq = ET.SubElement(root, "equality")
        for e in spec.equalities:
            if e.type == "joint":
                ET.SubElement(eq, "joint", {
                    "joint1": e.obj1, "joint2": e.obj2,
                    "polycoef": _fmt(e.data[:5])})
            elif e.type == "weld":
                ET.SubElement(eq, "weld", {
                    "body1": e.obj1, "body2": e.obj2,
                    "torquescale": _fmt(e.torquescale)})
            elif e.type == "connect":
                ET.SubElement(eq, "connect", {
                    "body1": e.obj1, "body2": e.obj2,
                    "anchor": _fmt(e.data[:3])})
            elif e.type == "tendon":
                ET.SubElement(eq, "tendon", {
                    "tendon1": e.obj1, "tendon2": e.obj2,
                    "polycoef": _fmt(e.data[:5])})
    if getattr(spec, "keys", None):
        kf = ET.SubElement(root, "keyframe")
        for k in spec.keys:
            at = {}
            if k.name:
                at["name"] = k.name
            if k.time:
                at["time"] = _fmt(k.time)
            for attr in ("qpos", "qvel", "act", "ctrl", "mpos", "mquat"):
                v = getattr(k, attr)
                if v is not None:
                    at[attr] = _fmt(v)
            ET.SubElement(kf, "key", at)
    if spec.excludes:
        contact = ET.SubElement(root, "contact")
        for b1, b2 in spec.excludes:
            ET.SubElement(contact, "exclude", {"body1": b1, "body2": b2})
    if spec.sensors:
        from mujoco_sim_tpu_torch.models.mjcf import _SENSOR_OBJ_ATTR
        sens = ET.SubElement(root, "sensor")
        for s in spec.sensors:
            attrs = {"name": s.name}
            if s.site:
                attrs["site"] = s.site
            elif s.objtype:
                attrs["objtype"] = s.objtype
                attrs["objname"] = s.objname
            elif s.objname:
                attrs[_SENSOR_OBJ_ATTR[s.type]] = s.objname
            if s.cutoff:
                attrs["cutoff"] = _fmt(s.cutoff)
            ET.SubElement(sens, s.type, attrs)
    if spec.tendons:
        ten_el = ET.SubElement(root, "tendon")
        for t in spec.tendons:
            attrs = {"name": t.name, "stiffness": _fmt(t.stiffness),
                     "damping": _fmt(t.damping), "margin": _fmt(t.margin)}
            if t.limited:
                attrs["limited"] = "true"
                attrs["range"] = _fmt(t.range)
                attrs["solreflimit"] = _fmt(t.solref_limit)
                attrs["solimplimit"] = _fmt(t.solimp_limit)
            if t.springlength is not None:
                attrs["springlength"] = _fmt(t.springlength)
            tag = "spatial" if t.path else "fixed"
            fx = ET.SubElement(ten_el, tag, attrs)
            for jn, coef in t.joints:
                ET.SubElement(fx, "joint", {"joint": jn, "coef": _fmt(coef)})
            for el in t.path:
                if el[0] == "site":
                    ET.SubElement(fx, "site", {"site": el[1]})
                elif el[0] == "geom":
                    g_at = {"geom": el[1]}
                    if el[2]:
                        g_at["sidesite"] = el[2]
                    ET.SubElement(fx, "geom", g_at)
                else:
                    ET.SubElement(fx, "pulley", {"divisor": _fmt(el[1])})
    if spec.actuators:
        # written back in the normalized <general> form (parse re-reads it)
        act_el = ET.SubElement(root, "actuator")
        for a in spec.actuators:
            attrs = {"name": a.name, "gear": _fmt(a.gear),
                     "dyntype": a.dyntype, "gaintype": a.gaintype,
                     "biastype": a.biastype, "dynprm": _fmt(a.dynprm),
                     "gainprm": _fmt(a.gainprm), "biasprm": _fmt(a.biasprm)}
            if a.tendon:
                attrs["tendon"] = a.tendon
            elif a.site:
                attrs["site"] = a.site
                if a.refsite:
                    attrs["refsite"] = a.refsite
            else:
                attrs["joint"] = a.joint
            if a.ctrllimited:
                attrs["ctrllimited"] = "true"
                attrs["ctrlrange"] = _fmt(a.ctrlrange)
            if a.forcelimited:
                attrs["forcelimited"] = "true"
                attrs["forcerange"] = _fmt(a.forcerange)
            ET.SubElement(act_el, "general", attrs)

    ET.indent(root)
    tree = ET.ElementTree(root)
    tree.write(path, xml_declaration=True, encoding="unicode")
    return path


def print_model_txt(model, path: str):
    """Human-readable model dump (mj_printModel equivalent; the USD exporter
    consumes the reference's version, script/mujoco_to_usd.py:126-143)."""
    with open(path, "w") as f:
        f.write(f"MODEL {model.names.body[1] if model.nbody > 1 else 'scene'}\n")
        f.write(f"nq {model.nq}\nnv {model.nv}\nnbody {model.nbody}\n"
                f"njnt {model.njnt}\nngeom {model.ngeom}\n\n")
        f.write("BODY id name parent mass pos\n")
        for i in range(model.nbody):
            f.write(f"{i} {model.names.body[i]} "
                    f"{int(model.layout.body_parentid[i])} "
                    f"{float(model.body_mass[i]):.6g} "
                    f"{_fmt(model.body_pos[i])}\n")
        f.write("\nJOINT id name type body qposadr dofadr\n")
        for j in range(model.njnt):
            f.write(f"{j} {model.names.joint[j]} "
                    f"{int(model.layout.jnt_type[j])} "
                    f"{int(model.layout.jnt_bodyid[j])} "
                    f"{int(model.layout.jnt_qposadr[j])} "
                    f"{int(model.layout.jnt_dofadr[j])}\n")


def print_data_txt(model, data, path: str):
    """State dump (mj_printData equivalent; feeds the USD exporter like the
    reference's <name>_data.txt, script/mujoco_to_usd.py:391-399)."""
    with open(path, "w") as f:
        f.write(f"TIME {float(data.time):.17g}\n\n")
        f.write("QPOS\n" + _fmt(np.asarray(data.qpos)) + "\n\n")
        f.write("QVEL\n" + _fmt(np.asarray(data.qvel)) + "\n\n")
        f.write("XPOS\n")
        for i in range(model.nbody):
            f.write(_fmt(np.asarray(data.xpos[i])) + "\n")
        f.write("\nXQUAT\n")
        for i in range(model.nbody):
            f.write(_fmt(np.asarray(data.xquat[i])) + "\n")
