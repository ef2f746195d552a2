"""Frozen copy of mujoco_sim_tpu_torch's CPU path for the benchmark's
plain reference (bench_port/refsim): imports rewritten, CUDA wrappers
and graph capture removed.  Do not import the program from here.

MJCF parser: XML -> intermediate SpecTree (host side, pure Python).

Our own parser for the MJCF subset exercised by the reference model set
(reference loads MJCF via mj_loadXML, include/mujoco_sim/mj_util.h:185-193;
scene composition writes <include>-based files, src/mujoco_sim/mj_sim.cpp:185-457).

Supported: compiler settings (angle/meshdir/autolimits/eulerseq/boundmass/
boundinertia/balanceinertia), option+flags, defaults classes, nested bodies,
all four joint types, primitive+mesh geoms, sites, inertial, equality
(joint/weld/connect), contact excludes/pairs, force/torque sensors,
multiple <worldbody> blocks, <include> files.
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np


# ---------------------------------------------------------------------------
# Intermediate spec dataclasses (mutable, host-only)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JointSpec:
    name: str = ""
    type: str = "hinge"
    pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    axis: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.0, 0.0, 1.0]))
    range: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2))
    limited: Optional[bool] = None  # None = auto
    stiffness: float = 0.0
    springref: float = 0.0
    ref: float = 0.0
    damping: float = 0.0
    armature: float = 0.0
    frictionloss: float = 0.0
    margin: float = 0.0
    solref_limit: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.02, 1.0]))
    solimp_limit: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.9, 0.95, 0.001, 0.5, 2.0]))


@dataclasses.dataclass
class GeomSpec:
    name: str = ""
    type: str = "sphere"
    pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    quat: np.ndarray = dataclasses.field(default_factory=lambda: np.array([1.0, 0, 0, 0]))
    size: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    density: float = 1000.0
    mass: Optional[float] = None
    friction: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 0.005, 0.0001]))
    contype: int = 1
    conaffinity: int = 1
    condim: int = 3
    priority: int = 0
    solmix: float = 1.0
    solref: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.02, 1.0]))
    solimp: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.9, 0.95, 0.001, 0.5, 2.0]))
    margin: float = 0.0
    gap: float = 0.0
    rgba: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.5, 0.5, 0.5, 1.0]))
    mesh: str = ""
    hfield: str = ""
    material: str = ""
    group: int = 0


@dataclasses.dataclass
class SiteSpec:
    name: str = ""
    pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    quat: np.ndarray = dataclasses.field(default_factory=lambda: np.array([1.0, 0, 0, 0]))
    type: str = "sphere"        # touch-sensor zone shape
    size: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.005, 0.005, 0.005]))


@dataclasses.dataclass
class InertialSpec:
    pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    quat: np.ndarray = dataclasses.field(default_factory=lambda: np.array([1.0, 0, 0, 0]))
    mass: float = 0.0
    diaginertia: Optional[np.ndarray] = None
    fullinertia: Optional[np.ndarray] = None  # (ixx iyy izz ixy ixz iyz)


@dataclasses.dataclass
class BodySpec:
    name: str = ""
    pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    quat: np.ndarray = dataclasses.field(default_factory=lambda: np.array([1.0, 0, 0, 0]))
    gravcomp: float = 0.0
    mocap: bool = False
    inertial: Optional[InertialSpec] = None
    joints: list = dataclasses.field(default_factory=list)
    geoms: list = dataclasses.field(default_factory=list)
    sites: list = dataclasses.field(default_factory=list)
    children: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class MeshSpec:
    name: str = ""
    file: str = ""
    scale: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3))
    vertex: np.ndarray | None = None    # inline <mesh vertex="..."/> data


@dataclasses.dataclass
class TextureSpec:
    """<asset><texture>: file-backed or builtin (checker/gradient/flat)."""

    name: str = ""
    type: str = "cube"
    builtin: str = "none"
    file: str = ""
    rgb1: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.8, 0.8, 0.8]))
    rgb2: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.5, 0.5, 0.5]))
    width: int = 0
    height: int = 0


@dataclasses.dataclass
class MaterialSpec:
    """<asset><material>: appearance bound to geoms via material=."""

    name: str = ""
    texture: str = ""
    texrepeat: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(2))
    texuniform: bool = False
    emission: float = 0.0
    specular: float = 0.5
    shininess: float = 0.5
    reflectance: float = 0.0
    rgba: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(4))


@dataclasses.dataclass
class EqSpec:
    type: str = "joint"         # connect | weld | joint
    name: str = ""
    obj1: str = ""
    obj2: str = ""
    active: bool = True
    data: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(11))
    solref: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.02, 1.0]))
    solimp: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.9, 0.95, 0.001, 0.5, 2.0]))
    torquescale: float = 1.0


# sensor tag -> the attribute naming its target object (shared by the
# parser and the MJCF exporter)
_SITE_SENSORS = ("touch", "accelerometer", "velocimeter", "gyro",
                 "force", "torque", "magnetometer", "rangefinder")
_SENSOR_OBJ_ATTR = {"jointpos": "joint", "jointvel": "joint",
                    "ballquat": "joint", "ballangvel": "joint",
                    "jointlimitpos": "joint", "jointlimitvel": "joint",
                    "jointlimitfrc": "joint",
                    "tendonlimitpos": "tendon",
                    "tendonlimitvel": "tendon",
                    "tendonlimitfrc": "tendon",
                    "tendonpos": "tendon", "tendonvel": "tendon",
                    "actuatorpos": "actuator", "actuatorvel": "actuator",
                    "actuatorfrc": "actuator",
                    "subtreecom": "body", "subtreelinvel": "body",
                    "subtreeangmom": "body"}
_FRAME_SENSORS = ("framepos", "framequat", "framexaxis", "frameyaxis",
                  "framezaxis", "framelinvel", "frameangvel")


@dataclasses.dataclass
class SensorSpec:
    type: str = "force"
    name: str = ""
    site: str = ""
    objtype: str = ""           # frame sensors: site|body|xbody|geom
    objname: str = ""           # joint/tendon/actuator/body/frame target
    reftype: str = ""           # frame sensors: relative-frame object
    refname: str = ""
    cutoff: float = 0.0


@dataclasses.dataclass
class ActuatorSpec:
    """One <actuator> child, normalized to the general form.

    Shortcuts (motor/position/velocity/damper) are canonicalized at parse
    into gain/bias/dyn type+prm, the same normalization the reference's
    libmujoco compiler performs on mjcf shortcuts.
    """

    name: str = ""
    joint: str = ""             # joint transmission target
    site: str = ""              # site transmission target (exclusive w/ joint)
    refsite: str = ""           # optional reference site (site transmission)
    tendon: str = ""            # tendon transmission target
    gear: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 0, 0, 0, 0, 0]))
    ctrllimited: bool = False
    ctrlrange: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(2))
    forcelimited: bool = False
    forcerange: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(2))
    actlimited: bool = False
    actrange: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(2))
    dyntype: str = "none"       # none | integrator | filter(exact) | muscle
    gaintype: str = "fixed"     # fixed | affine | muscle
    biastype: str = "none"      # none | affine | muscle
    dynprm: np.ndarray = dataclasses.field(
        default_factory=lambda: np.pad(np.array([1.0]), (0, 9)))
    gainprm: np.ndarray = dataclasses.field(
        default_factory=lambda: np.pad(np.array([1.0]), (0, 9)))
    biasprm: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(10))
    lengthrange: np.ndarray | None = None   # muscle operating length range


@dataclasses.dataclass
class HFieldSpec:
    """<asset><hfield>: elevation grid terrain.

    data is stored row 0 = SOUTH (min y) after flipping the XML's
    north-first row order, normalized to [0,1] min-max — both probed vs
    mjModel.hfield_data.  size = (rx, ry, ztop, zbottom)."""

    name: str = ""
    nrow: int = 0
    ncol: int = 0
    size: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(4))
    data: np.ndarray | None = None    # (nrow, ncol)


@dataclasses.dataclass
class TendonSpec:
    """One <tendon> child.

    fixed: a static linear combination of scalar joint positions
    (length = sum coef_i * qpos_i).  spatial: a site path with optional
    sphere/cylinder wrap geoms (+sidesite) and pulley branch dividers,
    stored in document order in `path` as ("site", name) /
    ("geom", name, sidesite) / ("pulley", divisor)."""

    name: str = ""
    joints: list = dataclasses.field(default_factory=list)  # [(jname, coef)]
    sites: list = dataclasses.field(default_factory=list)   # sites (legacy)
    path: list = dataclasses.field(default_factory=list)    # spatial path
    limited: bool = False
    range: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(2))
    solref_limit: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.02, 1.0]))
    solimp_limit: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.9, 0.95, 0.001, 0.5, 2.0]))
    stiffness: float = 0.0
    damping: float = 0.0
    springlength: np.ndarray | None = None  # None -> length at qpos0
    margin: float = 0.0


@dataclasses.dataclass
class OptionSpec:
    timestep: float = 0.002
    gravity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, -9.81]))
    wind: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    magnetic: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, -0.5, 0.0]))
    density: float = 0.0
    viscosity: float = 0.0
    impratio: float = 1.0
    integrator: str = "Euler"
    cone: str = "pyramidal"
    solver: str = "Newton"
    iterations: int = 100
    ls_iterations: int = 50
    ls_tolerance: float = 0.01
    tolerance: float = 1e-8
    noslip_iterations: int = 0
    noslip_tolerance: float = 1e-6
    o_margin: float = 0.0
    o_solref: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.02, 1.0]))
    o_solimp: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.9, 0.95, 0.001, 0.5, 2.0]))
    disableflags: int = 0
    energy: bool = False
    override_contacts: bool = False


@dataclasses.dataclass
class CompilerSpec:
    angle: str = "degree"
    eulerseq: str = "xyz"
    meshdir: str = ""
    autolimits: bool = True
    boundmass: float = 0.0
    boundinertia: float = 0.0
    balanceinertia: bool = False
    inertiafromgeom: str = "auto"


@dataclasses.dataclass
class KeySpec:
    """<keyframe><key>: a named restorable state snapshot."""

    name: str = ""
    time: float = 0.0
    qpos: np.ndarray | None = None
    qvel: np.ndarray | None = None
    act: np.ndarray | None = None
    ctrl: np.ndarray | None = None
    mpos: np.ndarray | None = None
    mquat: np.ndarray | None = None


@dataclasses.dataclass
class SpecTree:
    """Full parsed model, pre-compilation."""

    model_name: str = "MuJoCo Model"
    compiler: CompilerSpec = dataclasses.field(default_factory=CompilerSpec)
    option: OptionSpec = dataclasses.field(default_factory=OptionSpec)
    world: BodySpec = dataclasses.field(default_factory=lambda: BodySpec(name="world"))
    meshes: list = dataclasses.field(default_factory=list)
    textures: list = dataclasses.field(default_factory=list)
    materials: list = dataclasses.field(default_factory=list)
    hfields: list = dataclasses.field(default_factory=list)
    keys: list = dataclasses.field(default_factory=list)
    equalities: list = dataclasses.field(default_factory=list)
    excludes: list = dataclasses.field(default_factory=list)   # (body1, body2)
    pairs: list = dataclasses.field(default_factory=list)      # explicit geom pairs
    sensors: list = dataclasses.field(default_factory=list)
    actuators: list = dataclasses.field(default_factory=list)
    tendons: list = dataclasses.field(default_factory=list)
    base_dir: str = ""
    nconmax: int = -1          # <size nconmax>: contact-slot capacity bound


# ---------------------------------------------------------------------------
# Attribute helpers
# ---------------------------------------------------------------------------

def _floats(s: str) -> np.ndarray:
    return np.array([float(x) for x in s.split()])


def _get_f(el, name, default=None):
    v = el.get(name)
    return float(v) if v is not None else default


def _get_v(el, name, default=None):
    v = el.get(name)
    return _floats(v) if v is not None else default


def _get_b(el, name, default=None):
    v = el.get(name)
    if v is None:
        return default
    return v.lower() in ("true", "1")


def _quat_from_attrs(el, angle_mode: str, eulerseq: str) -> np.ndarray:
    """Resolve MJCF orientation attributes to a quaternion (w,x,y,z)."""
    from refsim.models import rotations as R

    deg = angle_mode == "degree"
    if el.get("quat") is not None:
        q = _floats(el.get("quat"))
        return q / np.linalg.norm(q)
    if el.get("euler") is not None:
        e = _floats(el.get("euler"))
        if deg:
            e = np.deg2rad(e)
        return R.euler_to_quat(e, eulerseq)
    if el.get("axisangle") is not None:
        aa = _floats(el.get("axisangle"))
        axis = aa[:3] / np.linalg.norm(aa[:3])
        ang = np.deg2rad(aa[3]) if deg else aa[3]
        return R.axis_angle_quat(axis, ang)
    if el.get("zaxis") is not None:
        z = _floats(el.get("zaxis"))
        return R.zaxis_to_quat(z)
    if el.get("xyaxes") is not None:
        xy = _floats(el.get("xyaxes"))
        return R.xyaxes_to_quat(xy[:3], xy[3:])
    return np.array([1.0, 0.0, 0.0, 0.0])


# ---------------------------------------------------------------------------
# Defaults handling
# ---------------------------------------------------------------------------

class _Defaults:
    """A resolved default class: dict of tag -> dict of attr -> string."""

    def __init__(self, parent=None):
        self.attrs = {t: dict(parent.attrs[t]) if parent else {}
                      for t in ("joint", "geom", "site", "mesh", "equality", "freejoint")}
        self.children = {}

    def update_from(self, el):
        for child in el:
            if child.tag in self.attrs:
                self.attrs[child.tag].update(child.attrib)


def _parse_defaults(root) -> dict:
    classes = {"main": _Defaults()}

    def recurse(el, parent: _Defaults):
        d = _Defaults(parent)
        d.update_from(el)
        name = el.get("class", "main")
        classes[name] = d
        for sub in el.findall("default"):
            recurse(sub, d)

    for el in root.findall("default"):
        recurse(el, classes["main"])
    return classes


def _with_defaults(el, defaults: dict, cls: str, childclass: str):
    """Return a merged attribute view of element `el` of its tag's defaults."""
    klass = el.get("class", childclass or cls)
    d = defaults.get(klass, defaults["main"])
    merged = dict(d.attrs.get(el.tag, {}))
    merged.update(el.attrib)
    fake = ET.Element(el.tag, merged)
    return fake


# ---------------------------------------------------------------------------
# Main parse
# ---------------------------------------------------------------------------

def _resolve_includes(root: ET.Element, base_dir: str) -> ET.Element:
    """Inline <include file=.../> elements (recursive), MuJoCo-style."""
    def process(parent):
        i = 0
        while i < len(parent):
            child = parent[i]
            if child.tag == "include":
                path = os.path.join(base_dir, child.get("file"))
                sub = ET.parse(path).getroot()
                # splice children of the included <mujoco> (or raw) root
                items = list(sub) if sub.tag == "mujoco" else [sub]
                parent.remove(child)
                for j, item in enumerate(items):
                    parent.insert(i + j, item)
            else:
                process(child)
                i += 1
    process(root)
    return root


def parse_mjcf(path: str) -> SpecTree:
    base_dir = os.path.dirname(os.path.abspath(path))
    root = ET.parse(path).getroot()
    root = _resolve_includes(root, base_dir)
    return parse_mjcf_tree(root, base_dir)


def parse_mjcf_string(xml: str, base_dir: str = ".") -> SpecTree:
    root = ET.fromstring(xml)
    root = _resolve_includes(root, base_dir)
    return parse_mjcf_tree(root, base_dir)


def parse_mjcf_tree(root: ET.Element, base_dir: str) -> SpecTree:
    from refsim.models import rotations as R

    spec = SpecTree(base_dir=base_dir)
    spec.model_name = root.get("model", "MuJoCo Model")

    # -- compiler
    comp = spec.compiler
    for el in root.findall("compiler"):
        comp.angle = el.get("angle", comp.angle)
        comp.eulerseq = el.get("eulerseq", comp.eulerseq)
        comp.meshdir = el.get("meshdir", comp.meshdir)
        comp.autolimits = _get_b(el, "autolimits", comp.autolimits)
        comp.boundmass = _get_f(el, "boundmass", comp.boundmass)
        comp.boundinertia = _get_f(el, "boundinertia", comp.boundinertia)
        comp.balanceinertia = _get_b(el, "balanceinertia", comp.balanceinertia)
        comp.inertiafromgeom = el.get("inertiafromgeom", comp.inertiafromgeom)

    # -- size (legacy capacity bounds; mujoco accepts the attribute and
    # our compiler uses it as the top-K contact-slot budget — the analogue
    # of tuning nconmax for a scene's realistic contact count)
    for el in root.findall("size"):
        spec.nconmax = int(float(el.get("nconmax", spec.nconmax)))

    # -- option
    opt = spec.option
    for el in root.findall("option"):
        opt.timestep = _get_f(el, "timestep", opt.timestep)
        g = _get_v(el, "gravity")
        if g is not None:
            opt.gravity = g
        w = _get_v(el, "wind")
        if w is not None:
            opt.wind = w
        mg = _get_v(el, "magnetic")
        if mg is not None:
            opt.magnetic = mg
        opt.density = _get_f(el, "density", opt.density)
        opt.viscosity = _get_f(el, "viscosity", opt.viscosity)
        opt.impratio = _get_f(el, "impratio", opt.impratio)
        opt.integrator = el.get("integrator", opt.integrator)
        opt.cone = el.get("cone", opt.cone)
        opt.solver = el.get("solver", opt.solver)
        opt.iterations = int(_get_f(el, "iterations", opt.iterations))
        opt.ls_iterations = int(_get_f(el, "ls_iterations", opt.ls_iterations))
        opt.ls_tolerance = _get_f(el, "ls_tolerance", opt.ls_tolerance)
        opt.tolerance = _get_f(el, "tolerance", opt.tolerance)
        opt.noslip_iterations = int(_get_f(el, "noslip_iterations",
                                           opt.noslip_iterations))
        opt.noslip_tolerance = _get_f(el, "noslip_tolerance",
                                      opt.noslip_tolerance)
        opt.o_margin = _get_f(el, "o_margin", opt.o_margin)
        osr = _get_v(el, "o_solref", None)
        if osr is not None:
            opt.o_solref = osr[:2]
        osi = _get_v(el, "o_solimp", None)
        if osi is not None:
            opt.o_solimp = osi[:5]
        for fl in el.findall("flag"):
            from refsim.models.model import DisableBit
            flag_bits = {
                "constraint": DisableBit.CONSTRAINT,
                "equality": DisableBit.EQUALITY,
                "frictionloss": DisableBit.FRICTIONLOSS,
                "limit": DisableBit.LIMIT,
                "contact": DisableBit.CONTACT,
                "passive": DisableBit.PASSIVE,
                "gravity": DisableBit.GRAVITY,
                "warmstart": DisableBit.WARMSTART,
            }
            for attr, bit in flag_bits.items():
                v = fl.get(attr)
                if v == "disable":
                    opt.disableflags |= int(bit)
            if fl.get("energy") == "enable":
                opt.energy = True
            if fl.get("override") == "enable":
                opt.override_contacts = True

    defaults = _parse_defaults(root)

    # -- assets
    for asset in root.findall("asset"):
        for el in asset.findall("mesh"):
            el = _with_defaults(el, defaults, "main", "")
            name = el.get("name") or os.path.splitext(
                os.path.basename(el.get("file", "")))[0]
            scale = _get_v(el, "scale", np.ones(3))
            vertex = None
            if el.get("vertex"):
                vertex = np.fromstring(el.get("vertex"),
                                       sep=" ").reshape(-1, 3)
            spec.meshes.append(MeshSpec(name=name, file=el.get("file", ""),
                                        scale=scale, vertex=vertex))
        for el in asset.findall("texture"):
            spec.textures.append(TextureSpec(
                name=el.get("name") or el.get("type", ""),
                type=el.get("type", "cube"),
                builtin=el.get("builtin", "none"),
                file=el.get("file", ""),
                rgb1=_get_v(el, "rgb1", np.array([0.8, 0.8, 0.8])),
                rgb2=_get_v(el, "rgb2", np.array([0.5, 0.5, 0.5])),
                width=int(_get_f(el, "width", 0)),
                height=int(_get_f(el, "height", 0))))
        for el in asset.findall("material"):
            spec.materials.append(MaterialSpec(
                name=el.get("name", ""),
                texture=el.get("texture", ""),
                texrepeat=_get_v(el, "texrepeat", np.ones(2)),
                texuniform=_get_b(el, "texuniform", False),
                emission=_get_f(el, "emission", 0.0),
                specular=_get_f(el, "specular", 0.5),
                shininess=_get_f(el, "shininess", 0.5),
                reflectance=_get_f(el, "reflectance", 0.0),
                rgba=_get_v(el, "rgba", np.ones(4))))
        for el in asset.findall("hfield"):
            hf = HFieldSpec(name=el.get("name", ""))
            hf.size = _get_v(el, "size", np.ones(4))[:4]
            if el.get("elevation"):
                vals = np.fromstring(el.get("elevation"), sep=" ")
                hf.nrow = int(_get_f(el, "nrow", 0))
                hf.ncol = int(_get_f(el, "ncol", 0))
                if hf.nrow * hf.ncol != len(vals):
                    raise ValueError(
                        f"hfield '{hf.name}': elevation has {len(vals)} "
                        f"values, expected nrow*ncol = {hf.nrow*hf.ncol}")
                grid = vals.reshape(hf.nrow, hf.ncol)
            elif el.get("file"):
                import matplotlib.image as mpimg
                img = mpimg.imread(os.path.join(base_dir,
                                                el.get("file")))
                if img.ndim == 3:
                    img = img[..., :3].mean(-1)
                grid = np.asarray(img, float)
                hf.nrow, hf.ncol = grid.shape
            else:
                raise ValueError(f"hfield '{hf.name}' needs elevation= "
                                 "or file= data")
            # XML rows are north-first; storage is south-first, min-max
            # normalized (probed vs mjModel.hfield_data)
            grid = np.flipud(grid)
            lo, hi = grid.min(), grid.max()
            hf.data = ((grid - lo) / (hi - lo) if hi > lo
                       else np.zeros_like(grid))
            spec.hfields.append(hf)

    deg = comp.angle

    def parse_joint(el, childclass) -> JointSpec:
        el = _with_defaults(el, defaults, "main", childclass)
        j = JointSpec()
        j.name = el.get("name", "")
        j.type = el.get("type", "hinge")
        j.pos = _get_v(el, "pos", j.pos)
        axis = _get_v(el, "axis", j.axis)
        j.axis = axis / np.linalg.norm(axis)
        rng = _get_v(el, "range", j.range)
        if deg == "degree" and j.type in ("hinge", "ball"):
            rng = np.deg2rad(rng)
        j.range = rng
        limited = _get_b(el, "limited", None)
        if limited is None:
            j.limited = bool(comp.autolimits and el.get("range") is not None
                             and np.any(j.range != 0))
        else:
            j.limited = limited
        j.stiffness = _get_f(el, "stiffness", j.stiffness)
        springref = _get_f(el, "springref", j.springref)
        ref = _get_f(el, "ref", j.ref)
        if deg == "degree" and j.type == "hinge":
            springref = np.deg2rad(springref)
            ref = np.deg2rad(ref)
        j.springref = springref
        j.ref = ref
        j.damping = _get_f(el, "damping", j.damping)
        j.armature = _get_f(el, "armature", j.armature)
        j.frictionloss = _get_f(el, "frictionloss", j.frictionloss)
        j.margin = _get_f(el, "margin", j.margin)
        sr = _get_v(el, "solreflimit", None)
        if sr is not None:
            j.solref_limit = sr
        si = _get_v(el, "solimplimit", None)
        if si is not None:
            j.solimp_limit = si
        return j

    def parse_geom(el, childclass) -> GeomSpec:
        el = _with_defaults(el, defaults, "main", childclass)
        g = GeomSpec()
        g.name = el.get("name", "")
        g.type = el.get("type", "sphere")
        g.pos = _get_v(el, "pos", g.pos)
        g.quat = _quat_from_attrs(el, deg, comp.eulerseq)
        size = _get_v(el, "size", np.zeros(3))
        g.size = np.pad(size, (0, 3 - len(size)))[:3]
        ft = _get_v(el, "fromto", None)
        if ft is not None:
            # segment form (capsule/cylinder/ellipsoid/box): frame centered
            # at the midpoint, z axis along the segment, half-length into
            # size[1] (size gives the radius only)
            from refsim.models import rotations as _R
            p1, p2 = ft[:3], ft[3:6]
            g.pos = 0.5 * (p1 + p2)
            seg = p2 - p1
            # the oracle's compiled frame maps +z to the NEGATIVE segment
            # direction (probed vs mjModel.geom_quat; harmless for the
            # symmetric fromto shapes but required for frame-sensor parity)
            g.quat = _R.zaxis_to_quat(-seg / max(np.linalg.norm(seg), 1e-30))
            g.size = g.size.copy()
            if g.type in ("box", "ellipsoid"):
                g.size[2] = 0.5 * np.linalg.norm(seg)   # z half-size
            else:
                g.size[1] = 0.5 * np.linalg.norm(seg)   # half-length
        g.density = _get_f(el, "density", g.density)
        g.mass = _get_f(el, "mass", None)
        fr = _get_v(el, "friction", None)
        if fr is not None:
            full = g.friction.copy()
            full[: len(fr)] = fr
            g.friction = full
        g.contype = int(_get_f(el, "contype", g.contype))
        g.conaffinity = int(_get_f(el, "conaffinity", g.conaffinity))
        g.condim = int(_get_f(el, "condim", g.condim))
        g.priority = int(_get_f(el, "priority", g.priority))
        g.solmix = _get_f(el, "solmix", g.solmix)
        sr = _get_v(el, "solref", None)
        if sr is not None:
            g.solref = sr
        si = _get_v(el, "solimp", None)
        if si is not None:
            full = g.solimp.copy()
            full[: len(si)] = si
            g.solimp = full
        g.margin = _get_f(el, "margin", g.margin)
        g.gap = _get_f(el, "gap", g.gap)
        rgba = _get_v(el, "rgba", None)
        if rgba is not None:
            g.rgba = rgba
        g.mesh = el.get("mesh", "")
        g.hfield = el.get("hfield", "")
        g.material = el.get("material", "")
        g.group = int(_get_f(el, "group", 0))
        if g.type == "mesh" or (g.mesh and el.get("type") is None):
            g.type = "mesh"
        return g

    def parse_body(el, childclass) -> BodySpec:
        b = BodySpec()
        b.name = el.get("name", "")
        b.pos = _get_v(el, "pos", np.zeros(3))
        b.quat = _quat_from_attrs(el, deg, comp.eulerseq)
        b.gravcomp = _get_f(el, "gravcomp", 0.0)
        b.mocap = _get_b(el, "mocap", False)
        cc = el.get("childclass", childclass)

        ident = np.array([1.0, 0, 0, 0])

        def xform(obj, fpos, fquat, axis=False):
            """compose a <frame> transform onto a parsed child spec"""
            obj.pos = fpos + R.rot_vec_np(obj.pos, fquat)
            if axis:
                obj.axis = R.rot_vec_np(obj.axis, fquat)
            else:
                obj.quat = R.quat_mul_np(fquat, obj.quat)
            return obj

        def walk(el_, cc_, fpos, fquat):
            """children of a body or (recursively) a <frame>; frames are
            pure compile-time transforms folded into their children"""
            plain = not np.any(fpos) and fquat[0] == 1.0 and \
                not np.any(fquat[1:])
            for child in el_:
                if child.tag == "frame":
                    cpos = _get_v(child, "pos", np.zeros(3))
                    cquat = _quat_from_attrs(child, deg, comp.eulerseq)
                    walk(child, child.get("childclass", cc_),
                         fpos + R.rot_vec_np(cpos, fquat),
                         R.quat_mul_np(fquat, cquat))
                elif child.tag == "joint":
                    j = parse_joint(child, cc_)
                    b.joints.append(j if plain
                                    else xform(j, fpos, fquat, axis=True))
                elif child.tag == "freejoint":
                    j = JointSpec(name=child.get("name", ""), type="free",
                                  limited=False)
                    b.joints.append(j)
                elif child.tag == "geom":
                    g = parse_geom(child, cc_)
                    b.geoms.append(g if plain else xform(g, fpos, fquat))
                elif child.tag == "site":
                    s = _with_defaults(child, defaults, "main", cc_)
                    ssize = _get_v(s, "size", np.array([0.005]))
                    ssize = np.pad(ssize, (0, 3 - len(ssize)),
                                   mode="edge")[:3]
                    sp = SiteSpec(
                        name=s.get("name", ""),
                        pos=_get_v(s, "pos", np.zeros(3)),
                        quat=_quat_from_attrs(s, deg, comp.eulerseq),
                        type=s.get("type", "sphere"),
                        size=ssize)
                    b.sites.append(sp if plain
                                   else xform(sp, fpos, fquat))
                elif child.tag == "inertial":
                    ine = InertialSpec()
                    ine.pos = _get_v(child, "pos", np.zeros(3))
                    ine.quat = _quat_from_attrs(child, deg, comp.eulerseq)
                    ine.mass = _get_f(child, "mass", 0.0)
                    ine.diaginertia = _get_v(child, "diaginertia", None)
                    ine.fullinertia = _get_v(child, "fullinertia", None)
                    if not plain:
                        xform(ine, fpos, fquat)
                    b.inertial = ine
                elif child.tag == "body":
                    sub = parse_body(child, cc_)
                    b.children.append(sub if plain
                                      else xform(sub, fpos, fquat))

        walk(el, cc, np.zeros(3), ident)
        return b

    # -- worldbody blocks (possibly several; reference pendulum.xml has two)
    for wb in root.findall("worldbody"):
        fake_world = parse_body(wb, "")
        spec.world.geoms.extend(fake_world.geoms)
        spec.world.sites.extend(fake_world.sites)
        spec.world.children.extend(fake_world.children)

    # -- equality
    for eq_root in root.findall("equality"):
        for el in eq_root:
            el2 = _with_defaults(el, defaults, "main", "")
            e = EqSpec(type=el.tag, name=el2.get("name", ""))
            e.active = _get_b(el2, "active", True)
            sr = _get_v(el2, "solref", None)
            if sr is not None:
                e.solref = sr
            si = _get_v(el2, "solimp", None)
            if si is not None:
                e.solimp = si
            if el.tag == "joint":
                e.obj1 = el2.get("joint1", "")
                e.obj2 = el2.get("joint2", "")
                poly = _get_v(el2, "polycoef", np.array([0.0, 1, 0, 0, 0]))
                e.data[: len(poly)] = poly
            elif el.tag == "weld":
                e.obj1 = el2.get("body1", "")
                e.obj2 = el2.get("body2", "")
                anchor = _get_v(el2, "anchor", None)
                if anchor is not None:
                    e.data[:3] = anchor
                relpose = _get_v(el2, "relpose", None)
                if relpose is not None:
                    e.data[3:10] = relpose
                # else: zeros signal "resolve from qpos0" at compile
                e.torquescale = _get_f(el2, "torquescale", 1.0)
            elif el.tag == "connect":
                e.obj1 = el2.get("body1", "")
                e.obj2 = el2.get("body2", "")
                anchor = _get_v(el2, "anchor", np.zeros(3))
                e.data[:3] = anchor
            elif el.tag == "tendon":
                e.obj1 = el2.get("tendon1", "")
                e.obj2 = el2.get("tendon2", "")
                poly = _get_v(el2, "polycoef", np.array([0.0, 1, 0, 0, 0]))
                e.data[: len(poly)] = poly
            else:
                raise ValueError(
                    f"<equality><{el.tag}> is not supported")
            spec.equalities.append(e)

    # -- contact overrides
    for c_root in root.findall("contact"):
        for el in c_root:
            if el.tag == "exclude":
                spec.excludes.append((el.get("body1"), el.get("body2")))
            elif el.tag == "pair":
                spec.pairs.append(dict(el.attrib))

    # -- actuators (shortcut canonicalization: libmujoco compiler behavior)
    def parse_actuator(el) -> ActuatorSpec:
        tag = el.tag
        el = _with_defaults(el, defaults, "main", "")
        a = ActuatorSpec(name=el.get("name", ""), joint=el.get("joint", ""),
                         site=el.get("site", ""),
                         refsite=el.get("refsite", ""),
                         tendon=el.get("tendon", ""))
        for attr in ("cranksite", "jointinparent"):
            if el.get(attr):
                raise ValueError(
                    f"<{tag}> transmission '{attr}' is not supported; "
                    "joint/site/tendon transmissions are implemented")
        g = _get_v(el, "gear", None)
        if g is not None:
            a.gear = np.pad(g, (0, 6 - len(g)))[:6]
        cr = _get_v(el, "ctrlrange", None)
        if cr is not None:
            a.ctrlrange = cr
        limited = _get_b(el, "ctrllimited", None)
        a.ctrllimited = bool(
            limited if limited is not None
            else comp.autolimits and cr is not None and np.any(cr != 0))
        fr = _get_v(el, "forcerange", None)
        if fr is not None:
            a.forcerange = fr
        flimited = _get_b(el, "forcelimited", None)
        a.forcelimited = bool(
            flimited if flimited is not None
            else comp.autolimits and fr is not None and np.any(fr != 0))
        ar = _get_v(el, "actrange", None)
        if ar is not None:
            a.actrange = ar[:2]
        alimited = _get_b(el, "actlimited", None)
        a.actlimited = bool(
            alimited if alimited is not None
            else comp.autolimits and ar is not None and np.any(ar != 0))
        if tag == "motor":
            pass  # gain fixed 1, bias none, dyn none
        elif tag == "position":
            kp = _get_f(el, "kp", 1.0)
            kv = _get_f(el, "kv", 0.0)
            a.gaintype = "fixed"
            a.gainprm = np.array([kp, 0.0, 0.0])
            a.biastype = "affine"
            a.biasprm = np.array([0.0, -kp, -kv])
        elif tag == "velocity":
            kv = _get_f(el, "kv", 1.0)
            a.gaintype = "fixed"
            a.gainprm = np.array([kv, 0.0, 0.0])
            a.biastype = "affine"
            a.biasprm = np.array([0.0, 0.0, -kv])
        elif tag == "damper":
            kv = _get_f(el, "kv", 1.0)
            a.gaintype = "affine"
            a.gainprm = np.array([0.0, 0.0, -kv])
            a.ctrllimited = True
        elif tag == "intvelocity":
            kp = _get_f(el, "kp", 1.0)
            a.dyntype = "integrator"
            a.gaintype = "fixed"
            a.gainprm = np.array([kp, 0.0, 0.0])
            a.biastype = "affine"
            a.biasprm = np.array([0.0, -kp, -_get_f(el, "kv", 0.0)])
            ar = _get_v(el, "actrange", None)
            if ar is not None:
                a.actlimited = True
                a.actrange = ar[:2]
        elif tag == "muscle":
            # mjcf muscle shortcut -> muscle dyn/gain/bias with the
            # documented default parameter vector
            a.dyntype = "muscle"
            a.gaintype = "muscle"
            a.biastype = "muscle"
            tc = _get_v(el, "timeconst", np.array([0.01, 0.04]))
            a.dynprm = np.pad(np.asarray(tc, float)[:2], (0, 8))
            rng_ = _get_v(el, "range", np.array([0.75, 1.05]))
            gp = np.array([rng_[0], rng_[1],
                           _get_f(el, "force", -1.0),
                           _get_f(el, "scale", 200.0),
                           _get_f(el, "lmin", 0.5),
                           _get_f(el, "lmax", 1.6),
                           _get_f(el, "vmax", 1.5),
                           _get_f(el, "fpmax", 1.3),
                           _get_f(el, "fvmax", 1.2), 0.0])
            a.gainprm = gp
            a.biasprm = gp.copy()
            if not a.ctrllimited and cr is None:
                a.ctrllimited = True
                a.ctrlrange = np.array([0.0, 1.0])
        elif tag == "general":
            a.dyntype = el.get("dyntype", "none")
            a.gaintype = el.get("gaintype", "fixed")
            a.biastype = el.get("biastype", "none")
            for nm in ("dynprm", "gainprm", "biasprm"):
                v = _get_v(el, nm, None)
                if v is not None:
                    cur = getattr(a, nm).copy()
                    n = min(10, len(v))
                    cur[:n] = v[:n]
                    setattr(a, nm, cur)
            if a.dyntype not in ("none", "integrator", "filter",
                                 "filterexact", "muscle"):
                raise ValueError(f"actuator dyntype '{a.dyntype}' "
                                 "is not supported")
            if a.gaintype not in ("fixed", "affine", "muscle") or \
                    a.biastype not in ("none", "affine", "muscle"):
                raise ValueError("only fixed/affine/muscle gain and "
                                 "none/affine/muscle bias are supported")
        else:
            raise ValueError(f"actuator <{tag}> is not supported")
        lrx = _get_v(el, "lengthrange", None)
        if lrx is not None and np.any(lrx != 0):
            a.lengthrange = lrx[:2]
        for nm in ("dynprm", "gainprm", "biasprm"):
            cur = np.asarray(getattr(a, nm), float)
            setattr(a, nm, np.pad(cur, (0, max(0, 10 - len(cur))))[:10])
        return a

    for a_root in root.findall("actuator"):
        for el in a_root:
            spec.actuators.append(parse_actuator(el))

    # -- tendons
    for t_root in root.findall("tendon"):
        for el0 in t_root:
            if el0.tag not in ("fixed", "spatial"):
                raise ValueError(
                    f"<tendon><{el0.tag}> is not supported")
            if el0.tag == "spatial":
                for sub in el0:
                    if sub.tag not in ("site", "geom", "pulley"):
                        raise ValueError(
                            f"spatial tendon wrap element <{sub.tag}> is "
                            "not supported")
            # defaults for tendons live under the <tendon> default tag
            klass = el0.get("class", "main")
            dcls = defaults.get(klass, defaults["main"])
            merged = dict(dcls.attrs.get("tendon", {}))
            merged.update(el0.attrib)
            el = ET.Element("fixed", merged)
            t = TendonSpec(name=el.get("name", ""))
            if _get_f(el, "frictionloss", 0.0) != 0.0:
                raise ValueError("tendon frictionloss is not supported")
            rng = _get_v(el, "range", None)
            if rng is not None:
                t.range = rng
            limited = _get_b(el, "limited", None)
            t.limited = bool(
                limited if limited is not None
                else comp.autolimits and rng is not None and np.any(rng != 0))
            sr = _get_v(el, "solreflimit", None)
            if sr is not None:
                t.solref_limit = sr
            si = _get_v(el, "solimplimit", None)
            if si is not None:
                t.solimp_limit = si
            t.stiffness = _get_f(el, "stiffness", 0.0)
            t.damping = _get_f(el, "damping", 0.0)
            t.margin = _get_f(el, "margin", 0.0)
            sl = _get_v(el, "springlength", None)
            if sl is not None and np.any(sl >= 0):
                t.springlength = (np.array([sl[0], sl[0]]) if len(sl) == 1
                                  else sl[:2])
            for j in el0.findall("joint"):
                t.joints.append((j.get("joint", ""),
                                 float(j.get("coef", "0"))))
            for sel in el0:          # path elements in document order
                if sel.tag == "site":
                    t.path.append(("site", sel.get("site", "")))
                    t.sites.append(sel.get("site", ""))
                elif sel.tag == "geom":
                    t.path.append(("geom", sel.get("geom", ""),
                                   sel.get("sidesite", "")))
                elif sel.tag == "pulley":
                    t.path.append(("pulley",
                                   float(sel.get("divisor", "1"))))
            if el0.tag == "spatial" and len(t.sites) < 2:
                raise ValueError(
                    f"spatial tendon '{t.name}' needs at least 2 sites")
            spec.tendons.append(t)

    # -- keyframes
    for kf_root in root.findall("keyframe"):
        for el in kf_root.findall("key"):
            k = KeySpec(name=el.get("name", ""),
                        time=_get_f(el, "time", 0.0))
            for attr in ("qpos", "qvel", "act", "ctrl", "mpos", "mquat"):
                if el.get(attr):
                    setattr(k, attr, np.fromstring(el.get(attr), sep=" "))
            spec.keys.append(k)

    # -- sensors (mjtSensor surface minus user/plugin sensors)
    for s_root in root.findall("sensor"):
        for el in s_root:
            s = SensorSpec(type=el.tag, name=el.get("name", ""),
                           cutoff=_get_f(el, "cutoff", 0.0))
            if el.tag in _SITE_SENSORS:
                s.site = el.get("site", "")
            elif el.tag in _SENSOR_OBJ_ATTR:
                s.objname = el.get(_SENSOR_OBJ_ATTR[el.tag], "")
            elif el.tag in _FRAME_SENSORS:
                s.objtype = el.get("objtype", "")
                s.objname = el.get("objname", "")
                s.reftype = el.get("reftype", "")
                s.refname = el.get("refname", "")
                if s.refname and not s.reftype:
                    raise ValueError(
                        f"<{el.tag}> refname needs an explicit reftype")
            elif el.tag == "clock":
                pass
            else:
                raise ValueError(f"sensor <{el.tag}> is not supported")
            spec.sensors.append(s)

    return spec
