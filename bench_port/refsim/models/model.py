"""Frozen copy of mujoco_sim_tpu_torch's CPU path for the benchmark's
plain reference (bench_port/refsim): imports rewritten, CUDA wrappers
and graph capture removed.  Do not import the program from here.

Frozen device-resident model + batched per-env state containers.

Torch counterpart of mujoco_sim_tpu/models/model.py with the same field
names.  The model is compiled ONCE (models/compile.py, numpy leaves) and
``engine.put_model`` turns its leaves into tensors on one device; scene
edits (spawn/destroy) flip per-slot ``body_active`` masks in ``Data``.

Unlike the JAX package, whose Data is per-env and vmapped, every ``Data``
leaf here carries an explicit leading env axis (``time`` and ``ncon``
included).

Enumerations mirror MuJoCo's so name-for-name parity is auditable.
"""

from __future__ import annotations

import enum
from types import SimpleNamespace
from typing import Any

import torch
import numpy as np

from refsim.utils.struct import frozen, static, field


class JointType(enum.IntEnum):
    FREE = 0
    BALL = 1
    SLIDE = 2
    HINGE = 3


class GeomType(enum.IntEnum):
    PLANE = 0
    HFIELD = 1
    SPHERE = 2
    CAPSULE = 3
    ELLIPSOID = 4
    CYLINDER = 5
    BOX = 6
    MESH = 7


class EqType(enum.IntEnum):
    CONNECT = 0
    WELD = 1
    JOINT = 2
    TENDON = 3
    FLEX = 4


class Integrator(enum.IntEnum):
    EULER = 0
    RK4 = 1
    IMPLICIT = 2
    IMPLICITFAST = 3


class ConeType(enum.IntEnum):
    PYRAMIDAL = 0
    ELLIPTIC = 1


class DynType(enum.IntEnum):
    NONE = 0
    INTEGRATOR = 1
    FILTER = 2
    FILTEREXACT = 3
    MUSCLE = 4


class GainType(enum.IntEnum):
    FIXED = 0
    AFFINE = 1
    MUSCLE = 2


class TrnType(enum.IntEnum):
    # mjtTrn values (mujoco 2.3.7 mjmodel.h) for parity
    JOINT = 0
    TENDON = 3
    SITE = 4


class BiasType(enum.IntEnum):
    NONE = 0
    AFFINE = 1
    MUSCLE = 2


class SensorType(enum.IntEnum):
    # mjtSensor values (mujoco 2.3.7 mjmodel.h) for parity; the reference
    # itself registers FORCE/TORQUE only (mj_sim.cpp:973-1014) but its
    # libmujoco backend evaluates the full set for arbitrary user worlds
    TOUCH = 0
    ACCELEROMETER = 1
    VELOCIMETER = 2
    GYRO = 3
    FORCE = 4
    TORQUE = 5
    MAGNETOMETER = 6
    RANGEFINDER = 7
    JOINTPOS = 8
    JOINTVEL = 9
    TENDONPOS = 10
    TENDONVEL = 11
    ACTUATORPOS = 12
    ACTUATORVEL = 13
    ACTUATORFRC = 14
    BALLQUAT = 15
    BALLANGVEL = 16
    JOINTLIMITPOS = 17
    JOINTLIMITVEL = 18
    JOINTLIMITFRC = 19
    TENDONLIMITPOS = 20
    TENDONLIMITVEL = 21
    TENDONLIMITFRC = 22
    FRAMEPOS = 23
    FRAMEQUAT = 24
    FRAMEXAXIS = 25
    FRAMEYAXIS = 26
    FRAMEZAXIS = 27
    FRAMELINVEL = 28
    FRAMEANGVEL = 29
    SUBTREECOM = 32
    SUBTREELINVEL = 33
    SUBTREEANGMOM = 34
    CLOCK = 35


class ObjType(enum.IntEnum):
    # mjtObj subset used by frame sensors
    BODY = 1
    XBODY = 2
    GEOM = 5
    SITE = 6


class DisableBit(enum.IntFlag):
    CONSTRAINT = 1 << 0
    EQUALITY = 1 << 1
    FRICTIONLOSS = 1 << 2
    LIMIT = 1 << 3
    CONTACT = 1 << 4
    PASSIVE = 1 << 5
    GRAVITY = 1 << 6
    WARMSTART = 1 << 7


@frozen
class Option:
    """Simulation options (mjOption equivalent)."""

    timestep: torch.Tensor
    gravity: torch.Tensor          # (3,)
    wind: torch.Tensor             # (3,)
    magnetic: torch.Tensor         # (3,) global magnetic flux (magnetometer)
    density: torch.Tensor          # fluid density
    viscosity: torch.Tensor
    impratio: torch.Tensor
    o_margin: torch.Tensor
    o_solref: torch.Tensor         # (2,)
    o_solimp: torch.Tensor         # (5,)
    # static (jit cache keys)
    integrator: int = static(default=int(Integrator.EULER))
    cone: int = static(default=int(ConeType.PYRAMIDAL))
    solver_iterations: int = static(default=50)
    ls_iterations: int = static(default=20)
    ls_tolerance: float = static(default=0.01)
    tolerance: float = static(default=1e-8)
    noslip_iterations: int = static(default=0)
    noslip_tolerance: float = static(default=1e-6)
    disableflags: int = static(default=0)
    has_fluid: int = static(default=0)  # density/viscosity/wind nonzero
    override_contacts: int = static(default=0)  # mjENBL_OVERRIDE
    # oracle-form exact manifolds for ALL contacting mesh pairs instead
    # of only deep ones: PR2 err50 vs mujoco 3.10 drops 1.7e-4 -> 7.7e-6
    # (the default SAT manifolds emit 2+2 points where the oracle's EPA
    # emits one witness); costs the gated exact query whenever any mesh
    # pair touches.  m.replace(opt=m.opt.replace(exact_meshcollide=1)).
    exact_meshcollide: int = static(default=0)


@frozen
class Model:
    """Compiled, padded, immutable model. Single source of truth for kernels.

    Counts and index tables are static; numeric fields are numpy arrays
    after compile and tensors on one device after ``engine.put_model``.
    Mirrors the information content of mjModel for the supported feature
    set (reference loads it via mj_loadXML,
    include/mujoco_sim/mj_util.h:185-193).
    """

    opt: Option

    # ---- bodies
    body_parentid: torch.Tensor      # (nbody,) i32
    body_rootid: torch.Tensor        # (nbody,) i32
    body_weldid: torch.Tensor        # (nbody,) i32
    body_jntadr: torch.Tensor        # (nbody,) i32  (-1 if none)
    body_jntnum: torch.Tensor        # (nbody,) i32
    body_dofadr: torch.Tensor        # (nbody,) i32
    body_dofnum: torch.Tensor        # (nbody,) i32
    body_pos: torch.Tensor           # (nbody, 3)
    body_quat: torch.Tensor          # (nbody, 4)
    body_ipos: torch.Tensor          # (nbody, 3)
    body_iquat: torch.Tensor         # (nbody, 4)
    body_mass: torch.Tensor          # (nbody,)
    body_inertia: torch.Tensor       # (nbody, 3) diagonal in i-frame
    body_gravcomp: torch.Tensor      # (nbody,)
    body_invweight0: torch.Tensor    # (nbody, 2) [tran, rot]
    body_subtreemass: torch.Tensor   # (nbody,)
    body_mocapid: torch.Tensor       # (nbody,) i32, -1 if not mocap

    # ---- joints
    jnt_type: torch.Tensor           # (njnt,) i32
    jnt_qposadr: torch.Tensor        # (njnt,) i32
    jnt_dofadr: torch.Tensor         # (njnt,) i32
    jnt_bodyid: torch.Tensor         # (njnt,) i32
    jnt_pos: torch.Tensor            # (njnt, 3)
    jnt_axis: torch.Tensor           # (njnt, 3)
    jnt_range: torch.Tensor          # (njnt, 2)
    jnt_limited: torch.Tensor        # (njnt,) bool
    jnt_stiffness: torch.Tensor      # (njnt,)
    jnt_springref: torch.Tensor      # (njnt,)
    jnt_ref: torch.Tensor            # (njnt,)
    jnt_margin: torch.Tensor         # (njnt,)
    jnt_solref: torch.Tensor         # (njnt, 2) limit solref
    jnt_solimp: torch.Tensor         # (njnt, 5) limit solimp

    # ---- dofs
    dof_bodyid: torch.Tensor         # (nv,) i32
    dof_jntid: torch.Tensor          # (nv,) i32
    dof_parentid: torch.Tensor       # (nv,) i32 (-1 root)
    dof_armature: torch.Tensor       # (nv,)
    dof_damping: torch.Tensor        # (nv,)
    dof_frictionloss: torch.Tensor   # (nv,)
    dof_invweight0: torch.Tensor     # (nv,)

    # ---- geoms
    geom_type: torch.Tensor          # (ngeom,) i32
    geom_bodyid: torch.Tensor        # (ngeom,) i32
    geom_dataid: torch.Tensor        # (ngeom,) i32 mesh id or -1
    geom_pos: torch.Tensor           # (ngeom, 3)
    geom_quat: torch.Tensor          # (ngeom, 4)
    geom_size: torch.Tensor          # (ngeom, 3)
    geom_rbound: torch.Tensor        # (ngeom,) bounding radius (0 = plane)
    geom_friction: torch.Tensor      # (ngeom, 3)
    geom_contype: torch.Tensor       # (ngeom,) i32
    geom_conaffinity: torch.Tensor   # (ngeom,) i32
    geom_condim: torch.Tensor        # (ngeom,) i32
    geom_priority: torch.Tensor      # (ngeom,) i32
    geom_solmix: torch.Tensor        # (ngeom,)
    geom_solref: torch.Tensor        # (ngeom, 2)
    geom_solimp: torch.Tensor        # (ngeom, 5)
    geom_margin: torch.Tensor        # (ngeom,)
    geom_gap: torch.Tensor           # (ngeom,)
    geom_rgba: torch.Tensor          # (ngeom, 4) viz only

    # ---- sites
    site_bodyid: torch.Tensor        # (nsite,) i32
    site_pos: torch.Tensor           # (nsite, 3)
    site_quat: torch.Tensor          # (nsite, 4)

    # ---- meshes (convex hulls, padded)
    mesh_vert: torch.Tensor          # (nmeshvert_total, 3) hull vertices, packed
    mesh_vertadr: torch.Tensor       # (nmesh,) i32
    mesh_vertnum: torch.Tensor       # (nmesh,) i32
    hfield_data: torch.Tensor        # (nhfield, maxrow, maxcol) in [0,1]
    hfield_size: torch.Tensor        # (nhfield, 4) rx ry ztop zbottom
    mesh_vert_pad: torch.Tensor      # (nmesh, maxvert, 3) padded hull verts
    mesh_vert_mask: torch.Tensor     # (nmesh, maxvert) 1.0 for real verts
    mesh_face_pad: torch.Tensor      # (nmesh, maxface, 4) [normal, offset]
    # merged coplanar faces + ordered face polygons, for the face-clip
    # overlap-polygon manifold (mesh_io.face_polygons); fpoly padding
    # repeats each face's last vertex so circular adjacency survives
    mesh_fplane: torch.Tensor        # (nhull, maxmface, 4)
    mesh_fmask: torch.Tensor         # (nhull, maxmface) 1.0 for real faces
    mesh_fpoly: torch.Tensor         # (nhull, maxmface, maxfv, 3)
    # [is_cyl, radius, half_height]: prism hulls the exact manifold
    # treats as true cylinders (analytic support, axis = local +z)
    mesh_cyl: torch.Tensor           # (nhull, 3)
    # FULL (undecimated) hull verts for the deep-pair exact manifold:
    # 32-vert decimation error (mm) rotates the exact MTV at cm-scale
    # penetration.  Only read inside the deep-pair gate.
    mesh_vert_hi: torch.Tensor       # (nhull, maxvhi, 3), pad = 1st vertex
    #   (repeat-pad: support min/max runs UNMASKED — ops/manifold.py)
    mesh_vert_hi_mask: torch.Tensor  # (nhull, maxvhi)
    # full-hull edge endpoint pairs (exact-MTV top-K edge refinement)
    mesh_hedge: torch.Tensor         # (nhull, maxhe, 2, 3), pad 1e6
    mesh_hedge_mask: torch.Tensor    # (nhull, maxhe)

    # ---- actuators (normalized general form; joint transmissions only.
    # type/limited flags live in Layout so kernels branch statically;
    # parameters are leaves so they stay runtime-tunable without retrace)
    actuator_gear: torch.Tensor      # (nu, 6)
    actuator_gainprm: torch.Tensor   # (nu, 10) (mjNGAIN)
    actuator_biasprm: torch.Tensor   # (nu, 10)
    actuator_dynprm: torch.Tensor    # (nu, 10)
    actuator_ctrlrange: torch.Tensor  # (nu, 2)
    actuator_forcerange: torch.Tensor  # (nu, 2)
    actuator_lengthrange: torch.Tensor  # (nu, 2) muscle operating range
    actuator_acc0: torch.Tensor      # (nu,) |M^-1 moment| at qpos0 (set_const)
    actuator_actrange: torch.Tensor  # (nu, 2) activation clamp (actlimited)

    # ---- fixed tendons (length = Layout.ten_Wq @ qpos, a static matmul)
    ten_range: torch.Tensor          # (ntendon, 2)
    ten_solref: torch.Tensor         # (ntendon, 2)
    ten_solimp: torch.Tensor         # (ntendon, 5)
    ten_stiffness: torch.Tensor      # (ntendon,)
    ten_damping: torch.Tensor        # (ntendon,)
    ten_springlength: torch.Tensor   # (ntendon, 2) deadband [lo, hi]
    ten_length0: torch.Tensor        # (ntendon,) length at qpos0 (set_const)
    ten_margin: torch.Tensor         # (ntendon,)
    ten_invweight0: torch.Tensor     # (ntendon,) W M(q0)^-1 W^T (mj_setConst)

    # ---- equality constraints
    eq_type: torch.Tensor            # (neq,) i32
    eq_obj1id: torch.Tensor          # (neq,) i32
    eq_obj2id: torch.Tensor          # (neq,) i32
    eq_active0: torch.Tensor         # (neq,) bool
    eq_data: torch.Tensor            # (neq, 11)
    eq_solref: torch.Tensor          # (neq, 2)
    eq_solimp: torch.Tensor          # (neq, 5)

    # ---- precomputed collision pair list (static shapes; SURVEY §2.2)
    pair_geom1: torch.Tensor         # (npair,) i32
    pair_geom2: torch.Tensor         # (npair,) i32
    pair_friction: torch.Tensor      # (npair, 5) mixed contact friction
    pair_solref: torch.Tensor        # (npair, 2)
    pair_solimp: torch.Tensor        # (npair, 5)
    pair_margin: torch.Tensor        # (npair,)
    pair_gap: torch.Tensor           # (npair,)

    # ---- sensors
    sensor_type: torch.Tensor        # (nsensor,) i32
    sensor_objid: torch.Tensor       # (nsensor,) i32
    sensor_adr: torch.Tensor         # (nsensor,) i32
    sensor_cutoff: torch.Tensor      # (nsensor,) 0 = no cutoff clamp

    # ---- reference configuration
    qpos0: torch.Tensor              # (nq,)
    qpos_spring: torch.Tensor        # (nq,)

    # ---- keyframes (<keyframe><key>, mj_resetDataKeyframe targets)
    key_time: torch.Tensor           # (nkey,)
    key_qpos: torch.Tensor           # (nkey, nq)
    key_qvel: torch.Tensor           # (nkey, nv)
    key_act: torch.Tensor            # (nkey, nu)
    key_ctrl: torch.Tensor           # (nkey, nu)
    key_mpos: torch.Tensor           # (nkey, nmocap, 3)
    key_mquat: torch.Tensor          # (nkey, nmocap, 4)

    # ---- static metadata
    nq: int = static(default=0)
    nv: int = static(default=0)
    nbody: int = static(default=0)
    njnt: int = static(default=0)
    ngeom: int = static(default=0)
    nsite: int = static(default=0)
    nmesh: int = static(default=0)
    neq: int = static(default=0)
    npair: int = static(default=0)
    nsensor: int = static(default=0)
    nsensordata: int = static(default=0)
    nmocap: int = static(default=0)
    nkey: int = static(default=0)
    nu: int = static(default=0)         # actuators (na act slots == nu)
    ntendon: int = static(default=0)
    ncon_max: int = static(default=0)   # contact budget K (top-K compaction)
    nefc_max: int = static(default=0)   # padded constraint-row capacity
    ncand: int = static(default=0)      # total narrowphase candidates
    max_condim: int = static(default=1)  # rows per contact = 2*(max_condim-1)
    contact_efcadr: int = static(default=0)  # first contact row address
    npair_unsupported: int = static(default=0)  # dropped pair-type combos
    # tree levels: tuple of tuples of body ids, root (world) excluded
    body_levels: tuple = static(default=())
    # per-body joint slots: max joints in any body (for unrolled FK loop)
    max_jnt_per_body: int = static(default=0)
    # dof ancestry: tuple-of-tuples static masks are big; keep as array leaf
    ancestor_mask: torch.Tensor = field(default=None)   # (nbody, nv) f, 1 if dof is ancestor
    dof_jnt_slot: torch.Tensor = field(default=None)    # unused placeholder
    # host-side static structure arrays (parent ids, joint layout, ...)
    layout: Any = static(default=None)  # Layout

    # host-only name tables (static, hashable-ish: tuples)
    names: Any = static(default=None)  # NameTable

    @property
    def device(self) -> torch.device:
        """Device of the tensor leaves (set by engine.put_model)."""
        return self.qpos0.device

    @property
    def dtype(self) -> torch.dtype:
        """Float dtype of the tensor leaves (set by engine.put_model)."""
        return self.qpos0.dtype


def to_tensors(obj, device, dtype):
    """numpy arrays inside (nested tuples/lists/dicts of) obj -> tensors:
    floats to ``dtype``, integers to ``torch.long`` (index tensors), bools
    to ``torch.bool``.  Anything else is returned unchanged."""
    if isinstance(obj, np.ndarray):
        if obj.dtype == np.bool_:
            t = torch.bool
        elif np.issubdtype(obj.dtype, np.integer):
            t = torch.long
        else:
            t = dtype
        return torch.as_tensor(obj, dtype=t, device=device)
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_tensors(v, device, dtype) for v in obj)
    if isinstance(obj, dict):
        return {k: to_tensors(v, device, dtype) for k, v in obj.items()}
    return obj


class Layout:
    """Host-side static structure arrays (numpy), hashable for plan caches.

    Kernels index model/state leaves with these *constant* arrays.  After
    ``to(device)`` (called once by ``engine.put_model``), ``dev`` holds
    every integer array as a ``torch.long`` tensor and every bool array as
    a bool tensor on that device, and ``const`` memoizes further static
    tables built from the numpy arrays (plans, one-hot matrices) as
    tensors there, so a step makes no host->device copies of static data.
    """

    def __init__(self, **arrays):
        self._arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
        self._hash = hash(tuple(
            (k, v.shape, v.tobytes()) for k, v in sorted(self._arrays.items())))
        self.device = None
        self.dev = None
        self._consts = {}

    def __getattr__(self, k):
        arrays = self.__dict__.get("_arrays")
        if arrays is None or k not in arrays:
            raise AttributeError(k)
        return arrays[k]

    def to(self, device) -> "Layout":
        """Copy whose ``dev`` holds the index arrays on ``device``."""
        out = Layout(**self._arrays)
        out.device = torch.device(device)
        out.dev = SimpleNamespace(**{
            k: to_tensors(v, out.device, None)
            for k, v in self._arrays.items()
            if v.dtype == np.bool_ or np.issubdtype(v.dtype, np.integer)})
        return out

    def const(self, key, make, dtype):
        """``to_tensors(make())`` on this layout's device, built once per
        (key, dtype)."""
        k = (key, dtype)
        got = self._consts.get(k)
        if got is None:
            got = to_tensors(make(), self.device, dtype)
            self._consts[k] = got
        return got

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return isinstance(other, Layout) and self._hash == other._hash and all(
            np.array_equal(v, other._arrays.get(k))
            for k, v in self._arrays.items())


class NameTable:
    """Host-side bidirectional name<->id maps per object class.

    Equivalent of mj_name2id/mj_id2name used ~50x by the reference
    (SURVEY.md §2.2).  Hashable so it can ride in pytree aux data.
    """

    __slots__ = ("body", "joint", "geom", "site", "mesh", "sensor", "eq",
                 "actuator", "tendon", "key", "_body_inv", "_joint_inv",
                 "_geom_inv", "_site_inv", "_act_inv", "_ten_inv",
                 "_key_inv")

    def __init__(self, body=(), joint=(), geom=(), site=(), mesh=(),
                 sensor=(), eq=(), actuator=(), tendon=(), key=()):
        self.body = tuple(body)
        self.joint = tuple(joint)
        self.geom = tuple(geom)
        self.site = tuple(site)
        self.mesh = tuple(mesh)
        self.sensor = tuple(sensor)
        self.eq = tuple(eq)
        self.actuator = tuple(actuator)
        self.tendon = tuple(tendon)
        self.key = tuple(key)
        self._key_inv = {n: i for i, n in enumerate(self.key)}
        self._ten_inv = {n: i for i, n in enumerate(self.tendon)}
        self._act_inv = {n: i for i, n in enumerate(self.actuator)}
        self._body_inv = {n: i for i, n in enumerate(self.body)}
        self._joint_inv = {n: i for i, n in enumerate(self.joint)}
        self._geom_inv = {n: i for i, n in enumerate(self.geom)}
        self._site_inv = {n: i for i, n in enumerate(self.site)}

    def body_id(self, name: str) -> int:
        return self._body_inv.get(name, -1)

    def joint_id(self, name: str) -> int:
        return self._joint_inv.get(name, -1)

    def geom_id(self, name: str) -> int:
        return self._geom_inv.get(name, -1)

    def site_id(self, name: str) -> int:
        return self._site_inv.get(name, -1)

    def actuator_id(self, name: str) -> int:
        return self._act_inv.get(name, -1)

    def tendon_id(self, name: str) -> int:
        return self._ten_inv.get(name, -1)

    def key_id(self, name: str) -> int:
        return self._key_inv.get(name, -1)

    def __hash__(self):
        return hash((self.body, self.joint, self.geom, self.site, self.mesh,
                     self.sensor, self.eq, self.actuator, self.tendon,
                     self.key))

    def __eq__(self, other):
        return isinstance(other, NameTable) and (
            self.body, self.joint, self.geom, self.site, self.mesh,
            self.sensor, self.eq, self.actuator, self.tendon,
        ) == (
            other.body, other.joint, other.geom, other.site, other.mesh,
            other.sensor, other.eq, other.actuator, other.tendon,
        )


@frozen
class Contact:
    """Padded contact set (ncon_max slots, mask-active).  Shapes below are
    per env; every leaf has a leading env axis."""

    dist: torch.Tensor        # (ncon,)
    pos: torch.Tensor         # (ncon, 3)
    frame: torch.Tensor       # (ncon, 3, 3) rows: normal, tangent1, tangent2
    geom1: torch.Tensor       # (ncon,) i32
    geom2: torch.Tensor       # (ncon,) i32
    includemargin: torch.Tensor  # (ncon,)
    friction: torch.Tensor    # (ncon, 5)
    solref: torch.Tensor      # (ncon, 2)
    solimp: torch.Tensor      # (ncon, 5)
    dim: torch.Tensor         # (ncon,) i32 condim
    efc_address: torch.Tensor  # (ncon,) i32
    active: torch.Tensor      # (ncon,) bool


@frozen
class Data:
    """Per-env dynamic state + derived quantities (mjData equivalent).

    Every leaf carries an explicit leading env axis (nenv, ...); the shapes
    noted below are per env.
    """

    time: torch.Tensor
    qpos: torch.Tensor            # (nq,)
    qvel: torch.Tensor            # (nv,)
    qacc: torch.Tensor            # (nv,)
    qacc_warmstart: torch.Tensor  # (nv,)
    qfrc_applied: torch.Tensor    # (nv,)
    xfrc_applied: torch.Tensor    # (nbody, 6) [torque, force] world at body com
    ctrl: torch.Tensor            # (nu,) actuator controls
    act: torch.Tensor             # (nu,) activation state (0 for dyntype none)
    act_dot: torch.Tensor         # (nu,) activation derivative
    actuator_length: torch.Tensor    # (nu,)
    actuator_velocity: torch.Tensor  # (nu,)
    actuator_force: torch.Tensor  # (nu,) scalar transmission force
    qfrc_actuator: torch.Tensor   # (nv,)
    ten_length: torch.Tensor      # (ntendon,)
    ten_velocity: torch.Tensor    # (ntendon,)
    ten_J: torch.Tensor           # (ntendon, nv) moment rows (mj_tendon)

    # masked-slot scene state (spawn/destroy; SURVEY §3.3 contract)
    body_active: torch.Tensor     # (nbody,) bool
    # request-parameterized spawn geometry (mj_ros.cpp:941-966,1340-1412):
    # the reference rebuilds the model from the request's size/rgba/inertial;
    # here they are per-env STATE so a spawn applies them with zero retrace
    geom_size: torch.Tensor       # (ngeom, 3)
    geom_rbound: torch.Tensor     # (ngeom,)
    geom_rgba: torch.Tensor       # (ngeom, 4)
    body_mass: torch.Tensor       # (nbody,)
    body_inertia: torch.Tensor    # (nbody, 3)
    # mocap bodies: pose set directly by the host/collectives (the '_ref'
    # twins of the reference's multi-instance sync, mj_sim.cpp:847-960)
    mocap_pos: torch.Tensor       # (nmocap, 3)
    mocap_quat: torch.Tensor      # (nmocap, 4)

    # kinematics
    xpos: torch.Tensor            # (nbody, 3)
    xquat: torch.Tensor           # (nbody, 4)
    xipos: torch.Tensor           # (nbody, 3)
    ximat: torch.Tensor           # (nbody, 3, 3)
    xanchor: torch.Tensor         # (njnt, 3)
    xaxis: torch.Tensor           # (njnt, 3)
    geom_xpos: torch.Tensor       # (ngeom, 3)
    geom_xmat: torch.Tensor       # (ngeom, 3, 3)
    site_xpos: torch.Tensor       # (nsite, 3)
    site_xmat: torch.Tensor       # (nsite, 3, 3)
    subtree_com: torch.Tensor     # (nbody, 3)

    # dynamics
    cvel: torch.Tensor            # (nbody, 6) com-frame spatial velocity
    cdof: torch.Tensor            # (nv, 6) dof motion axes (about subtree com)
    cdof_dot: torch.Tensor        # (nv, 6)
    qM: torch.Tensor              # (nv, nv) dense mass matrix
    # cholesky factor of qM (+ armature).  SENTINEL: on the TPU pallas
    # path with noslip off, engine.forward leaves qLD all-ZERO (the
    # factor is fused into each pallas chol_solve and never materialized;
    # engine.py fwd 'crb' scope) — consumers must check, like noslip does
    qLD: torch.Tensor             # (nv, nv)
    qfrc_bias: torch.Tensor       # (nv,)
    qfrc_passive: torch.Tensor    # (nv,)
    qfrc_spring: torch.Tensor     # (nv,)
    qfrc_damper: torch.Tensor     # (nv,)
    qfrc_gravcomp: torch.Tensor   # (nv,)
    qfrc_smooth: torch.Tensor     # (nv,)
    qacc_smooth: torch.Tensor     # (nv,)
    qfrc_constraint: torch.Tensor  # (nv,)
    qfrc_inverse: torch.Tensor    # (nv,)

    # constraints
    contact: Contact
    ncon: torch.Tensor            # i32 active contact count
    efc_J: torch.Tensor           # (nefc, nv)
    efc_D: torch.Tensor           # (nefc,)
    efc_aref: torch.Tensor        # (nefc,)
    efc_R: torch.Tensor           # (nefc,)
    efc_frictionloss: torch.Tensor  # (nefc,)
    efc_floss_active: torch.Tensor  # (nefc,) bool friction-loss rows
    efc_active: torch.Tensor      # (nefc,) bool
    efc_type: torch.Tensor        # (nefc,) i32 0=eq,1=fric,2=limit,3=contact
    efc_force: torch.Tensor       # (nefc,)

    # outputs
    sensordata: torch.Tensor      # (nsensordata,)
    energy: torch.Tensor          # (2,) potential, kinetic


def contact_rows_per(max_condim: int, cone: int) -> int:
    """efc rows per contact slot: pyramidal = +-pair per friction axis;
    elliptic = one row per contact dimension (normal + frictions)."""
    if cone == int(ConeType.ELLIPTIC):
        return max(1, max_condim)
    return max(1, 2 * (max_condim - 1))


def np_f(x, dtype=np.float64):
    return np.asarray(x, dtype=dtype)


def np_i(x):
    return np.asarray(x, dtype=np.int32)
