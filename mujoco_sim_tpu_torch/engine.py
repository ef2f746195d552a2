"""Public engine API: put_model, make_data, forward, step.

Torch port of mujoco_sim_tpu/engine.py.  All functions are pure,
``d' = f(m, d)``; batching is an explicit leading env axis on every Data
leaf (the JAX package vmaps a per-env step instead).  Each function takes
its device and dtype from the model and data it is given.

The SPD solves of the step (qacc_smooth, the Euler velocity update, every
Newton direction) go through ops/chol.chol_solve, which launches the
hand-written CUDA kernel for CUDA tensors and takes its plain twin for CPU
tensors: the path is chosen by device, not by a switch.  With the kernel,
``qLD`` stays all-zero (the factor is fused into each solve and never
materialized), as on the JAX package's TPU path.

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
actuators, tendons, sensors, equality rows, the elliptic cone, noslip,
RK4 and the implicit integrators.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_sim_tpu_torch.models.model import (
    Model, Data, Contact, Integrator, DisableBit, JointType,
)
from mujoco_sim_tpu_torch.ops import chol, smooth, support
from mujoco_sim_tpu_torch.ops import passive as passive_mod
from mujoco_sim_tpu_torch.ops import integrate as integrate_mod
from mujoco_sim_tpu_torch.ops import math as mm
from mujoco_sim_tpu_torch.utils.struct import map_leaves


def _true_f32_matmuls():
    """Hopper's TF32 is the bf16 trap of the TPU: reduced-precision matmul
    inputs NaN the contact Cholesky on stiff rows (the JAX package forces
    "highest" matmul precision for the same reason)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def put_model(m: Model, dtype=torch.float32, device="cpu") -> Model:
    """Cast float leaves to ``dtype`` and move every leaf to ``device``.

    Integer leaves become torch.long, bool leaves stay bool.  The Layout's
    index arrays are moved to the device once (``Layout.to``), so the step
    makes no host->device copies of static indices.  On a CUDA device TF32
    is switched off (true f32 matmuls).
    """
    device = torch.device(device)
    if device.type == "cuda":
        _true_f32_matmuls()

    def cast(x):
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x)
        if x.dtype == np.bool_:
            return torch.tensor(x, device=device)
        if np.issubdtype(x.dtype, np.integer):
            return torch.tensor(x, dtype=torch.long, device=device)
        return torch.tensor(x, dtype=dtype, device=device)

    return map_leaves(cast, m).replace(layout=m.layout.to(device))


def make_data(m: Model, nenv: int, dtype=None) -> Data:
    """Fresh Data at qpos0 for ``nenv`` envs (mj_makeData + reset), every
    leaf with a leading env axis, on the model's device."""
    dtype = m.dtype if dtype is None else dtype
    dev = m.device
    B = nenv

    def z(*shape):
        return torch.zeros((B,) + shape, dtype=dtype, device=dev)

    def full(shape, value, t):
        return torch.full((B,) + shape, value, dtype=t, device=dev)

    def tile(x):
        return x.to(dtype).expand((B,) + tuple(x.shape)).clone()

    nv, nbody, njnt = m.nv, m.nbody, m.njnt
    ncon, nefc = m.ncon_max, m.nefc_max
    contact = Contact(
        dist=z(ncon), pos=z(ncon, 3), frame=z(ncon, 3, 3),
        geom1=full((ncon,), -1, torch.int32),
        geom2=full((ncon,), -1, torch.int32),
        includemargin=z(ncon), friction=z(ncon, 5),
        solref=z(ncon, 2), solimp=z(ncon, 5),
        dim=full((ncon,), 1, torch.int32),
        efc_address=full((ncon,), -1, torch.int32),
        active=full((ncon,), False, torch.bool),
    )
    mocap_ids = m.layout.const(
        "mocap_ids", lambda: np.nonzero(m.layout.body_mocapid >= 0)[0],
        dtype)
    xquat = z(nbody, 4)
    xquat[..., 0] = 1.0
    return Data(
        time=z(),
        qpos=tile(m.qpos0),
        qvel=z(nv), qacc=z(nv), qacc_warmstart=z(nv),
        qfrc_applied=z(nv), xfrc_applied=z(nbody, 6),
        ctrl=z(m.nu), act=z(m.nu), act_dot=z(m.nu),
        actuator_length=z(m.nu), actuator_velocity=z(m.nu),
        actuator_force=z(m.nu), qfrc_actuator=z(nv),
        ten_length=z(m.ntendon), ten_velocity=z(m.ntendon),
        ten_J=z(m.ntendon, nv),
        body_active=full((nbody,), True, torch.bool),
        geom_size=tile(m.geom_size),
        geom_rbound=tile(m.geom_rbound),
        geom_rgba=tile(m.geom_rgba),
        body_mass=tile(m.body_mass),
        body_inertia=tile(m.body_inertia),
        mocap_pos=tile(m.body_pos[mocap_ids]),
        mocap_quat=tile(m.body_quat[mocap_ids]),
        xpos=z(nbody, 3), xquat=xquat,
        xipos=z(nbody, 3), ximat=z(nbody, 3, 3),
        xanchor=z(njnt, 3), xaxis=z(njnt, 3),
        geom_xpos=z(m.ngeom, 3), geom_xmat=z(m.ngeom, 3, 3),
        site_xpos=z(m.nsite, 3), site_xmat=z(m.nsite, 3, 3),
        subtree_com=z(nbody, 3),
        cvel=z(nbody, 6), cdof=z(nv, 6), cdof_dot=z(nv, 6),
        qM=z(nv, nv), qLD=z(nv, nv),
        qfrc_bias=z(nv), qfrc_passive=z(nv), qfrc_spring=z(nv),
        qfrc_damper=z(nv), qfrc_gravcomp=z(nv), qfrc_smooth=z(nv),
        qacc_smooth=z(nv), qfrc_constraint=z(nv), qfrc_inverse=z(nv),
        contact=contact, ncon=full((), 0, torch.int32),
        efc_J=z(nefc, nv), efc_D=z(nefc), efc_aref=z(nefc), efc_R=z(nefc),
        efc_frictionloss=z(nefc),
        efc_floss_active=full((nefc,), False, torch.bool),
        efc_active=full((nefc,), False, torch.bool),
        efc_type=full((nefc,), 0, torch.int32),
        efc_force=z(nefc),
        sensordata=z(m.nsensordata),
        energy=z(2),
    )


def set_const(m: Model) -> Model:
    """Compute qpos0-derived constants: dof/body invweight0 (mj_setConst).

    Takes and returns a host (numpy-leaf) model, as models/compile.py
    builds it; the computation runs in float64 on the CPU.  These feed the
    constraint regularization diagApprox (ops/constraint.py).
    """
    if m.ntendon:
        raise NotImplementedError(
            "tendon constants are not ported yet (ROADMAP §A.7)")
    if m.nu:
        raise NotImplementedError(
            "actuator constants are not ported yet (ROADMAP §A.7, "
            "actuation)")
    mt = put_model(m, torch.float64, "cpu")
    qpos0 = mt.qpos0[None]
    kin = smooth.kinematics(mt, qpos0)
    com = smooth.com_pos(mt, kin)
    qM = smooth.crb(mt, com)[0]
    Minv = torch.linalg.inv(qM)
    dof_invweight0 = torch.diagonal(Minv)

    origin = com["subtree_com"][0][mt.layout.dev.body_rootid]
    cdof = com["cdof"][0]
    ang, lin = cdof[:, :3], cdof[:, 3:]
    mask = mt.ancestor_mask                          # (nbody, nv)
    r = kin["xipos"][0] - origin                     # (nbody, 3)
    # translational jacobian at body COM: (nbody, 3, nv)
    Jt = (lin.T[None] + mm.cross(ang[None, :, :],
                                  r[:, None, :]).transpose(-1, -2))
    Jt = Jt * mask[:, None, :]
    Jr = ang.T[None] * mask[:, None, :]
    At = torch.einsum("biv,vw,biw->b", Jt, Minv, Jt) / 3.0
    Ar = torch.einsum("biv,vw,biw->b", Jr, Minv, Jr) / 3.0
    body_invweight0 = torch.stack([At, Ar], dim=-1)
    return m.replace(dof_invweight0=dof_invweight0.numpy(),
                     body_invweight0=body_invweight0.numpy())


def _com_dict(m: Model, d: Data) -> dict:
    return dict(subtree_com=d.subtree_com,
                origin=d.subtree_com[:, m.layout.dev.body_rootid],
                cdof=d.cdof)


def fwd_position(m: Model, d: Data) -> Data:
    kin = smooth.kinematics(m, d.qpos, d.mocap_pos, d.mocap_quat)
    com = smooth.com_pos(m, kin, d.body_mass, d.body_inertia)
    qM = smooth.crb(m, com)
    if m.opt.noslip_iterations > 0:
        raise NotImplementedError(
            "noslip is not ported yet (ROADMAP §A.7); it needs the qLD "
            "factor that the kernel path leaves at zero")
    if qM.device.type == "cuda":
        # the factor is fused into each kernel solve (chol_solve); qLD
        # stays ZERO, as on the JAX package's TPU path
        qLD = torch.zeros_like(qM)
    else:
        qLD = smooth.factor_chol(qM)
    d = d.replace(
        xpos=kin["xpos"], xquat=kin["xquat"], xipos=kin["xipos"],
        ximat=kin["ximat"], xanchor=kin["xanchor"], xaxis=kin["xaxis"],
        geom_xpos=kin["geom_xpos"], geom_xmat=kin["geom_xmat"],
        site_xpos=kin["site_xpos"], site_xmat=kin["site_xmat"],
        subtree_com=com["subtree_com"], cdof=com["cdof"],
        qM=qM, qLD=qLD,
    )
    if m.ntendon:
        raise NotImplementedError("tendons are not ported yet (ROADMAP §A.7)")
    # collision + constraint assembly
    from mujoco_sim_tpu_torch.ops import collision as collision_mod
    from mujoco_sim_tpu_torch.ops import constraint as constraint_mod
    d = collision_mod.collision(m, d)
    d = constraint_mod.make_constraint(m, d, com)
    return d


def fwd_velocity(m: Model, d: Data) -> Data:
    com = _com_dict(m, d)
    com_full = dict(com, cinert=_cinert(m, d))
    vel = smooth.com_vel(m, com_full, d.qvel)
    qfrc_bias = smooth.rne(m, com_full, vel, d.qvel)
    qfrc_passive, qsp, qdm, qgc = passive_mod.passive(
        m, com, d.qpos, d.qvel, d.xipos, d.body_mass)
    return d.replace(cvel=vel["cvel"], cdof_dot=vel["cdof_dot"],
                     qfrc_bias=qfrc_bias, qfrc_passive=qfrc_passive,
                     qfrc_spring=qsp, qfrc_damper=qdm, qfrc_gravcomp=qgc)


def _cinert(m: Model, d: Data):
    dtype = d.qpos.dtype
    # R diag(I) R^T as broadcast-multiply + reduce (the JAX package's form)
    RI = d.ximat * d.body_inertia.to(dtype)[..., None, :]
    inert_world = (RI[..., :, None, :] * d.ximat[..., None, :, :]).sum(-1)
    origin = d.subtree_com[:, m.layout.dev.body_rootid]
    return mm.spatial_inertia(d.body_mass.to(dtype), inert_world,
                              d.xipos - origin)


def fwd_actuation(m: Model, d: Data) -> Data:
    """mj_fwdActuation equivalent; only the actuator-free case is ported."""
    if m.nu == 0:
        return d
    raise NotImplementedError(
        "actuation is not ported yet (ROADMAP §A.7, next module)")


def fwd_acceleration(m: Model, d: Data) -> Data:
    com = _com_dict(m, d)
    qfrc_x = support.xfrc_accumulate(m, com, d.xipos, d.xfrc_applied)
    qfrc_smooth = (d.qfrc_passive + d.qfrc_actuator + d.qfrc_applied
                   + qfrc_x - d.qfrc_bias)
    # CPU: cholesky(qM) is the very factor stored in qLD, so this equals
    # the JAX CPU path's solve_chol(qLD, .); CUDA: the fused kernel
    qacc_smooth = chol.chol_solve(d.qM, qfrc_smooth)
    return d.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=qacc_smooth)


def fwd_constraint(m: Model, d: Data) -> Data:
    from mujoco_sim_tpu_torch.ops import solver as solver_mod
    if m.nefc_max == 0 or (m.opt.disableflags & int(DisableBit.CONSTRAINT)):
        return d.replace(qacc=d.qacc_smooth,
                         qfrc_constraint=torch.zeros_like(d.qacc_smooth))
    return solver_mod.solve(m, d)


def forward_core(m: Model, d: Data) -> Data:
    d = fwd_position(m, d)
    d = fwd_velocity(m, d)
    d = fwd_actuation(m, d)
    d = fwd_acceleration(m, d)
    d = fwd_constraint(m, d)
    return d


def forward(m: Model, d: Data) -> Data:
    """Full forward dynamics + derived outputs (mj_forward equivalent)."""
    d = forward_core(m, d)
    d = sensor_energy(m, d)
    return d


def _energy_plan_np(m: Model):
    lay = m.layout
    out = []
    for jt in (JointType.SLIDE, JointType.HINGE, JointType.BALL):
        jsel = np.nonzero(lay.jnt_type == int(jt))[0]
        if len(jsel):
            out.append((int(jt), jsel, lay.jnt_qposadr[jsel]))
    return out


def sensor_energy(m: Model, d: Data) -> Data:
    dtype = d.qpos.dtype
    g = m.opt.gravity.to(dtype)
    mass = d.body_mass.to(dtype)
    potential = -(mass * (d.xipos @ g)).sum(-1)
    # joint springs
    spring = torch.zeros_like(potential)
    stiffness = m.jnt_stiffness.to(dtype)
    qspring = m.qpos_spring.to(dtype)
    ar4 = torch.arange(4, device=d.qpos.device)
    for jt, jsel, qadr in m.layout.const("energyplan",
                                         lambda: _energy_plan_np(m), dtype):
        k = stiffness[jsel]
        if jt == int(JointType.BALL):
            q = d.qpos[:, qadr[:, None] + ar4]
            qref = qspring[qadr[:, None] + ar4]
            rot = mm.quat_sub(q, qref)
            spring = spring + 0.5 * (k * (rot * rot).sum(-1)).sum(-1)
        else:
            disp = d.qpos[:, qadr] - qspring[qadr]
            spring = spring + 0.5 * (k * disp * disp).sum(-1)
    kinetic = 0.5 * torch.einsum("zv,zvw,zw->z", d.qvel, d.qM, d.qvel)
    d = d.replace(energy=torch.stack([potential + spring, kinetic], dim=-1))
    from mujoco_sim_tpu_torch.ops import sensor as sensor_mod
    return sensor_mod.sensors(m, d)


def _dof_active(m: Model, d: Data) -> torch.Tensor:
    """Dofs of masked-out (despawned) bodies are frozen."""
    return d.body_active[:, m.layout.dev.dof_bodyid]


def _euler(m: Model, d: Data) -> Data:
    dtype = d.qpos.dtype
    h = m.opt.timestep.to(dtype)
    # implicit joint damping: (M + h*diag(B)) qacc' = qfrc_smooth +
    # qfrc_constraint (matches mj_Euler; qfrc_smooth already contains the
    # explicit -B qvel)
    MhB = d.qM + torch.diag(h * m.dof_damping.to(dtype))
    rhs = d.qfrc_smooth + d.qfrc_constraint
    qacc = chol.chol_solve(MhB, rhs)
    qvel = torch.where(_dof_active(m, d), d.qvel + h * qacc, 0.0)
    qpos = integrate_mod.integrate_pos(m, d.qpos, qvel, h)
    return d.replace(qpos=qpos, qvel=qvel, act=_advance_act(m, d, h),
                     time=d.time + h)


def _advance_act(m: Model, d: Data, h) -> torch.Tensor:
    if m.nu == 0:
        return d.act
    raise NotImplementedError(
        "activation dynamics are not ported yet (ROADMAP §A.7)")


def step(m: Model, d: Data) -> Data:
    """One physics step for every env (mj_step equivalent)."""
    d = forward(m, d)
    d = d.replace(qacc_warmstart=d.qacc)
    if m.opt.integrator != int(Integrator.EULER):
        raise NotImplementedError(
            f"integrator {Integrator(m.opt.integrator).name} is not ported "
            "yet (ROADMAP §A.7)")
    return _euler(m, d)
