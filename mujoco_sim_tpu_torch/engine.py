"""Public engine API: put_model, make_data, forward, step, inverse.

Torch port of mujoco_sim_tpu/engine.py.  All functions are pure,
``d' = f(m, d)``; batching is an explicit leading env axis on every Data
leaf (the JAX package vmaps a per-env step instead).  Each function takes
its device and dtype from the model and data it is given.

The SPD solves of the step (qacc_smooth, the Euler velocity update, every
Newton direction) go through ops/chol.chol_solve, which launches the
hand-written CUDA kernel for CUDA tensors and takes its plain twin for CPU
tensors: the path is chosen by device, not by a switch.  With the kernel,
``qLD`` stays all-zero (the factor is fused into each solve and never
materialized), as on the JAX package's TPU path; only with
``noslip_iterations > 0`` is the factor itself needed, and then ``qLD`` is
the real factor on every device (ops/chol_factor: a second hand-written
kernel on the card).

Tendons (fixed and spatial, with wraps and pulleys), site and tendon
transmissions, heightfields and fluid drag run as in the JAX package; the
runtime and server above the step are in runtime/ and io/, the
multi-device layers in parallel/.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_sim_tpu_torch.models.model import (
    Model, Data, Contact, Integrator, DisableBit, JointType, DynType,
    GainType, BiasType, TrnType,
)
from mujoco_sim_tpu_torch.ops import chol, smooth, support
from mujoco_sim_tpu_torch.ops import tendon as tendon_mod
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


def put_model(m: Model, dtype=torch.float32, device="cuda") -> Model:
    """Cast float leaves to ``dtype`` and move every leaf to ``device``
    (the card unless the caller names another; without a CUDA device the
    default raises, it never carries on on the CPU by itself).

    Integer leaves become torch.long, bool leaves stay bool.  The Layout's
    index arrays are moved to the device once (``Layout.to``), so the step
    makes no host->device copies of static indices.  On a CUDA device TF32
    is switched off (true f32 matmuls).
    """
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "put_model: no CUDA device; pass device=\"cpu\" to run on "
                "the CPU")
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


def make_data(m: Model, nenv: int, dtype=None, keyframe=None) -> Data:
    """Fresh Data at qpos0 for ``nenv`` envs (mj_makeData + reset), every
    leaf with a leading env axis, on the model's device.

    keyframe: optional <keyframe><key> name or index; every env of the
    returned Data starts from that snapshot (mj_resetDataKeyframe)."""
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
    d = Data(
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
    if keyframe is not None:
        kid = (m.names.key_id(keyframe) if isinstance(keyframe, str)
               else int(keyframe))
        if kid < 0 or kid >= m.nkey:
            raise ValueError(f"unknown keyframe {keyframe!r}")
        d = d.replace(
            time=tile(m.key_time[kid]), qpos=tile(m.key_qpos[kid]),
            qvel=tile(m.key_qvel[kid]), act=tile(m.key_act[kid]),
            ctrl=tile(m.key_ctrl[kid]), mocap_pos=tile(m.key_mpos[kid]),
            mocap_quat=tile(m.key_mquat[kid]))
    return d


def set_const(m: Model) -> Model:
    """Compute qpos0-derived constants: dof/body/tendon invweight0, the
    tendon lengths at qpos0 and spatial springlength defaults, and
    actuator_acc0 (mj_setConst).

    Takes and returns a host (numpy-leaf) model, as models/compile.py
    builds it; the computation runs in float64 on the CPU.  The
    invweights feed the constraint regularization diagApprox
    (ops/constraint.py).
    """
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
    springlength = torch.tensor(np.asarray(m.ten_springlength, np.float64))
    if m.ntendon:
        length0, W = tendon_mod.tendon_quantities(
            mt, qpos0, kin["site_xpos"], cdof[None],
            com["subtree_com"][:, mt.layout.dev.body_rootid],
            kin["geom_xpos"], kin["geom_xmat"], mt.geom_size[None])
        length0, W = length0[0], W[0]
        ten_invweight0 = ((W @ Minv) * W).sum(-1)
        # spatial-tendon springlength defaults were NaN-marked at compile
        # (the wrap path needs the full qpos0 evaluation)
        springlength = torch.where(torch.isnan(springlength),
                                   length0[:, None], springlength)
    else:
        W = None
        ten_invweight0 = length0 = torch.zeros(0, dtype=torch.float64)
    # actuator_acc0 = |M^-1 moment| at qpos0: joint transmissions take the
    # static 0/1 dof mask scaled by gear[0], tendon transmissions gear[0]
    # times the tendon's moment row; site rows stay 0 (a muscle on a site
    # needs an explicit lengthrange, models/compile.py)
    lay = m.layout
    mom = (torch.as_tensor(lay.act_moment01, dtype=torch.float64)
           * mt.actuator_gear[:, :1])
    ten_rows = np.nonzero(lay.act_trntype == int(TrnType.TENDON))[0]
    if len(ten_rows) and W is not None:
        mom[ten_rows] = (mt.actuator_gear[ten_rows, :1]
                         * W[lay.act_trnid[ten_rows]])
    acc0 = torch.linalg.norm(mom @ Minv, dim=-1)
    return m.replace(dof_invweight0=dof_invweight0.numpy(),
                     body_invweight0=body_invweight0.numpy(),
                     ten_invweight0=ten_invweight0.numpy(),
                     ten_springlength=springlength.numpy(),
                     ten_length0=length0.numpy(),
                     actuator_acc0=acc0.numpy())


def _com_dict(m: Model, d: Data) -> dict:
    return dict(subtree_com=d.subtree_com,
                origin=d.subtree_com[:, m.layout.dev.body_rootid],
                cdof=d.cdof)


def fwd_position(m: Model, d: Data) -> Data:
    kin = smooth.kinematics(m, d.qpos, d.mocap_pos, d.mocap_quat)
    com = smooth.com_pos(m, kin, d.body_mass, d.body_inertia)
    qM = smooth.crb(m, com)
    if qM.device.type == "cuda" and m.opt.noslip_iterations == 0:
        # the factor is fused into each kernel solve (chol_solve); qLD
        # stays ZERO, as on the JAX package's TPU path.  Only noslip's
        # matrix-RHS solve needs the factor itself.
        qLD = torch.zeros_like(qM)
    else:
        # CUDA: the hand-written chol_factor kernel; CPU: linalg.cholesky
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
        d = _tendon(m, d)
    # collision + constraint assembly
    from mujoco_sim_tpu_torch.ops import collision as collision_mod
    from mujoco_sim_tpu_torch.ops import constraint as constraint_mod
    d = collision_mod.collision(m, d)
    d = constraint_mod.make_constraint(m, d, com)
    return d


def _tendon(m: Model, d: Data) -> Data:
    """The tendon stage of fwd_position: lengths, moment rows and
    velocities from the kinematics already in d."""
    tlen, tJ = tendon_mod.tendon_quantities(
        m, d.qpos, d.site_xpos, d.cdof,
        d.subtree_com[:, m.layout.dev.body_rootid],
        d.geom_xpos, d.geom_xmat, d.geom_size)
    return d.replace(ten_length=tlen, ten_J=tJ,
                     ten_velocity=torch.einsum("btv,bv->bt", tJ, d.qvel))


def fwd_velocity(m: Model, d: Data) -> Data:
    com = _com_dict(m, d)
    com_full = dict(com, cinert=_cinert(m, d))
    vel = smooth.com_vel(m, com_full, d.qvel)
    qfrc_bias = smooth.rne(m, com_full, vel, d.qvel)
    ten = ((d.ten_length, d.ten_velocity, d.ten_J) if m.ntendon else None)
    fluid_state = ((vel["cvel"], d.ximat, d.body_inertia)
                   if m.opt.has_fluid else None)
    qfrc_passive, qsp, qdm, qgc = passive_mod.passive(
        m, com, d.qpos, d.qvel, d.xipos, d.body_mass, ten=ten,
        fluid_state=fluid_state)
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


def _actuation_plan_np(m: Model):
    lay = m.layout
    dyn, gt, bt = lay.act_dyntype, lay.act_gaintype, lay.act_biastype
    ball = np.nonzero(
        (lay.act_trntype == int(TrnType.JOINT)) & (lay.act_trnjnt >= 0)
        & (lay.jnt_type[np.maximum(lay.act_trnjnt, 0)]
           == int(JointType.BALL)))[0]
    ten = np.nonzero(lay.act_trntype == int(TrnType.TENDON))[0]
    site = np.nonzero(lay.act_trntype == int(TrnType.SITE))[0]
    sid = lay.act_trnid[site]
    rid = lay.act_refid[site]
    has_ref = rid >= 0
    rid_s = np.where(has_ref, rid, 0)
    bs = lay.site_bodyid[sid]
    br = lay.site_bodyid[rid_s]
    return dict(
        ten_rows=ten.astype(np.int64),
        ten_id=lay.act_trnid[ten].astype(np.int64),
        site_rows=site.astype(np.int64), site_id=sid.astype(np.int64),
        ref_id=rid_s.astype(np.int64), has_ref=has_ref.astype(bool),
        site_body=bs.astype(np.int64), ref_body=br.astype(np.int64),
        site_root=lay.body_rootid[bs].astype(np.int64),
        ref_root=lay.body_rootid[br].astype(np.int64),
        moment01=np.asarray(lay.act_moment01, np.float64),
        g0eff=np.asarray(lay.act_gear0_eff, np.float64),
        len_valid=np.asarray(lay.act_len_valid, np.float64),
        qposadr=np.asarray(lay.act_qposadr, np.int64),
        ball_rows=ball.astype(np.int64),
        ball_qadr=(lay.act_qposadr[ball][:, None]
                   + np.arange(4)).astype(np.int64),
        ctrllimited=np.asarray(lay.act_ctrllimited, bool),
        forcelimited=np.asarray(lay.act_forcelimited, bool),
        actlimited=np.asarray(lay.act_actlimited, bool),
        is_int=dyn == int(DynType.INTEGRATOR),
        is_filt=dyn == int(DynType.FILTER),
        is_fex=dyn == int(DynType.FILTEREXACT),
        is_mus=dyn == int(DynType.MUSCLE),
        has_act=dyn != int(DynType.NONE),
        gain_aff=gt == int(GainType.AFFINE),
        bias_aff=bt == int(BiasType.AFFINE),
        gain_mus=gt == int(GainType.MUSCLE),
        bias_mus=bt == int(BiasType.MUSCLE))


def fwd_actuation(m: Model, d: Data) -> Data:
    """mj_fwdActuation equivalent: ctrl clamp -> activation dynamics ->
    affine gain/bias force -> force clamp -> moment^T into dof space.

    All shortcut actuators (motor/position/velocity/damper/intvelocity)
    are the fixed/affine gain + none/affine bias special cases, so the
    whole set is one branch-free vectorized formula; joint transmissions
    make the moment matrix a STATIC 0/1 dof mask scaled by gear[0]
    (Layout.act_moment01), so their qfrc_actuator is a single matmul.
    Tendon rows read the tendon's length and velocity and take gear[0]
    times its moment row; site rows take the site jacobian (minus the
    refsite's) in the site/refsite frame dotted with the 6D gear."""
    if m.nu == 0:
        return d
    dtype = d.qpos.dtype
    pl = m.layout.const("actuation", lambda: _actuation_plan_np(m), dtype)
    lay = m.layout
    gear = m.actuator_gear.to(dtype)
    gear0 = gear[:, 0]
    # scalar-joint rows: length/velocity = gear0 * joint state; free/ball
    # rows read length 0 and velocity = (gear vector) . qvel via moment01
    # (act_gear0_eff = 1 there, the gear is folded into moment01)
    g0eff, moment01 = pl["g0eff"], pl["moment01"]
    length = d.qpos[:, pl["qposadr"]] * gear0 * pl["len_valid"]
    velocity = g0eff * (d.qvel @ moment01.T)
    # ball-joint rows: length = gear[:3] . rotation vector of the joint
    # quaternion (mju_quat2Vel semantics, wrapped to [-pi, pi])
    if len(pl["ball_rows"]):
        rows = pl["ball_rows"]
        q = mm.quat_normalize(d.qpos[:, pl["ball_qadr"]])
        sin_half = torch.sqrt((q[..., 1:] ** 2).sum(-1) + 1e-30)
        ang = 2.0 * torch.atan2(sin_half, q[..., 0])
        ang = torch.where(ang > torch.pi, ang - 2.0 * torch.pi, ang)
        rv = q[..., 1:] / sin_half[..., None] * ang[..., None]
        length = length.index_copy(1, rows, (gear[rows, :3] * rv).sum(-1))

    # tendon transmissions: length/velocity are gathers of the tendon
    # state, the moment row is gear0 * ten_J
    moment_ten = None
    if len(pl["ten_rows"]):
        rows, tid = pl["ten_rows"], pl["ten_id"]
        length = length.index_copy(1, rows, gear0[rows] * d.ten_length[:, tid])
        velocity = velocity.index_copy(1, rows,
                                       gear0[rows] * d.ten_velocity[:, tid])
        moment_ten = gear0[rows, None] * d.ten_J[:, tid]      # (B, nt, nv)

    # site transmissions (mjTRN_SITE): the moment row is the site jacobian
    # (minus the refsite's, if any) expressed in the site/refsite frame and
    # dotted with the 6D gear; the refsite length's rotation part composes
    # each site's quat OFFSET-FIRST with its body xquat (site_quat o xquat,
    # not the xmat chain order) and takes subQuat in the refsite frame
    moment_site = None
    if len(pl["site_rows"]):
        from mujoco_sim_tpu_torch.ops.constraint import (_point_jacobian,
                                                         _rot_jacobian)
        rows, sid, rid = pl["site_rows"], pl["site_id"], pl["ref_id"]
        bs, br = pl["site_body"], pl["ref_body"]
        origin_s = d.subtree_com[:, pl["site_root"]]
        origin_r = d.subtree_com[:, pl["ref_root"]]
        ps, Rs = d.site_xpos[:, sid], d.site_xmat[:, sid]
        pr, Rr = d.site_xpos[:, rid], d.site_xmat[:, rid]
        gearS = gear[rows]                                     # (ns, 6)
        href = pl["has_ref"].to(dtype)[:, None, None]
        jacp = (_point_jacobian(m, d.cdof, ps, bs, origin_s)
                - href * _point_jacobian(m, d.cdof, pr, br, origin_r))
        jacr = (_rot_jacobian(m, d.cdof, bs)
                - href * _rot_jacobian(m, d.cdof, br))
        R_use = torch.where(href > 0.5, Rr, Rs)               # (B, ns, 3, 3)
        # local jacobian rows R^T J
        jl_p = (R_use[..., :, :, None] * jacp[..., :, None, :]).sum(-3)
        jl_r = (R_use[..., :, :, None] * jacr[..., :, None, :]).sum(-3)
        moment_site = ((gearS[:, :3, None] * jl_p).sum(-2)
                       + (gearS[:, 3:, None] * jl_r).sum(-2))  # (B, ns, nv)
        # length (0 without refsite)
        qts = mm.quat_mul(m.site_quat.to(dtype)[sid], d.xquat[:, bs])
        qtr = mm.quat_mul(m.site_quat.to(dtype)[rid], d.xquat[:, br])
        rotvec = mm.quat_sub(qts, qtr)
        dp_ref = (Rr * (ps - pr)[..., :, None]).sum(-2)       # R_r^T dp
        len_site = ((gearS[:, :3] * dp_ref).sum(-1)
                    + (gearS[:, 3:] * rotvec).sum(-1))
        len_site = torch.where(pl["has_ref"], len_site, 0.0)
        vel_site = (moment_site * d.qvel[:, None, :]).sum(-1)
        length = length.index_copy(1, rows, len_site)
        velocity = velocity.index_copy(1, rows, vel_site)

    ctrl = d.ctrl.to(dtype)
    cr = m.actuator_ctrlrange.to(dtype)
    ctrl = torch.where(pl["ctrllimited"],
                       torch.minimum(torch.maximum(ctrl, cr[:, 0]), cr[:, 1]),
                       ctrl)
    act = d.act.to(dtype)
    dprm = m.actuator_dynprm.to(dtype)
    tau = torch.clamp(dprm[:, 0], min=1e-12)
    h = m.opt.timestep.to(dtype)
    filt_dot = (ctrl - act) / tau
    # filterexact folds the exact exponential update into act_dot so the
    # integrators' plain act += h*act_dot advance reproduces it
    fex_dot = ((ctrl - act) * (1.0 - torch.exp(-h / tau))
               / torch.clamp(h, min=1e-12))
    # muscle activation (mju_muscleDynamics, zero smoothing width): tau
    # scales with activation, asymmetric for act/deact
    cclamp = torch.clamp(ctrl, 0.0, 1.0)
    tau_m = torch.where(cclamp > act,
                        tau * (0.5 + 1.5 * act),
                        torch.clamp(dprm[:, 1], min=1e-12)
                        / torch.clamp(0.5 + 1.5 * act, min=1e-12))
    mus_dot = (cclamp - act) / tau_m
    zero = torch.zeros_like(ctrl)
    act_dot = torch.where(
        pl["is_int"], ctrl,
        torch.where(pl["is_filt"], filt_dot,
                    torch.where(pl["is_fex"], fex_dot,
                                torch.where(pl["is_mus"], mus_dot, zero))))
    inp = torch.where(pl["has_act"], act, ctrl)
    gp = m.actuator_gainprm.to(dtype)
    gain = gp[:, 0] + torch.where(
        pl["gain_aff"], gp[:, 1] * length + gp[:, 2] * velocity, zero)
    bp = m.actuator_biasprm.to(dtype)
    bias = torch.where(
        pl["bias_aff"], bp[:, 0] + bp[:, 1] * length + bp[:, 2] * velocity,
        zero)

    if (lay.act_gaintype == int(GainType.MUSCLE)).any() or (
            lay.act_biastype == int(BiasType.MUSCLE)).any():
        # mju_muscleGain/Bias FLV curves: normalized length L in L0 units,
        # FL bump(lmin,1,lmax), FV piecewise quadratic saturating at fvmax,
        # FP half-quadratic-then-linear scaled by fpmax
        lr = m.actuator_lengthrange.to(dtype)
        acc0 = torch.clamp(m.actuator_acc0.to(dtype), min=1e-12)
        r0, r1 = gp[:, 0], gp[:, 1]
        L0 = (lr[:, 1] - lr[:, 0]) / torch.clamp(r1 - r0, min=1e-12)
        L0s = torch.clamp(L0, min=1e-12)
        L = r0 + (length - lr[:, 0]) / L0s
        V = velocity / (L0s * torch.clamp(gp[:, 6], min=1e-12))
        F0 = torch.where(gp[:, 2] < 0, gp[:, 3] / acc0, gp[:, 2])
        lmin, lmax, fpmax, fvmax = gp[:, 4], gp[:, 5], gp[:, 7], gp[:, 8]
        mid = 1.0
        left = 0.5 * (lmin + mid)
        right = 0.5 * (mid + lmax)
        x_a = (L - lmin) / torch.clamp(left - lmin, min=1e-12)
        x_b = (mid - L) / torch.clamp(mid - left, min=1e-12)
        x_c = (L - mid) / torch.clamp(right - mid, min=1e-12)
        x_d = (lmax - L) / torch.clamp(lmax - right, min=1e-12)
        FL = torch.where(
            (L <= lmin) | (L >= lmax), zero,
            torch.where(L < left, 0.5 * x_a * x_a,
                        torch.where(L < mid, 1.0 - 0.5 * x_b * x_b,
                                    torch.where(L < right,
                                                1.0 - 0.5 * x_c * x_c,
                                                0.5 * x_d * x_d))))
        y = fvmax - 1.0
        FV = torch.where(
            V <= -1.0, zero,
            torch.where(V <= 0.0, (V + 1.0) * (V + 1.0),
                        torch.where(V <= y,
                                    fvmax - (y - V) * (y - V)
                                    / torch.clamp(y, min=1e-12),
                                    fvmax + zero)))
        bmid = 0.5 * (1.0 + lmax)
        x_p = (L - 1.0) / torch.clamp(bmid - 1.0, min=1e-12)
        FP = torch.where(
            L <= 1.0, zero,
            torch.where(L <= bmid, 0.5 * fpmax * x_p * x_p,
                        fpmax * (0.5 + (L - bmid)
                                 / torch.clamp(bmid - 1.0, min=1e-12))))
        gain = torch.where(pl["gain_mus"], -F0 * FL * FV, gain)
        bias = torch.where(pl["bias_mus"], -F0 * FP, bias)

    force = gain * inp + bias
    fr = m.actuator_forcerange.to(dtype)
    force = torch.where(pl["forcelimited"],
                        torch.minimum(torch.maximum(force, fr[:, 0]),
                                      fr[:, 1]), force)
    qfrc = (force * g0eff) @ moment01   # joint rows (site/tendon rows zero)
    if moment_site is not None:
        qfrc = qfrc + torch.einsum("bs,bsv->bv", force[:, pl["site_rows"]],
                                   moment_site)
    if moment_ten is not None:
        qfrc = qfrc + torch.einsum("bs,bsv->bv", force[:, pl["ten_rows"]],
                                   moment_ten)
    return d.replace(act_dot=act_dot, actuator_length=length,
                     actuator_velocity=velocity, actuator_force=force,
                     qfrc_actuator=qfrc)


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
    d = solver_mod.solve(m, d)
    if m.opt.noslip_iterations > 0:
        from mujoco_sim_tpu_torch.ops import noslip as noslip_mod
        d = noslip_mod.noslip(m, d)
    return d


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
    act = d.act + h * d.act_dot
    if m.layout.act_actlimited.any():
        ar = m.actuator_actrange.to(act.dtype)
        act = torch.where(m.layout.dev.act_actlimited,
                          torch.minimum(torch.maximum(act, ar[:, 0]),
                                        ar[:, 1]), act)
    return act


def _implicit(m: Model, d: Data, fast: bool) -> Data:
    """mj_implicit / mj_implicitFast: integrate velocity implicitly using
    d(qfrc)/d(qvel).  implicitfast keeps only the passive-damping derivative
    (with no tendons/actuators/fluid that is diag(dof_damping), making it
    coincide with mj_Euler's implicit-damping form); full implicit also
    differentiates the RNE bias Coriolis term, by forward-mode AD of
    ops/smooth.com_vel + rne: nv ``torch.func.jvp`` columns (one unit
    tangent per dof, shared by all envs, since envs are independent),
    stacked into the (B, nv, nv) Jacobian.  The modified matrix is
    nonsymmetric, so a general LU solve (torch.linalg.solve) is used.
    Fluid drag enters the differentiated force (its jvp columns), tendon
    damping MuJoCo's diagonal approximation diag(sum_t b_t J_t^2)."""
    dtype = d.qpos.dtype
    h = m.opt.timestep.to(dtype)
    MhB = d.qM + torch.diag(h * m.dof_damping.to(dtype))
    rhs = d.qfrc_smooth + d.qfrc_constraint
    if fast:
        qacc = chol.chol_solve(MhB, rhs)
    else:
        com_full = dict(_com_dict(m, d), cinert=_cinert(m, d))

        def frc_of_v(v):
            # everything velocity-dependent whose derivative enters the
            # implicit matrix: RNE bias MINUS the velocity-dependent
            # passive forces (fluid drag) -- mjd_smooth_vel + mjd_passive_vel
            vel = smooth.com_vel(m, com_full, v)
            out = smooth.rne(m, com_full, vel, v)
            if m.opt.has_fluid:
                out = out - passive_mod.fluid(
                    m, com_full, d.xipos, vel["cvel"], d.ximat, d.body_mass,
                    d.body_inertia)
            return out

        cols = []
        for j in range(m.nv):
            tangent = torch.zeros_like(d.qvel)
            tangent[:, j].fill_(1.0)
            cols.append(torch.func.jvp(frc_of_v, (d.qvel,), (tangent,))[1])
        dfrc_dv = torch.stack(cols, dim=-1)   # (B, nv, nv), nonsymmetric
        A = MhB + h * dfrc_dv
        if m.ntendon:
            # tendon damping enters as the DIAGONAL approximation of
            # J^T b J (MuJoCo folds it like joint damping)
            b = m.ten_damping.to(dtype)
            A = A + h * torch.diag_embed((b[:, None] * d.ten_J ** 2).sum(-2))
        # solve_ex: solve's factor without its error check, which reads
        # the info flag on the host (a sync a captured step cannot make)
        qacc = torch.linalg.solve_ex(A, rhs)[0]
    qvel = torch.where(_dof_active(m, d), d.qvel + h * qacc, 0.0)
    qpos = integrate_mod.integrate_pos(m, d.qpos, qvel, h)
    return d.replace(qpos=qpos, qvel=qvel, act=_advance_act(m, d, h),
                     time=d.time + h)


_RK4_A = ((0.5,), (0.0, 0.5), (0.0, 0.0, 1.0))
_RK4_B = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 1.0 / 6.0)


def _rk4(m: Model, d: Data) -> Data:
    """mj_RungeKutta(4): stages re-run forward_core; pos via manifold
    update."""
    h = m.opt.timestep.to(d.qpos.dtype)
    qpos0, qvel0, act0 = d.qpos, d.qvel, d.act
    F = [(d.qvel, d.qacc, d.act_dot)]
    dcur = d
    for i in range(3):
        dq = sum(a * f[0] for a, f in zip(_RK4_A[i], F) if a)
        dv = sum(a * f[1] for a, f in zip(_RK4_A[i], F) if a)
        qpos_i = integrate_mod.integrate_pos(m, qpos0, dq, h)
        qvel_i = qvel0 + h * dv
        # seed each stage's solver with the previous stage's solution:
        # stage states are close, cutting lockstep Newton iterations
        dcur = dcur.replace(qpos=qpos_i, qvel=qvel_i,
                            qacc_warmstart=dcur.qacc)
        if m.nu:
            da = sum(a * f[2] for a, f in zip(_RK4_A[i], F) if a)
            dcur = dcur.replace(act=act0 + h * da)
        dcur = forward_core(m, dcur)
        F.append((dcur.qvel, dcur.qacc, dcur.act_dot))
    dq = sum(b * f[0] for b, f in zip(_RK4_B, F))
    dv = sum(b * f[1] for b, f in zip(_RK4_B, F))
    act = _dof_active(m, d)
    qpos = integrate_mod.integrate_pos(m, qpos0, torch.where(act, dq, 0.0), h)
    qvel = torch.where(act, qvel0 + h * dv, 0.0)
    if m.nu:
        act_new = _advance_act(
            m, d.replace(act=act0,
                         act_dot=sum(b * f[2] for b, f in zip(_RK4_B, F))),
            h)
    else:
        act_new = d.act
    return d.replace(qpos=qpos, qvel=qvel, act=act_new, time=d.time + h)


def _integrate(m: Model, d: Data) -> Data:
    d = d.replace(qacc_warmstart=d.qacc)
    if m.opt.integrator == int(Integrator.RK4):
        return _rk4(m, d)
    if m.opt.integrator == int(Integrator.IMPLICIT):
        return _implicit(m, d, fast=False)
    if m.opt.integrator == int(Integrator.IMPLICITFAST):
        return _implicit(m, d, fast=True)
    return _euler(m, d)


def step(m: Model, d: Data) -> Data:
    """One physics step for every env (mj_step equivalent)."""
    return _integrate(m, forward(m, d))


def step1(m: Model, d: Data) -> Data:
    """Position+velocity stages only: the hook point where controllers run
    between mj_step1 and mj_step2."""
    d = fwd_position(m, d)
    d = fwd_velocity(m, d)
    return d


def step2(m: Model, d: Data) -> Data:
    d = fwd_actuation(m, d)
    d = fwd_acceleration(m, d)
    d = fwd_constraint(m, d)
    d = sensor_energy(m, d)
    return _integrate(m, d)


def step_with_control_eager(m: Model, d: Data, ctrl_fn, *ctrl_args):
    """step1 -> controller -> step2: the controller sees this step's
    kinematics and velocities before the forces are applied.
    ctrl_fn(m, d, *ctrl_args) -> (d, aux).  The eager reference of
    ``step_with_control``."""
    d = step1(m, d)
    d, aux = ctrl_fn(m, d, *ctrl_args)
    d = step2(m, d)
    return d, aux


def step_with_control(m: Model, d: Data, ctrl_fn, *ctrl_args):
    """``step_with_control_eager`` through a StepGraph of its own per
    ctrl_fn (one CUDA graph a step on the card, the controller inside it;
    as a caller of the JAX package jits it with ctrl_fn static).  Every
    leaf of d and of ctrl_args is copied in, since a controller may read
    any of them; ctrl_fn must be torch operations with no host read."""
    from mujoco_sim_tpu_torch.utils import graph

    g = graph.cached("control", ctrl_fn, lambda: graph.StepGraph(
        lambda m_, d_, *a: step_with_control_eager(m_, d_, ctrl_fn, *a),
        all_leaves=True))
    return g(m, d, *ctrl_args)


def inverse(m: Model, d: Data, qacc: torch.Tensor) -> torch.Tensor:
    """Inverse dynamics: applied generalized force (B, nv) that would
    produce qacc (B, nv) (mj_inverse equivalent; used for effort feedback).

    The constraint force is evaluated from the GIVEN qacc by the inverse
    constraint solver (jar = J qacc - aref -> analytic per-row force),
    matching mj_inverse for arbitrary (state, qacc) queries; reusing the
    carried qfrc_constraint is only correct at the solved state."""
    from mujoco_sim_tpu_torch.ops.solver import constraint_force_from_qacc
    d = fwd_position(m, d)
    d = fwd_velocity(m, d)
    _, qfrc_constraint = constraint_force_from_qacc(m, d, qacc)
    return (smooth.mul_m(m, d.qM, qacc) + d.qfrc_bias - d.qfrc_passive
            - qfrc_constraint)
