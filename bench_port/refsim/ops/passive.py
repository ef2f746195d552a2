"""Frozen copy of mujoco_sim_tpu_torch's CPU path for the benchmark's
plain reference (bench_port/refsim): imports rewritten, CUDA wrappers
and graph capture removed.  Do not import the program from here.

Passive forces: joint and tendon springs and dampers, gravity
compensation, fluid drag (mj_passive).

Port of mujoco_sim_tpu/ops/passive.py over an explicit leading env axis.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from refsim.models.model import Model, JointType, DisableBit
from refsim.ops import math as mm


def _spring_plan_np(m: Model):
    lay = m.layout
    out = []
    for jt in (JointType.FREE, JointType.BALL, JointType.SLIDE,
               JointType.HINGE):
        jsel = np.nonzero(lay.jnt_type == int(jt))[0]
        if len(jsel):
            out.append((int(jt), jsel, lay.jnt_qposadr[jsel],
                        lay.jnt_dofadr[jsel]))
    return out


def spring_damper(m: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                  ten=None):
    """(qfrc_spring, qfrc_damper), each (B, nv).  ten = (length (B, T),
    velocity (B, T), J (B, T, nv)) from the tendon stage, needed when the
    model has tendons."""
    dtype = qpos.dtype
    qfrc_spring = torch.zeros((qpos.shape[0], m.nv), dtype=dtype,
                              device=qpos.device)
    spring = m.qpos_spring.to(dtype)
    stiffness = m.jnt_stiffness.to(dtype)
    ar3 = torch.arange(3, device=qpos.device)
    ar4 = torch.arange(4, device=qpos.device)

    for jt, jsel, qadr, dadr in m.layout.const(
            "springplan", lambda: _spring_plan_np(m), dtype):
        stiff = stiffness[jsel]
        if jt in (int(JointType.SLIDE), int(JointType.HINGE)):
            disp = qpos[:, qadr] - spring[qadr]
            qfrc_spring[:, dadr] += -stiff * disp
        elif jt == int(JointType.BALL):
            q = qpos[:, qadr[:, None] + ar4]
            qref = spring[qadr[:, None] + ar4]
            rot = mm.quat_sub(q, qref)  # local-frame 3D displacement
            for i in range(3):
                qfrc_spring[:, dadr + i] += -stiff * rot[..., i]
        else:  # FREE
            pos = qpos[:, qadr[:, None] + ar3]
            pref = spring[qadr[:, None] + ar3]
            for i in range(3):
                qfrc_spring[:, dadr + i] += -stiff * (pos[..., i]
                                                      - pref[..., i])
            q = qpos[:, qadr[:, None] + 3 + ar4]
            qref = spring[qadr[:, None] + 3 + ar4]
            rot = mm.quat_sub(q, qref)
            for i in range(3):
                qfrc_spring[:, dadr + 3 + i] += -stiff * rot[..., i]

    qfrc_damper = -m.dof_damping.to(dtype) * qvel

    if m.ntendon:
        # tendon spring (with the deadband springlength) + damper,
        # projected through the moment rows (mj_passive tendon terms)
        length, vel, Wv = ten
        sl = m.ten_springlength.to(dtype)
        excess = torch.where(length > sl[:, 1], length - sl[:, 1],
                             torch.where(length < sl[:, 0], length - sl[:, 0],
                                         0.0))
        frc_s = -m.ten_stiffness.to(dtype) * excess
        frc_d = -m.ten_damping.to(dtype) * vel
        qfrc_spring = qfrc_spring + torch.einsum("bt,btv->bv", frc_s, Wv)
        qfrc_damper = qfrc_damper + torch.einsum("bt,btv->bv", frc_d, Wv)
    return qfrc_spring, qfrc_damper


def gravcomp(m: Model, com: dict, xipos: torch.Tensor,
             mass=None) -> torch.Tensor:
    """Anti-gravity force per body scaled by body_gravcomp -> (B, nv)."""
    dtype = xipos.dtype
    g = m.opt.gravity.to(dtype)
    mass = m.body_mass.to(dtype) if mass is None else mass.to(dtype)
    f = (-mass * m.body_gravcomp.to(dtype))[..., None] * g
    r = xipos - com["origin"]
    tau_o = mm.cross(r, f)
    F = torch.cat([tau_o, f.expand_as(tau_o)], dim=-1)
    mask = m.ancestor_mask.to(dtype)
    return torch.einsum("zdu,zbu,bd->zd", com["cdof"], F, mask)


def fluid(m: Model, com: dict, xipos: torch.Tensor, cvel: torch.Tensor,
          ximat: torch.Tensor, mass: torch.Tensor, inertia: torch.Tensor):
    """Inertia-box fluid drag (mj_passive's fluid model): per body, an
    equivalent box r_i = sqrt(3(I_j+I_k-I_i)/(2m)) sees
      viscous:  f = -3 pi d eta v,  tau = -pi d^3 eta w,  d = 2(r0+r1+r2)/3
      density:  f_i = -2 rho r_j r_k |v_i| v_i,
                tau_i = -(rho/2) r_i (r_j^4 + r_k^4) |w_i| w_i
    in the body's INERTIAL frame, with the wind subtracted from v.
    Body leaves are (B, nbody, ...); returns qfrc (B, nv).
    """
    dtype = xipos.dtype
    origin = com["origin"]
    cdof = com["cdof"]
    eta = m.opt.viscosity.to(dtype)
    rho = m.opt.density.to(dtype)
    wind = m.opt.wind.to(dtype)
    mass = mass.to(dtype)
    msafe = torch.clamp(mass, min=1e-12)
    I = inertia.to(dtype)
    Isum = I.sum(-1, keepdim=True)
    r = torch.sqrt(torch.clamp(3.0 * (Isum - 2.0 * I)
                               / (2.0 * msafe[..., None]), min=1e-24))
    # body velocity at xipos, world frame
    w_world = cvel[..., :3]
    v_world = cvel[..., 3:] + mm.cross(w_world, xipos - origin)
    # into the inertial frame (ximat columns = frame axes)
    w_l = (ximat * w_world[..., :, None]).sum(-2)
    v_l = (ximat * (v_world - wind)[..., :, None]).sum(-2)
    diam = 2.0 * r.sum(-1) / 3.0
    f_l = -3.0 * math.pi * eta * diam[..., None] * v_l
    tau_l = -math.pi * eta * (diam ** 3)[..., None] * w_l
    r4 = r ** 4
    rj = torch.roll(r, -1, dims=-1)
    rk = torch.roll(r, -2, dims=-1)
    r4j = torch.roll(r4, -1, dims=-1)
    r4k = torch.roll(r4, -2, dims=-1)
    # |v| v: abs has a zero derivative at 0, as in JAX (the implicit
    # integrator differentiates this force)
    f_l = f_l - 2.0 * rho * rj * rk * v_l.abs() * v_l
    tau_l = tau_l - 0.5 * rho * r * (r4j + r4k) * w_l.abs() * w_l
    live = (mass > 1e-12).to(dtype)[..., None]
    f_w = (ximat * f_l[..., None, :]).sum(-1) * live
    tau_w = (ximat * tau_l[..., None, :]).sum(-1) * live
    # project through the body point/angular jacobians:
    # qfrc_i = sum_b mask * [ang_i . tau_b + (lin_i + ang_i x r_b) . f_b]
    ang, lin = cdof[..., :3], cdof[..., 3:]               # (B, nv, 3)
    maskbv = m.ancestor_mask.to(dtype)                    # (nbody, nv)
    rr = xipos - origin
    lin_at = lin[:, None] + mm.cross(ang[:, None, :, :], rr[:, :, None, :])
    return (maskbv * ((ang[:, None] * tau_w[:, :, None, :]).sum(-1)
                      + (lin_at * f_w[:, :, None, :]).sum(-1))).sum(1)


def passive(m: Model, com: dict, qpos: torch.Tensor, qvel: torch.Tensor,
            xipos: torch.Tensor, mass=None, ten=None, fluid_state=None):
    """(qfrc_passive, qfrc_spring, qfrc_damper, qfrc_gravcomp).
    fluid_state = (cvel, ximat, body_inertia), given when opt.has_fluid."""
    dtype = qpos.dtype
    if m.opt.disableflags & int(DisableBit.PASSIVE):
        z = torch.zeros((qpos.shape[0], m.nv), dtype=dtype,
                        device=qpos.device)
        return z, z, z, z
    qfrc_spring, qfrc_damper = spring_damper(m, qpos, qvel, ten=ten)
    qfrc_gravcomp = gravcomp(m, com, xipos, mass)
    out = qfrc_spring + qfrc_damper + qfrc_gravcomp
    if m.opt.has_fluid and fluid_state is not None:
        cvel, ximat, inertia = fluid_state
        out = out + fluid(m, com, xipos, cvel, ximat, mass, inertia)
    return out, qfrc_spring, qfrc_damper, qfrc_gravcomp
