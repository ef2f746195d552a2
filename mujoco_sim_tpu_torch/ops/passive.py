"""Passive forces: joint springs, dampers, gravity compensation (mj_passive).

Port of mujoco_sim_tpu/ops/passive.py over an explicit leading env axis.
Tendon terms and fluid drag are not ported yet (ROADMAP §A.7).
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_sim_tpu_torch.models.model import Model, JointType, DisableBit
from mujoco_sim_tpu_torch.ops import math as mm


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


def spring_damper(m: Model, qpos: torch.Tensor, qvel: torch.Tensor):
    """(qfrc_spring, qfrc_damper), each (B, nv)."""
    if m.ntendon:
        raise NotImplementedError(
            "tendon springs/dampers are not ported yet (ROADMAP §A.7)")
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


def fluid(*args, **kwargs):
    raise NotImplementedError(
        "fluid drag is not ported yet (ROADMAP §A.7)")


def passive(m: Model, com: dict, qpos: torch.Tensor, qvel: torch.Tensor,
            xipos: torch.Tensor, mass=None):
    """(qfrc_passive, qfrc_spring, qfrc_damper, qfrc_gravcomp)."""
    dtype = qpos.dtype
    if m.opt.disableflags & int(DisableBit.PASSIVE):
        z = torch.zeros((qpos.shape[0], m.nv), dtype=dtype,
                        device=qpos.device)
        return z, z, z, z
    if m.opt.has_fluid:
        fluid()
    qfrc_spring, qfrc_damper = spring_damper(m, qpos, qvel)
    qfrc_gravcomp = gravcomp(m, com, xipos, mass)
    return (qfrc_spring + qfrc_damper + qfrc_gravcomp,
            qfrc_spring, qfrc_damper, qfrc_gravcomp)
