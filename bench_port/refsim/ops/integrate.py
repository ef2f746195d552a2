"""Frozen copy of mujoco_sim_tpu_torch's CPU path for the benchmark's
plain reference (bench_port/refsim): imports rewritten, CUDA wrappers
and graph capture removed.  Do not import the program from here.

Position integration on the joint manifolds (port of
mujoco_sim_tpu/ops/integrate.py), over an explicit leading env axis."""

from __future__ import annotations

import numpy as np
import torch

from refsim.models.model import Model, JointType
from refsim.ops import math as mm


def _plan_np(m: Model):
    lay = m.layout
    out = []
    for jt in (JointType.FREE, JointType.BALL, JointType.SLIDE,
               JointType.HINGE):
        jsel = np.nonzero(lay.jnt_type == int(jt))[0]
        if len(jsel):
            out.append((int(jt), lay.jnt_qposadr[jsel], lay.jnt_dofadr[jsel]))
    return out


def integrate_pos(m: Model, qpos: torch.Tensor, qvel: torch.Tensor,
                  h) -> torch.Tensor:
    """qpos' = qpos ⊞ h*qvel respecting quaternion manifolds
    (mj_integratePos).  qpos (B, nq), qvel (B, nv); returns a new tensor."""
    out = qpos.clone()
    ar3 = torch.arange(3, device=qpos.device)
    ar4 = torch.arange(4, device=qpos.device)
    for jt, qadr, dadr in m.layout.const("intplan", lambda: _plan_np(m),
                                         qpos.dtype):
        if jt in (int(JointType.SLIDE), int(JointType.HINGE)):
            out[:, qadr] += h * qvel[:, dadr]
        elif jt == int(JointType.BALL):
            q = qpos[:, qadr[:, None] + ar4]
            w = qvel[:, dadr[:, None] + ar3]
            out[:, qadr[:, None] + ar4] = mm.quat_integrate(q, w, h)
        else:  # FREE
            v = qvel[:, dadr[:, None] + ar3]
            out[:, qadr[:, None] + ar3] += h * v
            q = qpos[:, qadr[:, None] + 3 + ar4]
            w = qvel[:, dadr[:, None] + 3 + ar3]
            out[:, qadr[:, None] + 3 + ar4] = mm.quat_integrate(q, w, h)
    return out
