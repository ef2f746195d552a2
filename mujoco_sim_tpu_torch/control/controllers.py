"""Controller transforms: computed-torque PD, velocity override, odom base.

Port of mujoco_sim_tpu/control/controllers.py over an explicit leading env
axis: the controller state (``PDState``) is (B, nv) per leaf, the gains
(``PDConfig``) are per dof and shared by every env.  These are the
reference's control law (MjSim::controller, mj_sim.cpp:1055-1077;
MjSim::set_odom_vels, mj_sim.cpp:1079-1154); it runs between the position/
velocity stages and the force stages of a step:
``d = step1(m, d); d, st = apply_control(m, d, st, mask); d = step2(m, d)``.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_sim_tpu_torch.models.model import Model, Data
from mujoco_sim_tpu_torch.utils.struct import frozen

_MJMINVAL = 1e-15


@frozen
class PDState:
    """Per-dof PID integrator state + command buffers (MjSim tau/ddq/dq)."""

    ddq: torch.Tensor        # (B, nv) desired accelerations (effort mode)
    dq: torch.Tensor         # (B, nv) desired velocities (velocity mode)
    err_int: torch.Tensor    # (B, nv) integrated position error


def make_pd_state(m: Model, nenv: int, dtype=None) -> PDState:
    dtype = m.dtype if dtype is None else dtype
    z = torch.zeros((nenv, m.nv), dtype=dtype, device=m.device)
    return PDState(ddq=z, dq=z, err_int=z)


@frozen
class PDConfig:
    """Computed-torque PD(+I) on joint position for 1-dof joints.

    kp/kd/ki and the mask are per-dof (nv,) tensors; dof_qposadr maps each
    dof to its qpos entry (valid for hinge/slide dofs)."""

    kp: torch.Tensor
    kd: torch.Tensor
    ki: torch.Tensor
    ctrl_mask: torch.Tensor       # (nv,) 1.0 where computed-torque-controlled
    dof_qposadr: torch.Tensor     # (nv,) long


def pd_config_for_joints(m: Model, joint_names, kp=100.0, kd=10.0, ki=0.0,
                         dtype=None) -> PDConfig:
    """A PDConfig controlling the named (1-dof) joints, on the model's
    device."""
    dtype = m.dtype if dtype is None else dtype
    lay = m.layout
    mask = np.zeros(m.nv)
    kpv = np.zeros(m.nv)
    kdv = np.zeros(m.nv)
    kiv = np.zeros(m.nv)
    dof_qposadr = np.zeros(m.nv, dtype=np.int64)
    for jn in joint_names:
        j = m.names.joint_id(jn)
        if j < 0:
            raise KeyError(f"unknown joint {jn}")
        dof = int(lay.jnt_dofadr[j])
        mask[dof] = 1.0
        kpv[dof] = kp
        kdv[dof] = kd
        kiv[dof] = ki
        dof_qposadr[dof] = int(lay.jnt_qposadr[j])
    # harmless defaults for uncontrolled dofs
    for v in range(m.nv):
        if mask[v] == 0:
            dof_qposadr[v] = int(lay.jnt_qposadr[lay.dof_jntid[v]])

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=m.device)
    return PDConfig(kp=t(kpv), kd=t(kdv), ki=t(kiv), ctrl_mask=t(mask),
                    dof_qposadr=torch.as_tensor(dof_qposadr,
                                                device=m.device))


def pd_accel(cfg: PDConfig, st: PDState, d: Data, qpos_des: torch.Tensor,
             dt) -> PDState:
    """PID on position error -> desired acceleration per controlled dof
    (the net law of a ros effort PID feeding MjHWInterface::write).
    qpos_des: (B, nv) desired position per dof (dof-indexed)."""
    q = d.qpos[:, cfg.dof_qposadr]
    err = qpos_des - q
    err_int = st.err_int + err * dt
    ddq = cfg.kp * err + cfg.kd * (0.0 - d.qvel) + cfg.ki * err_int
    ddq = ddq * cfg.ctrl_mask
    return st.replace(ddq=ddq, err_int=err_int * cfg.ctrl_mask)


def apply_control(m: Model, d: Data, st: PDState,
                  ctrl_mask: torch.Tensor) -> tuple[Data, PDState]:
    """The MjSim::controller law:

    tau = M @ ddq;  tau[controlled] += qfrc_bias[controlled];
    qfrc_applied = tau;  qvel overridden where |dq| > mjMINVAL.
    """
    tau = torch.einsum("bij,bj->bi", d.qM, st.ddq)
    tau = tau + d.qfrc_bias * ctrl_mask
    qvel = torch.where(st.dq.abs() > _MJMINVAL, st.dq, d.qvel)
    d = d.replace(qfrc_applied=tau, qvel=qvel)
    # buffers are consumed (the reference zeroes ddq/dq after applying)
    st = st.replace(ddq=torch.zeros_like(st.ddq), dq=torch.zeros_like(st.dq))
    return d, st


class OdomConfig:
    """Odom joint dof/qpos indices for one robot's base joints.

    Host-side static config.  Order: lin x,y,z then ang x,y,z; -1 where the
    joint is absent (naming: <robot>_{lin,ang}_odom_{x,y,z}_joint,
    mj_sim.cpp:337-420).  The present joints' dof ids and their command
    slots are also kept on ``device``, so a controlled step copies nothing
    from the host."""

    def __init__(self, dof_ids: np.ndarray, qpos_ids: np.ndarray,
                 present: np.ndarray, device="cpu"):
        self.dof_ids = dof_ids
        self.qpos_ids = qpos_ids
        self.present = present
        sel = np.nonzero(present)[0]
        self.dev_ids = torch.as_tensor(dof_ids[sel], device=device)
        self.dev_sel = torch.as_tensor(sel, device=device)


def odom_config(m: Model, robot: str) -> OdomConfig:
    lay = m.layout
    dof_ids = np.full(6, -1)
    qpos_ids = np.zeros(6, dtype=int)
    present = np.zeros(6, dtype=bool)
    order = ["lin_odom_x_joint", "lin_odom_y_joint", "lin_odom_z_joint",
             "ang_odom_x_joint", "ang_odom_y_joint", "ang_odom_z_joint"]
    for i, suffix in enumerate(order):
        j = m.names.joint_id(f"{robot}_{suffix}")
        if j >= 0:
            dof_ids[i] = int(lay.jnt_dofadr[j])
            qpos_ids[i] = int(lay.jnt_qposadr[j])
            present[i] = True
    return OdomConfig(dof_ids, qpos_ids, present, m.device)


def set_odom_vels(m: Model, d: Data, cfg: OdomConfig,
                  cmd_vel: torch.Tensor) -> Data:
    """Base velocity control: body-frame cmd_vel (B, 6) or (6,) = [vx, vy,
    vz, wx, wy, wz] -> world-frame odom qvel.  The linear part is rotated
    per env by Rz(thz)Ry(thy)Rx(thx) of the current odom hinge angles; the
    angular part passes through."""
    B = d.qpos.shape[0]
    cmd_vel = cmd_vel.to(d.qpos.dtype).expand(B, 6)
    zero = torch.zeros_like(d.qpos[:, 0])
    # current odom angles (0 where the hinge is absent; static presence)
    thx, thy, thz = (d.qpos[:, int(cfg.qpos_ids[i])] if cfg.present[i]
                     else zero for i in (3, 4, 5))
    cx, sx = torch.cos(thx), torch.sin(thx)
    cy, sy = torch.cos(thy), torch.sin(thy)
    cz, sz = torch.cos(thz), torch.sin(thz)
    R = torch.stack([
        torch.stack([cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz],
                    -1),
        torch.stack([cy * sz, sx * sy * sz + cx * cz, cx * sy * sz - sx * cz],
                    -1),
        torch.stack([-sy, sx * cy, cx * cy], -1),
    ], -2)                                                  # (B, 3, 3)
    lin_world = torch.einsum("bij,bj->bi", R, cmd_vel[:, :3])
    new_vals = torch.cat([lin_world, cmd_vel[:, 3:6]], dim=-1)
    return d.replace(qvel=d.qvel.index_copy(1, cfg.dev_ids,
                                            new_vals[:, cfg.dev_sel]))
