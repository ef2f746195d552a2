"""Hardware-interface contract: joint read/write like ros_control RobotHW.

Port of mujoco_sim_tpu/control/hw_interface.py over an explicit leading
env axis (MjHWInterface, mj_hw_interface.cpp): ``read`` reports (position,
velocity, effort) per controlled joint, with effort from inverse dynamics
(mj_inverse, mj_hw_interface.cpp:59-71); ``write`` routes commands into
the controller buffers by mode (mj_hw_interface.cpp:73-91: velocity ->
MjSim::dq, effort/position-PID -> MjSim::ddq).
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from mujoco_sim_tpu_torch.control.controllers import PDState
from mujoco_sim_tpu_torch.models.model import Model, Data


class ControlMode(enum.IntEnum):
    EFFORT = 0      # computed-torque ddq command
    VELOCITY = 1    # direct qvel override
    POSITION = 2    # PD on position -> ddq


def joint_dofs(m: Model, joint_names) -> np.ndarray:
    lay = m.layout
    out = []
    for jn in joint_names:
        j = m.names.joint_id(jn)
        if j < 0:
            raise KeyError(f"unknown joint {jn}")
        out.append(int(lay.jnt_dofadr[j]))
    return np.asarray(out, dtype=int)


def read(m: Model, d: Data, dof_ids: np.ndarray):
    """(position, velocity, effort), each (B, len(dof_ids)).

    effort = qfrc_inverse-style feedback: M qacc + bias - passive -
    constraint at the current state (the reference calls mj_inverse per
    read, mj_hw_interface.cpp:61)."""
    lay = m.layout
    qadr = torch.as_tensor(lay.jnt_qposadr[lay.dof_jntid[dof_ids]],
                           device=d.qpos.device)
    dofs = torch.as_tensor(dof_ids, device=d.qpos.device)
    qfrc_inv = (torch.einsum("bij,bj->bi", d.qM, d.qacc) + d.qfrc_bias
                - d.qfrc_passive - d.qfrc_constraint)
    return d.qpos[:, qadr], d.qvel[:, dofs], qfrc_inv[:, dofs]


def write(st: PDState, dof_ids: np.ndarray, commands: torch.Tensor,
          mode: ControlMode) -> PDState:
    """Route per-joint commands (B, len(dof_ids)) into the controller
    buffers."""
    dofs = torch.as_tensor(dof_ids, device=st.ddq.device)
    if mode == ControlMode.VELOCITY:
        return st.replace(dq=st.dq.index_copy(1, dofs, commands))
    return st.replace(ddq=st.ddq.index_copy(1, dofs, commands))
