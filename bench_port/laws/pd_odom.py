"""The config-3 controlled step of a mobile base with an arm (bench.py's
bench_mobile): step1, a computed-torque PD on the arm joints to a
setpoint, apply_control, the base's odom velocities set from a body-frame
command (vx, vy, wz), step2.  Each env draws its command and its arm
setpoints from the seed at the start of each episode.

The same code makes the program's step (captured whole by its step graph)
and the reference's, each with its own engine and controllers.
"""

from __future__ import annotations

import torch

from harness import sims

PD_STATE = ("ddq", "dq", "err_int")


def _arm_dofs(m, p: dict) -> list:
    lay = m.layout
    return [int(lay.jnt_dofadr[m.names.joint_id(j)]) for j in p["arm_joints"]]


def buffers(m, nenv: int, p: dict) -> dict:
    z = lambda *s: torch.zeros((nenv,) + s, dtype=m.dtype, device=m.device)
    return {"cmd": z(6), "qdes": z(m.nv)}


def fill(bufs: dict, draws: dict, m, p: dict):
    cmd = bufs["cmd"]
    cmd[:, 0].copy_(draws["cmd_vx"])
    cmd[:, 1].copy_(draws["cmd_vy"])
    cmd[:, 5].copy_(draws["cmd_wz"])
    for i, dof in enumerate(_arm_dofs(m, p)):
        bufs["qdes"][:, dof].copy_(draws["arm_setpoint"][:, i])


def carry0(ns, m, nenv: int):
    return (ns.engine.make_data(m, nenv),
            ns.controllers.make_pd_state(m, nenv))


def data(carry):
    return carry[0]


def step(ns, m, bufs: dict, p: dict):
    """One controlled step, eager, with ns's engine and controllers."""
    E, C = ns.engine, ns.controllers
    ocfg = C.odom_config(m, p["robot"])
    pdc = C.pd_config_for_joints(m, p["arm_joints"], kp=p["kp"], kd=p["kd"])
    qdes, cmd = bufs["qdes"], bufs["cmd"]

    def one(carry):
        d, st = carry
        d = E.step1(m, d)
        st = C.pd_accel(pdc, st, d, qdes, m.opt.timestep)
        d, st = C.apply_control(m, d, st, pdc.ctrl_mask)
        d = C.set_odom_vels(m, d, ocfg, cmd)
        return E.step2(m, d), st

    return one


def snap(carry, rows) -> dict:
    d, st = carry
    out = sims.snap_data(d, rows)
    out.update({"pd." + k: getattr(st, k).index_select(0, rows)
                for k in PD_STATE})
    return out


def rebuild(ns, m, snap: dict):
    n = snap["qpos"].shape[0]
    cast = lambda v: v.to(m.dtype) if v.is_floating_point() else v
    d = ns.engine.make_data(m, n).replace(
        **{k: cast(snap[k]) for k in sims.STATE})
    st = ns.controllers.make_pd_state(m, n).replace(
        **{k: cast(snap["pd." + k]) for k in PD_STATE})
    return d, st
