"""Where one step of the PyTorch/CUDA port spends its time, on the card.

    PYTHONPATH=. python3 scripts/torch_step_profile.py [manip|box|precise|bighull|terrain] [nenv]

Runs `warm` stirred steps of the scene (default manip_bin6.xml @1024,
float32; ``precise`` is manip_bin6_precise.xml @1024: elliptic cone, noslip,
sensors; ``bighull`` is manip_bin6_bighull.xml @1024: two objects with
256- and 320-vertex hulls; ``terrain`` is tendon_terrain.xml @1024: a
muscle arm on spatial tendons and six objects on a heightfield, stirred
inside each actuator's ctrlrange) to reach a state in contact, then
measures, on that state:

* the host wall time of a plain step (median of 20, each ended by a
  synchronize);
* host-synchronised stage times (each stage run alone, a synchronize after
  it; their sum exceeds the plain step, which overlaps host and device);
* CUDA kernels and device time per step from torch.profiler over 5 steps,
  and the device's busy share against the plain step's wall time;
* host synchronisations per step, counted from the warnings of
  torch.cuda.set_sync_debug_mode("warn");
* launches per step of the hand-written kernels, and their device time
  per step and share of the step's device time.

Prints one JSON object.  Needs a CUDA device; imports no jax.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import mujoco_sim_tpu_torch as mst  # noqa: E402
from mujoco_sim_tpu_torch import engine  # noqa: E402
from mujoco_sim_tpu_torch.ops import (collision, constraint,  # noqa: E402
                                      cuda_build, noslip, sensor, smooth,
                                      solver)
from mujoco_sim_tpu_torch.runtime import profiler  # noqa: E402

SCENES = {"manip": ("manip_bin6.xml", 1024, 150),
          "precise": ("manip_bin6_precise.xml", 1024, 150),
          "bighull": ("manip_bin6_bighull.xml", 1024, 150),
          "terrain": ("tendon_terrain.xml", 1024, 220),
          "box": ("floor_box.xml", 4096, 300)}


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_step_profile: needs a CUDA device")
    scene = sys.argv[1] if len(sys.argv) > 1 else "manip"
    xml, nenv, warm = SCENES[scene]
    if len(sys.argv) > 2:
        nenv = int(sys.argv[2])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    m = mst.put_model(mst.load_model(os.path.join(ROOT, "tests", "fixtures",
                                                  xml)))
    d = mst.make_data(m, nenv)
    if scene == "box":
        qpos = d.qpos.clone()
        qpos[:, 2] = 0.1
        d = d.replace(qpos=qpos)
    phase = torch.tensor(np.random.default_rng(1).uniform(
        0.0, 6.28, (nenv, m.nu)), dtype=m.dtype, device=m.device)

    cr = m.actuator_ctrlrange

    def stir(d_):
        s_ = torch.sin(4.0 * d_.time[:, None] + phase)
        if scene == "terrain":
            # inside each actuator's ctrlrange (muscles: 0.5 + 0.5 sin)
            return cr[:, 0] + (cr[:, 1] - cr[:, 0]) * (0.5 + 0.5 * s_)
        return s_

    ctrl_fn = stir if m.nu else None
    d = mst.rollout(m, d, warm, ctrl_fn=ctrl_fn)
    torch.cuda.synchronize()

    def one_step(d_):
        if ctrl_fn is not None:
            d_ = d_.replace(ctrl=ctrl_fn(d_))
        return engine.step(m, d_)

    step_ms = statistics.median(_sync_time(lambda: one_step(d))[1]
                                for _ in range(20))

    # ---- stages, each alone and synchronised
    stages = {}

    def stage(name, fn):
        out, _ = _sync_time(fn)              # warm
        out, ms = _sync_time(fn)
        stages[name] = ms
        return out

    kin = stage("kinematics_com_crb", lambda: _position_head(m, d))
    if m.ntendon:
        kin = (stage("tendon", lambda: engine._tendon(m, kin[0])), kin[1])
    dpos = stage("collision", lambda: collision.collision(m, kin[0]))
    dcon = stage("make_constraint",
                 lambda: constraint.make_constraint(m, dpos, kin[1]))
    dvel = stage("fwd_velocity", lambda: engine.fwd_velocity(m, dcon))
    dact = stage("fwd_actuation", lambda: engine.fwd_actuation(m, dvel))
    dacc = stage("fwd_acceleration",
                 lambda: engine.fwd_acceleration(m, dact))
    dsol = stage("constraint_solve", lambda: solver.solve(m, dacc))
    if m.opt.noslip_iterations > 0:
        dsol = stage("noslip", lambda: noslip.noslip(m, dsol))
    dene = stage("sensor_energy", lambda: engine.sensor_energy(m, dsol))
    if m.nsensor:
        stage("sensors_alone", lambda: sensor.sensors(m, dsol))
    stage("euler", lambda: engine._euler(m, dene))

    # ---- host syncs per step
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(3):
            one_step(d)
    torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message).lower() for w in caught) / 3

    # ---- the hand-written kernels' launches (the recorder's table), then
    # kernels and device time per step
    nprof = 5
    with profiler.counting(m.device):
        c0 = profiler.counts(m.device)
        for _ in range(nprof):
            one_step(d)
        c1 = profiler.counts(m.device)
    hand = {k: (c1[k] - c0[k]) / nprof for k in profiler.LAUNCH_COUNTS}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(nprof):
            one_step(d)
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.device_time for e in ev) / 1e3 / nprof
    by_name = {}
    for e in ev:
        key = _short(e.name)
        by_name[key] = by_name.get(key, 0.0) + e.device_time
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    # each kernel's __global__ functions, by ops/cuda_build.KERNELS
    slot_of = {g: k.slot for k in cuda_build.KERNELS.values()
               for g in k.functions}
    hand_ms = dict.fromkeys(hand, 0.0)
    for n, v in by_name.items():
        slot = slot_of.get(n.split("::")[-1])
        if slot:
            hand_ms[slot] += v / 1e3 / nprof

    out = dict(
        scene=xml, nenv=nenv, dtype="float32", card=card,
        step_ms=step_ms, env_steps_per_s=nenv / step_ms * 1e3,
        stage_ms_synchronised=stages,
        host_syncs_per_step=syncs,
        cuda_kernels_per_step=len(ev) / nprof,
        device_ms_per_step=dev_ms,
        device_busy_share=dev_ms / step_ms,
        hand_written_kernel_launches_per_step=hand,
        hand_written_kernel_device_ms_per_step=hand_ms,
        hand_written_kernel_device_share={
            k: v / dev_ms for k, v in hand_ms.items()},
        top_device_kernels_ms_per_step={k: v / 1e3 / nprof for k, v in top})
    print(json.dumps(out, indent=1))


def _short(kernel_name):
    """A CUDA kernel's name without its template and call arguments
    (kernels that differ only in those are summed together)."""
    name = kernel_name.replace("void ", "").replace(
        "(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0][:60]


def _position_head(m, d):
    """fwd_position up to (not including) collision: (data, com)."""
    kin = smooth.kinematics(m, d.qpos, d.mocap_pos, d.mocap_quat)
    com = smooth.com_pos(m, kin, d.body_mass, d.body_inertia)
    qM = smooth.crb(m, com)
    qLD = (smooth.factor_chol(qM) if m.opt.noslip_iterations > 0
           else torch.zeros_like(qM))
    d = d.replace(
        xpos=kin["xpos"], xquat=kin["xquat"], xipos=kin["xipos"],
        ximat=kin["ximat"], xanchor=kin["xanchor"], xaxis=kin["xaxis"],
        geom_xpos=kin["geom_xpos"], geom_xmat=kin["geom_xmat"],
        site_xpos=kin["site_xpos"], site_xmat=kin["site_xmat"],
        subtree_com=com["subtree_com"], cdof=com["cdof"],
        qM=qM, qLD=qLD)
    return d, com


if __name__ == "__main__":
    main()
