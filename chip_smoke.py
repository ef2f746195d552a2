"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path (mujoco_sim_tpu_torch: load_model -> put_model
-> make_data -> rollout of the batched Euler step) on the card, builds its
hand-written kernel from the checkout's own source, holds the kernel
against its plain PyTorch twin, and checks the results.  Run from the root
of a checkout, with one card:

    python3 chip_smoke.py

Each phase prints one line; a phase that fails raises, and the script exits
non-zero.  Without a CUDA device it exits non-zero before printing any
result.  It imports nothing of JAX.  The second-to-last line is the kernel
record (JSON); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BOX = os.path.join(ROOT, "tests", "fixtures", "floor_box.xml")
STACK = os.path.join(ROOT, "tests", "fixtures", "stack.xml")
NENV = 4096
# kernel vs plain twin: |x_kernel - x_plain| <= ATOL + RTOL |x_plain|
# (f32, the two round differently; the band of tests/test_pallas_chol.py)
RTOL = ATOL = 2e-5
# f32 card vs f64 CPU after 200 steps: the band the JAX package's own
# box-drop test holds against the MuJoCo oracle (tests/test_step.py:77)
CROSS_TOL = 2e-3


def phase(name, **fields):
    print(f"[{name}] " + json.dumps(fields), flush=True)


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60)


def environment():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "false); this script never falls back to the CPU")
    from mujoco_sim_tpu_torch.ops import chol
    nvcc = _run([chol._nvcc(), "--version"]).stdout.strip().splitlines()
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).stdout.strip().splitlines()
    phase("env", python=sys.version.split()[0], torch=torch.__version__,
          cuda=torch.version.cuda, nvcc=nvcc[-1] if nvcc else None,
          devices=torch.cuda.device_count())
    # the card's name and power limit, as nvidia-smi prints them
    print(smi[0], flush=True)
    return smi[0]


def build():
    from mujoco_sim_tpu_torch.ops import chol
    t0 = time.perf_counter()
    path = chol.build()
    chol._load()
    phase("build", kernel="chol_solve", source=os.path.relpath(
        chol.SOURCE, ROOT), library=os.path.relpath(path, ROOT),
        seconds=time.perf_counter() - t0)


def _spd(rng, N, n):
    A = rng.standard_normal((N, n, n))
    return A @ A.transpose(0, 2, 1) + n * np.eye(n)


def _median_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_vs_plain():
    from mujoco_sim_tpu_torch.ops import chol
    rng = np.random.default_rng(0)
    cases = [(n, N, False) for n in (6, 12, 42, 49) for N in (130, NENV)]
    cases.append((12, 130, True))         # stiff rows, as test_pallas_chol
    worst_abs, worst_rel = 0.0, 0.0
    for n, N, stiff in cases:
        A = _spd(rng, N, n)
        if stiff:
            A[:, 0, 0] += 1e9
        At = torch.tensor(A, dtype=torch.float32, device="cuda")
        bt = torch.tensor(rng.standard_normal((N, n)), dtype=torch.float32,
                          device="cuda")
        x = chol.chol_solve_cuda(At, bt)
        xp = chol.chol_solve_plain(At, bt)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"kernel output not finite at n={n} N={N}")
        err = (x - xp).abs()
        if bool((err > ATOL + RTOL * xp.abs()).any()):
            raise AssertionError(f"kernel disagrees with plain at n={n} "
                                 f"N={N}: max abs err {float(err.max())}")
        if stiff:
            resid = float(((At @ x[..., None])[..., 0] - bt).abs().max())
            if resid > 1e-2:
                raise AssertionError(f"stiff-row residual {resid}")
        worst_abs = max(worst_abs, float(err.max()))
        worst_rel = max(worst_rel,
                        float(err.max() / xp.abs().max().clamp(min=1e-30)))
    timing = {}
    for n in (6, 42):
        A = torch.tensor(_spd(rng, NENV, n), dtype=torch.float32,
                         device="cuda")
        b = torch.randn(NENV, n, device="cuda")
        timing[n] = (_median_ms(lambda: chol.chol_solve_cuda(A, b)),
                     _median_ms(lambda: chol.chol_solve_plain(A, b)))
    phase("kernel_vs_plain", cases=len(cases), max_abs_err=worst_abs,
          max_rel_err=worst_rel, tolerance=f"atol {ATOL} + rtol {RTOL}",
          stiff_1e9_case="ok",
          ms_n6_N4096={"kernel": timing[6][0], "plain": timing[6][1]},
          ms_n42_N4096={"kernel": timing[42][0], "plain": timing[42][1]})
    return worst_abs, timing


def _jittered(m, nenv, seed, stack=False):
    """bench.py's jitter (numpy, seeded): lift the first body by U(0, 0.3)
    and spin it with U(-0.5, 0.5) rad/s; a stack's upper box is lifted
    alike so the boxes never start interpenetrating."""
    import mujoco_sim_tpu_torch as mst
    rng = np.random.default_rng(seed)
    d = mst.make_data(m, nenv)
    qpos = d.qpos.cpu().numpy().copy()
    qvel = np.zeros((nenv, m.nv), np.float64)
    lift = rng.uniform(0.0, 0.3, nenv)
    qpos[:, 2] += lift
    if stack:
        qpos[:, 9] += lift
    qvel[:, 3:6] = rng.uniform(-0.5, 0.5, (nenv, 3))
    return d, qpos, qvel


def _with_state(d, qpos, qvel):
    return d.replace(qpos=torch.tensor(qpos, dtype=d.qpos.dtype,
                                       device=d.qpos.device),
                     qvel=torch.tensor(qvel, dtype=d.qvel.dtype,
                                       device=d.qvel.device))


def _float_leaves_finite(d):
    from mujoco_sim_tpu_torch.utils.struct import leaf_names
    bad = []
    for name in leaf_names(d):
        v = getattr(d, name)
        if name == "contact":
            bad += [f"contact.{n}" for n in leaf_names(v)
                    if getattr(v, n).is_floating_point()
                    and not bool(torch.isfinite(getattr(v, n)).all())]
        elif v.is_floating_point() and not bool(torch.isfinite(v).all()):
            bad.append(name)
    return bad


def _settled(d, half_lo, z_hi, speed):
    """Every box above the floor (z >= its smallest half-extent - 1 cm),
    below z_hi, and slower than `speed` (m/s and rad/s)."""
    nb = d.qvel.shape[1] // 6
    z = torch.stack([d.qpos[:, 7 * i + 2] for i in range(nb)], 1)
    v = torch.stack([d.qvel[:, 6 * i:6 * i + 6].abs().amax(1)
                     for i in range(nb)], 1)
    ok = (z >= torch.tensor(half_lo, device=z.device) - 0.01) & (z <= z_hi)
    ok &= v < speed
    return ok.all(1), float(z.min()), float(z.max()), float(v.max())


def main_path(card):
    import mujoco_sim_tpu_torch as mst
    from mujoco_sim_tpu_torch.ops import chol
    m = mst.put_model(mst.load_model(BOX), torch.float32, "cuda")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 is on: the step needs true f32 matmuls")
    d, qpos, qvel = _jittered(m, NENV, 0)
    d0 = _with_state(d, qpos, qvel)
    nsteps = 1000

    chol.LAUNCHES = 0
    d = mst.rollout(m, d0, nsteps)
    torch.cuda.synchronize()
    launches = chol.LAUNCHES

    bad = _float_leaves_finite(d)
    if bad:
        raise AssertionError(f"non-finite leaves after the rollout: {bad}")
    if launches < 2 * nsteps:
        raise AssertionError(f"chol_solve ran {launches} times in "
                             f"{nsteps} steps (< 2 per step)")
    if launches == 2 * nsteps:
        raise AssertionError("the Newton solver never reached the kernel")
    # box half-extents (.1, .12, .08): resting on any face puts its centre
    # between 0.08 and 0.12 (minus a little penetration)
    ok, zmin, zmax, vmax = _settled(d, [0.08], 0.12 + 0.01, 0.05)
    if not bool(ok.all()):
        raise AssertionError(f"{int((~ok).sum())} boxes not at rest: z in "
                             f"[{zmin}, {zmax}], max speed {vmax}")
    if not bool((d.qLD == 0).all()):
        raise AssertionError("qLD must stay zero on the kernel path")

    # env-steps/s: the run above is the warm-up; best of 3 timed runs
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mst.rollout(m, d0, nsteps)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    best = min(times)
    phase("main_path", scene="floor_box.xml", nenv=NENV, steps=nsteps,
          chol_launches=launches, launches_per_step=launches / nsteps,
          finite=True, settled=True, z_range=[zmin, zmax], max_speed=vmax,
          rollout_s=times, env_steps_per_s=NENV * nsteps / best, card=card)
    return m, qpos, qvel, launches


def cross_check(m, qpos, qvel):
    import mujoco_sim_tpu_torch as mst
    n, nsteps = 64, 200
    m64 = mst.put_model(mst.load_model(BOX), torch.float64, "cpu")
    outs = []
    for mm_ in (m, m64):
        d = _with_state(mst.make_data(mm_, n), qpos[:n], qvel[:n])
        d = mst.rollout(mm_, d, nsteps)
        outs.append((d.qpos.double().cpu(), d.qvel.double().cpu()))
    dq = float((outs[0][0] - outs[1][0]).abs().max())
    dv = float((outs[0][1] - outs[1][1]).abs().max())
    if not dq <= CROSS_TOL or not dv <= CROSS_TOL:
        raise AssertionError(f"card f32 vs CPU f64 deviation qpos {dq}, "
                             f"qvel {dv} > {CROSS_TOL}")
    phase("cross_check", scene="floor_box.xml", nenv=n, steps=nsteps,
          max_dev_qpos=dq, max_dev_qvel=dv, tolerance=CROSS_TOL)


def second_scene():
    import mujoco_sim_tpu_torch as mst
    from mujoco_sim_tpu_torch.ops import chol
    m = mst.put_model(mst.load_model(STACK), torch.float32, "cuda")
    d, qpos, qvel = _jittered(m, NENV, 1, stack=True)
    nsteps = 200
    before = chol.LAUNCHES
    t0 = time.perf_counter()
    d = mst.rollout(m, _with_state(d, qpos, qvel), nsteps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    bad = _float_leaves_finite(d)
    if bad:
        raise AssertionError(f"non-finite leaves on the stack: {bad}")
    # cube half-extents .1 (lower) and .08 (upper); the stack stands at
    # most 0.1 + 0.2 + 0.08 high
    ok, zmin, zmax, vmax = _settled(d, [0.1, 0.08], 0.38 + 0.01, 0.2)
    if not bool(ok.all()):
        raise AssertionError(f"{int((~ok).sum())} stacks not settled: z in "
                             f"[{zmin}, {zmax}], max speed {vmax}")
    # geom 0 is the floor: contacts between two boxes come from _box_box
    box_box = int((d.contact.active & (d.contact.geom1 > 0)).sum())
    if box_box == 0:
        raise AssertionError("no box-box contact in the stack")
    phase("second_scene", scene="stack.xml", nenv=NENV, steps=nsteps,
          finite=True, settled=True, z_range=[zmin, zmax], max_speed=vmax,
          box_box_contacts=box_box, seconds=secs,
          chol_launches=chol.LAUNCHES - before)


def main():
    card = environment()
    build()
    max_abs_err, timing = kernel_vs_plain()
    m, qpos, qvel, launches = main_path(card)
    cross_check(m, qpos, qvel)
    second_scene()
    print(json.dumps({"kernels": [{
        "name": "chol_solve", "route": "cuda",
        "source": "mujoco_sim_tpu_torch/csrc/chol_solve.cu",
        "replaces": "mujoco_sim_tpu/ops/pallas_chol.py:40",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": timing[6][0], "plain_ms": timing[6][1]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
