"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main paths (mujoco_sim_tpu_torch: load_model -> put_model
-> make_data -> rollout of the batched Euler step) on the card: the
primitive-geom box scene at 4096 envs and the contact-rich manipulation
scene (an arm stirring six convex meshes in a bin) at 1024 envs.  Builds
the hand-written kernels from the checkout's own sources, holds each
against its plain PyTorch twin, and checks the results.  Run from the root
of a checkout, with one card:

    python3 chip_smoke.py

Each phase prints one line; a phase that fails raises, and the script exits
non-zero.  Without a CUDA device it exits non-zero before printing any
result.  It imports nothing of JAX.  The second-to-last line is the kernel
record (JSON); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

``python3 chip_smoke.py build kernels`` runs only the named phases (of
env, build, kernels, box, manip) and prints no final record: a quick check
of the kernels alone.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BOX = os.path.join(ROOT, "tests", "fixtures", "floor_box.xml")
STACK = os.path.join(ROOT, "tests", "fixtures", "stack.xml")
MANIP = os.path.join(ROOT, "tests", "fixtures", "manip_bin6.xml")
NENV = 4096
MANIP_NENV = 1024
# chol_solve vs plain twin: |x_kernel - x_plain| <= ATOL + RTOL |x_plain|
# (f32, the two round differently; the band of tests/test_pallas_chol.py)
RTOL = ATOL = 2e-5
# collision kernels vs plain twins: values to HATOL + HRTOL |twin|; an index
# or axis that differs is accepted (and counted) only where the twin's own
# candidates tie within that band
HATOL, HRTOL = 1e-6, 1e-5
# the exact-MTV depth: 2e-5, the band of tests/test_pallas_refine.py.  Its
# cross axes are normalised cross products of edge directions; for two
# nearly parallel edges the f32 cancellation leaves the axis with a relative
# error far above 1e-7, and the depth along it moves with it.  Lanes
# outside the tight band above are counted and printed.
MTV_ATOL = 2e-5
# f32 card vs f64 CPU after 200 steps: the band the JAX package's own
# box-drop test holds against the MuJoCo oracle (tests/test_step.py:77)
CROSS_TOL = 2e-3
# manip, 50 stirred steps, f32 card vs f64 CPU.  The scene is chaotic and
# its contact manifolds pick among near-tied vertices (a resting n-gon
# face, the corners of an eps-wide feature), so a last-bit difference can
# move a contact point by a vertex and an object's orientation by a few
# 1e-3 within ten steps.  2.5e-3 is the band the JAX package's manip test
# holds against the oracle over 50 steps (tests/test_step.py:339-356); it
# must hold for 95% of the qpos entries, and every object must stay within
# 2 cm (a third of its size) of its f64 position.
MANIP_CROSS_TOL = 2.5e-3
MANIP_CROSS_FRACTION = 0.95
MANIP_CROSS_POS_TOL = 2e-2
# published peaks of one H100 SXM: device memory rate and f32 (non tensor
# core) rate, for the least time a kernel's work could take
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def phase(name, **fields):
    print(f"[{name}] " + json.dumps(fields), flush=True)


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60)


def environment():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "false); this script never falls back to the CPU")
    from mujoco_sim_tpu_torch.ops import cuda_build
    nvcc = _run([cuda_build.nvcc(), "--version"]).stdout.strip().splitlines()
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).stdout.strip().splitlines()
    phase("env", python=sys.version.split()[0], torch=torch.__version__,
          cuda=torch.version.cuda, nvcc=nvcc[-1] if nvcc else None,
          devices=torch.cuda.device_count())
    # the card's name and power limit, as nvidia-smi prints them
    print(smi[0], flush=True)
    return smi[0]


def _ptxas(text):
    """registers / shared memory / spills of the kernels in ptxas -v output."""
    out = []
    for m in re.finditer(
            r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, "
            r"(\d+) bytes spill loads.*?Used (\d+) registers"
            r"(?:[^\n]*?(\d+) bytes smem)?", text, re.S):
        out.append(dict(entry=m.group(1), registers=int(m.group(4)),
                        static_smem_bytes=int(m.group(5) or 0),
                        spill_stores=int(m.group(2)),
                        spill_loads=int(m.group(3))))
    return out


def build():
    from mujoco_sim_tpu_torch.ops import (chol, cuda_build, hull_sat,
                                          mtv_query, support_minmax)
    t0 = time.perf_counter()
    info = cuda_build.build_all()
    for mod in (chol, hull_sat, mtv_query, support_minmax):
        mod._load()
    phase("build", wall_seconds=time.perf_counter() - t0, kernels={
        name: dict(source=os.path.relpath(cuda_build.source_path(name), ROOT),
                   library=os.path.relpath(i["path"], ROOT),
                   seconds=i["seconds"], ptxas=_ptxas(i["ptxas"]))
        for name, i in info.items()})


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


def _bound(nbytes, flops):
    """Least time in ms for the work: the larger of bytes over the memory
    rate and flops over the f32 rate, and which of the two it is."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return max(tb, tf), "bytes" if tb >= tf else "operations"


def _cuda(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype, device="cuda")


# --------------------------------------------------------------- chol_solve

def chol_vs_plain():
    from mujoco_sim_tpu_torch.ops import chol
    rng = np.random.default_rng(0)
    cases = [(n, N, False) for n in (6, 12, 42, 49) for N in (130, NENV)]
    cases.append((12, 130, True))         # stiff rows, as test_pallas_chol
    worst_abs, worst_rel = 0.0, 0.0
    for n, N, stiff in cases:
        A = _spd(rng, N, n)
        if stiff:
            A[:, 0, 0] += 1e9
        At = _cuda(A)
        bt = _cuda(rng.standard_normal((N, n)))
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
    for n, N in ((6, NENV), (42, NENV), (42, MANIP_NENV)):
        A = _cuda(_spd(rng, N, n))
        b = torch.randn(N, n, device="cuda")
        bound, by = _bound(N * (n * n + 2 * n) * 4,
                           N * (n ** 3 / 3 + 2 * n * n))
        timing[(n, N)] = dict(
            ms=_median_ms(lambda: chol.chol_solve_cuda(A, b)),
            plain_ms=_median_ms(lambda: chol.chol_solve_plain(A, b)),
            library_ms=_median_ms(lambda: torch.cholesky_solve(
                b[..., None], torch.linalg.cholesky(A))),
            bound_ms=bound, bound_by=by)
    phase("kernel_vs_plain", kernel="chol_solve", cases=len(cases),
          max_abs_err=worst_abs, max_rel_err=worst_rel,
          tolerance=f"atol {ATOL} + rtol {RTOL}", stiff_1e9_case="ok",
          timing={f"n{n}_N{N}": t for (n, N), t in timing.items()})
    return worst_abs, timing


# ----------------------------------------------------- the collision kernels

def _close(a, b, atol=HATOL):
    """a within atol + HRTOL |b| of b elementwise (equal infinities agree)."""
    same_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
    return same_inf | ((a - b).abs() <= atol + HRTOL * b.abs())


def _max_err(a, b):
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float(torch.where(fin, (a - b).abs(), 0.0).max()) if a.numel() \
        else 0.0


def compare_hull_sat(pts, planes, K, mask, lateral, slack, what):
    """Kernel vs twin on CUDA tensors; returns (max abs err, ties)."""
    from mujoco_sim_tpu_torch.ops import hull_sat
    dep, idx, nref, sep = hull_sat.hull_ref_face_depth_cuda(
        pts, planes, K, mask, lateral, slack)
    torch.cuda.synchronize()
    # the twin with one more pick: the (K+1)-th value says whether the K-th
    # pick was a near-tie
    depT, idxT, nrefT, sepT = hull_sat.hull_ref_face_depth_plain(
        pts, planes, min(K + 1, pts.shape[-2] - 1), mask, lateral, slack)
    lane_ok = _close(sep, sepT) & _close(nref, nrefT).all(-1)
    ties = 0
    if not bool(lane_ok.all()):
        # a different reference face: only where the twin's two best faces
        # tie within the band
        vals = hull_sat._pts_vs_planes(pts, planes)
        if mask is not None:
            vals = torch.where(mask[..., :, None] > 0.5, vals, 1e9)
        top2 = vals.amin(-2).topk(2, dim=-1).values
        tied = (top2[..., 0] - top2[..., 1]).abs() <= HATOL + HRTOL * top2[
            ..., 0].abs()
        if bool((~lane_ok & ~tied).any()):
            raise AssertionError(f"hull_ref_face_depth {what}: reference "
                                 "face disagrees with the twin")
        ties += int((~lane_ok).sum())
    ok = lane_ok[..., None]
    val_ok = _close(dep, depT[..., :K]) | ~ok
    if not bool(val_ok.all()):
        raise AssertionError(
            f"hull_ref_face_depth {what}: depth disagrees with the twin, "
            f"max abs err {_max_err(dep, depT[..., :K])}")
    idx_bad = (idx != idxT[..., :K]) & ok
    if bool(idx_bad.any()):
        # accepted only where the twin's neighbouring picks tie
        nxt = torch.cat([depT[..., 1:], depT[..., -1:]], -1)[..., :K]
        prv = torch.cat([depT[..., :1], depT[..., :-1]], -1)[..., :K]
        cur = depT[..., :K]
        near = _close(nxt, cur) | (_close(prv, cur) & (
            torch.arange(K, device=cur.device) > 0))
        if depT.shape[-1] == K:      # no (K+1)-th value for the last pick
            near[..., -1] |= True
        if bool((idx_bad & ~near).any()):
            raise AssertionError(f"hull_ref_face_depth {what}: vertex index "
                                 "disagrees with the twin away from a tie")
        ties += int(idx_bad.sum())
    err = max(_max_err(torch.where(ok, dep, 0.0),
                       torch.where(ok, depT[..., :K], 0.0)),
              _max_err(sep, sepT))
    return err, ties


def compare_support(axes, w, what):
    from mujoco_sim_tpu_torch.ops import support_minmax as smm
    mn, mx = smm.support_minmax_cuda(axes, w)
    torch.cuda.synchronize()
    mnT, mxT = smm.support_minmax_plain(axes, w)
    if not bool((_close(mn, mnT) & _close(mx, mxT)).all()):
        raise AssertionError(f"support_minmax {what}: disagrees with the "
                             f"twin, max abs err {_max_err(mn, mnT)}")
    return max(_max_err(mn, mnT), _max_err(mx, mxT))


_MTV_ORDER = ("wA", "wB", "heA", "heB", "hmA", "hmB", "nfA", "nfB", "fmA",
              "fmB", "RA", "RB", "pA", "pB", "cylA", "cylB")


def compare_mtv(b, what, lanes=None):
    """mtv_query kernel and mtv_staged (support_minmax inside) vs the twin.
    ``lanes`` (bool) restricts the comparison (captured disabled slots hold
    empty tables).  Returns {name: (max abs depth err, axis ties + lanes
    outside the tight band)}."""
    from mujoco_sim_tpu_torch.ops import manifold, mtv_query
    args = [b[k] for k in _MTV_ORDER]
    dep, n = mtv_query.mtv_query_cuda(*args)
    torch.cuda.synchronize()
    depT, nT = mtv_query.mtv_query_plain(*args)
    depS, nS = manifold.mtv_staged(*args)
    torch.cuda.synchronize()
    sel = torch.ones_like(dep, dtype=torch.bool) if lanes is None else lanes
    out = {}
    for name, d_, n_ in (("mtv_query", dep, n), ("mtv_staged", depS, nS)):
        off = ~_close(d_, depT, MTV_ATOL) & sel
        loose = int((~_close(d_, depT) & sel).sum())
        if bool(off.any()):
            raise AssertionError(
                f"{name} {what}: depth disagrees with the twin in "
                f"{int(off.sum())} of {int(sel.sum())} lanes, max abs err "
                f"{_max_err(torch.where(off, d_, 0.0), torch.where(off, depT, 0.0))}")
        # a different axis at an equal depth (within the band) is a tie of
        # the twin's two best axes: accepted and counted
        axis_bad = ((n_ * nT).sum(-1) < 1.0 - 1e-5) & sel & torch.isfinite(
            depT)
        nbad = int(axis_bad.sum())
        if nbad > 0.01 * max(int(sel.sum()), 1):
            raise AssertionError(f"{name} {what}: {nbad} axes differ from "
                                 "the twin's (more than 1% of the lanes)")
        out[name] = (_max_err(torch.where(sel, d_, 0.0),
                              torch.where(sel, depT, 0.0)), nbad + loose)
    return out


def _sat_inputs(rng, N, V, F):
    pts = rng.standard_normal((N, V, 3))
    n = rng.standard_normal((N, F, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    planes = np.concatenate([n, rng.uniform(0.3, 1.2, (N, F, 1))], axis=-1)
    mask = (rng.uniform(size=(N, V)) > 0.25).astype(np.float64)
    mask[:, 0] = 1.0
    # deliberate exact ties: two identical faces, two identical verts
    planes[::3, F - 1] = planes[::3, 1]
    pts[::4, V - 1] = pts[::4, 2]
    mask[::4, V - 1] = mask[::4, 2] = 1.0
    slack = rng.uniform(0.0, 0.3, (N,))
    return _cuda(pts), _cuda(planes), _cuda(mask), _cuda(slack)


def _mtv_inputs(rng, N, V, E, F):
    """Random hull pairs (the generator of tests/test_pallas_refine.py,
    vectorised), with cylinder-flagged lanes and exact ties."""
    def hull(cyl_every):
        pts = rng.normal(size=(N, V, 3)) * 0.3
        pts[::5, V - 1] = pts[::5, 1]                   # identical verts
        R = np.linalg.qr(rng.normal(size=(N, 3, 3)))[0]
        R[:, :, 0] *= np.sign(np.linalg.det(R))[:, None]
        p = rng.normal(size=(N, 3)) * 0.1
        w = p[:, None] + pts @ R.transpose(0, 2, 1)
        he = rng.normal(size=(N, E, 2, 3)) * 0.3
        hm = (rng.uniform(size=(N, E)) > 0.2).astype(np.float64)
        nf = rng.normal(size=(N, F, 3))
        nf /= np.linalg.norm(nf, axis=-1, keepdims=True)
        nf[::3, F - 1] = nf[::3, 0]                     # identical faces
        fm = (rng.uniform(size=(N, F)) > 0.15).astype(np.float64)
        fm[:, 0] = 1.0
        fm[::3, F - 1] = 1.0
        cyl = np.zeros((N, 3))
        cyl[::cyl_every] = [1.0, 0.2, 0.35]
        return w, he, hm, nf, fm, R, p, cyl
    A, B = hull(2), hull(3)
    names = ("w", "he", "hm", "nf", "fm", "R", "p", "cyl")
    b = {k + "A": _cuda(v) for k, v in zip(names, A)}
    b.update({k + "B": _cuda(v) for k, v in zip(names, B)})
    return b


def kernels_vs_plain():
    """The three collision kernels against their plain twins on the card,
    at seeded random inputs with masks, exact ties and cylinder lanes.
    Every case runs; the phase fails at its end if any case failed."""
    rng = np.random.default_rng(0)
    err = dict(hull_ref_face_depth=0.0, mtv_query=0.0, support_minmax=0.0)
    ties = dict(hull_ref_face_depth=0, mtv_query=0, mtv_staged=0)
    failures = []
    ncase = 0

    def sat(*args):
        nonlocal ncase
        ncase += 1
        try:
            e, t = compare_hull_sat(*args)
        except AssertionError as exc:
            failures.append(str(exc))
            return
        err["hull_ref_face_depth"] = max(err["hull_ref_face_depth"], e)
        ties["hull_ref_face_depth"] += t

    for V, F in ((8, 12), (24, 44), (80, 144)):
        for N in (130, 8192):
            pts, planes, mask, slack = _sat_inputs(rng, N, V, F)
            for K in (2, 4):
                for lateral in (False, True):
                    sat(pts, planes, K, mask, lateral, slack,
                        f"V={V} F={F} N={N} K={K} lateral={lateral}")
            sat(pts, planes, 2, None, False, 0.0,
                f"V={V} F={F} N={N} unmasked")
    for V, E, F in ((8, 12, 6), (24, 56, 34), (80, 216, 144)):
        for N in (130, 8192):
            b = _mtv_inputs(rng, N, V, E, F)
            ncase += 3
            try:
                for name, (e, t) in compare_mtv(
                        b, f"V={V} E={E} F={F} N={N}").items():
                    err["mtv_query"] = max(err["mtv_query"], e)
                    ties[name] += t
                for C in (2 * F, 256):
                    axes = _cuda(rng.normal(size=(N, C, 3)))
                    err["support_minmax"] = max(
                        err["support_minmax"],
                        compare_support(axes, b["wA"],
                                        f"C={C} V={V} N={N}"))
            except AssertionError as exc:
                failures.append(str(exc))
    if failures:
        raise AssertionError("kernels disagree with their twins:\n"
                             + "\n".join(failures))
    phase("kernels_vs_plain", cases=ncase, max_abs_err=err,
          accepted_near_ties=ties,
          tolerance=f"atol {HATOL} + rtol {HRTOL} (MTV depth: atol "
                    f"{MTV_ATOL}); indices equal except at ties of the twin "
                    "within that band")
    return err


# ------------------------------------------------------------- box main path

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


def _reset_counts():
    from mujoco_sim_tpu_torch.ops import (chol, hull_sat, mtv_query,
                                          support_minmax)
    for mod in (chol, hull_sat, mtv_query, support_minmax):
        mod.LAUNCHES = 0


def _counts():
    from mujoco_sim_tpu_torch.ops import (chol, hull_sat, mtv_query,
                                          support_minmax)
    return dict(chol_solve=chol.LAUNCHES,
                hull_ref_face_depth=hull_sat.LAUNCHES,
                mtv_query=mtv_query.LAUNCHES,
                support_minmax=support_minmax.LAUNCHES)


def _timed_rollouts(run, reps):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def box_main_path(card):
    import mujoco_sim_tpu_torch as mst
    m = mst.put_model(mst.load_model(BOX))       # float32, on the card
    if m.device.type != "cuda" or m.dtype != torch.float32:
        raise AssertionError("put_model's default is not float32 on the card")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("TF32 is on: the step needs true f32 matmuls")
    d, qpos, qvel = _jittered(m, NENV, 0)
    d0 = _with_state(d, qpos, qvel)
    nsteps = 300

    _reset_counts()
    d = mst.rollout(m, d0, nsteps)
    torch.cuda.synchronize()
    launches = _counts()["chol_solve"]

    bad = _float_leaves_finite(d)
    if bad:
        raise AssertionError(f"non-finite leaves after the rollout: {bad}")
    if launches <= 2 * nsteps:
        raise AssertionError(f"chol_solve ran {launches} times in {nsteps} "
                             "steps: the Newton solver never reached it")
    if not bool((d.qLD == 0).all()):
        raise AssertionError("qLD must stay zero on the kernel path")

    # env-steps/s: the run above is the warm-up; best of 2 timed runs, each
    # carrying on from the last state, so the boxes have 900 steps to land
    state = [d]
    times = _timed_rollouts(
        lambda: state.append(mst.rollout(m, state[-1], nsteps)), 2)
    d = state[-1]
    bad = _float_leaves_finite(d)
    if bad:
        raise AssertionError(f"non-finite leaves after 900 steps: {bad}")
    # box half-extents (.1, .12, .08): resting on any face puts its centre
    # between 0.08 and 0.12 (minus a little penetration)
    ok, zmin, zmax, vmax = _settled(d, [0.08], 0.12 + 0.01, 0.05)
    if not bool(ok.all()):
        raise AssertionError(f"{int((~ok).sum())} boxes not at rest: z in "
                             f"[{zmin}, {zmax}], max speed {vmax}")
    phase("main_path", scene="floor_box.xml", nenv=NENV, steps=nsteps,
          timed="2 rollouts of 300 steps, carrying on from the warm-up",
          chol_launches=launches, launches_per_step=launches / nsteps,
          finite=True, settled=True, z_range=[zmin, zmax], max_speed=vmax,
          rollout_s=times, env_steps_per_s=NENV * nsteps / min(times),
          card=card)
    return m, qpos, qvel, launches


def box_cross_check(m, qpos, qvel):
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


# ----------------------------------------------------------- manip main path

def _stir(nenv, nu, device, dtype, seed=1):
    """bench.py's stir control: ctrl = sin(4 time + phase), phase seeded
    per env and actuator."""
    phase_ = torch.tensor(
        np.random.default_rng(seed).uniform(0.0, 6.28, (nenv, nu)),
        dtype=dtype, device=device)
    return lambda d: torch.sin(4.0 * d.time[:, None] + phase_)


class _Probe:
    """Device-side observers of a manip rollout, hung on the module
    attributes the step looks up at call time.  They call the real
    functions, add no host round trip, and are taken off again: how many
    deep-pair slots were enabled, the largest ncon, and copies of the
    kernels' inputs at a few steps."""

    def __init__(self, capture_calls=()):
        from mujoco_sim_tpu_torch.ops import (collision, hull_sat, manifold,
                                              mtv_query)
        self.mods = (collision, hull_sat, manifold, mtv_query)
        self.enabled = torch.zeros((), dtype=torch.long, device="cuda")
        self.ncon_max = torch.zeros((), dtype=torch.int32, device="cuda")
        self.capture_calls = set(capture_calls)
        self.calls = 0
        self.sat, self.mtv = [], []

    def __enter__(self):
        collision, hull_sat, manifold, mtv_query = self.mods
        self.saved = (collision.collision, hull_sat.hull_ref_face_depth_cuda,
                      manifold.exact_pair_contacts)
        real_col, real_sat, real_epc = self.saved

        def col(m, d):
            self.calls += 1
            out = real_col(m, d)
            self.ncon_max = torch.maximum(self.ncon_max, out.ncon.max())
            return out

        def sat(pts, planes, k, mask=None, lateral=False, slack=0.0):
            if self.calls in self.capture_calls:
                self.sat.append((pts.clone(), planes.clone(), k,
                                 None if mask is None else mask.clone(),
                                 lateral, slack.clone() if isinstance(
                                     slack, torch.Tensor) else slack))
            return real_sat(pts, planes, k, mask, lateral, slack)

        def epc(*args, **kw):
            enabled = args[8]
            self.enabled += enabled.sum()
            if self.calls in self.capture_calls:
                def grab(*a):
                    self.mtv.append((dict(zip(_MTV_ORDER, (
                        x.clone() for x in a))), enabled.clone()))
                    return mtv_query.mtv_query(*a)
                kw["mtv"] = grab
            return real_epc(*args, **kw)

        collision.collision = col
        hull_sat.hull_ref_face_depth_cuda = sat
        manifold.exact_pair_contacts = epc
        return self

    def __exit__(self, *exc):
        collision, hull_sat, manifold, _ = self.mods
        (collision.collision, hull_sat.hull_ref_face_depth_cuda,
         manifold.exact_pair_contacts) = self.saved


def _objects_in_bin(d):
    """The six free bodies (qpos 6 + 7 i) inside the bin: |x|, |y| < 0.34
    and 0 < z < 0.5."""
    pos = torch.stack([d.qpos[:, 6 + 7 * i:9 + 7 * i] for i in range(6)], 1)
    ok = ((pos[..., :2].abs() < 0.34).all(-1) & (pos[..., 2] > 0.0)
          & (pos[..., 2] < 0.5))
    return ok, pos


def _manip_checks(m, d, probe, counts, nsteps, what):
    bad = _float_leaves_finite(d)
    if bad:
        raise AssertionError(f"manip {what}: non-finite leaves: {bad}")
    for k in ("chol_solve", "hull_ref_face_depth", "mtv_query"):
        if counts[k] == 0:
            raise AssertionError(f"manip {what}: {k} was never launched")
    if counts["hull_ref_face_depth"] < 2 * nsteps:
        raise AssertionError(
            f"manip {what}: hull_ref_face_depth ran "
            f"{counts['hull_ref_face_depth']} times in {nsteps} steps "
            "(< 2 per step: box-mesh and mesh-mesh)")
    ok, pos = _objects_in_bin(d)
    if not bool(ok.all()):
        raise AssertionError(f"manip {what}: {int((~ok).sum())} objects "
                             "left the bin")
    ncon_max = int(probe.ncon_max)
    if ncon_max > m.ncon_max:
        raise AssertionError(f"manip {what}: ncon reached {ncon_max} > "
                             f"ncon_max {m.ncon_max}")
    return ncon_max, pos


def manip_main_path(card):
    import mujoco_sim_tpu_torch as mst
    m = mst.put_model(mst.load_model(MANIP))     # float32, on the card
    d0 = mst.make_data(m, MANIP_NENV)
    stir = _stir(MANIP_NENV, m.nu, m.device, m.dtype)
    nsteps = 300

    _reset_counts()
    with _Probe(capture_calls=(100, 200, 300)) as probe:
        d = mst.rollout(m, d0, nsteps, ctrl_fn=stir)
        torch.cuda.synchronize()
    counts = _counts()
    ncon_max, pos = _manip_checks(m, d, probe, counts, nsteps, "main path")
    enabled = int(probe.enabled)
    times = _timed_rollouts(
        lambda: mst.rollout(m, d0, nsteps, ctrl_fn=stir), 2)
    phase("manip_main_path", scene="manip_bin6.xml", nenv=MANIP_NENV,
          steps=nsteps, launches=counts,
          launches_per_step={k: v / nsteps for k, v in counts.items()},
          finite=True, objects_in_bin=True,
          object_z_range=[float(pos[..., 2].min()), float(pos[..., 2].max())],
          ncon_max_seen=ncon_max, ncon_budget=m.ncon_max,
          deep_slots_enabled=enabled,
          deep_slots_per_step=enabled / nsteps,
          rollout_s=times,
          env_steps_per_s=MANIP_NENV * nsteps / min(times), card=card)
    if enabled == 0:
        # no pair went deep: drive the manifold on real contacts by asking
        # for the exact manifold on every touching mesh pair
        mx = m.replace(opt=m.opt.replace(exact_meshcollide=1))
        _reset_counts()
        with _Probe(capture_calls=(25, 50)) as probe_x:
            dx = mst.rollout(mx, d0, 50, ctrl_fn=stir)
            torch.cuda.synchronize()
        cx = _counts()
        _manip_checks(mx, dx, probe_x, cx, 50, "exact_meshcollide")
        if int(probe_x.enabled) == 0:
            raise AssertionError("the exact manifold never ran on a contact")
        phase("manip_exact_meshcollide", steps=50, launches=cx,
              deep_slots_enabled=int(probe_x.enabled))
        probe.mtv += probe_x.mtv
    return m, counts, probe


def manip_kernels(probe):
    """The collision kernels at the inputs the manip rollout gave them:
    held against their twins, then timed at those shapes beside the twins
    and the bound computed from the shapes."""
    from mujoco_sim_tpu_torch.ops import (hull_sat, manifold, mtv_query,
                                          support_minmax as smm)
    err = dict(hull_ref_face_depth=0.0, mtv_query=0.0, support_minmax=0.0)
    ties = dict(hull_ref_face_depth=0, mtv_query=0, mtv_staged=0)
    shapes = {}
    for pts, planes, k, mask, lateral, slack in probe.sat:
        e, t = compare_hull_sat(pts, planes, k, mask, lateral, slack,
                                f"manip capture {tuple(pts.shape)}")
        err["hull_ref_face_depth"] = max(err["hull_ref_face_depth"], e)
        ties["hull_ref_face_depth"] += t
        shapes[tuple(pts.shape)] = (pts, planes, k, mask, lateral, slack)
    live = 0
    for b, enabled in probe.mtv:
        for name, (e, t) in compare_mtv(b, "manip capture",
                                        lanes=enabled).items():
            err["mtv_query"] = max(err["mtv_query"], e)
            ties[name] += t
        live += int(enabled.sum())
    if not probe.sat or not probe.mtv or live == 0:
        raise AssertionError("the manip rollout gave no kernel inputs to "
                             f"check (live deep slots {live})")

    timing = {}
    for shape, (pts, planes, k, mask, lateral, slack) in shapes.items():
        N, V, F = pts.shape[:-2].numel(), pts.shape[-2], planes.shape[-2]
        bound, by = _bound(4 * N * (4 * V + 4 * F + 1) + N * (12 * k + 16),
                           N * (6 * V * F * (2 if lateral else 1) + 6 * V))
        timing["box_mesh" if V == 8 else "mesh_mesh"] = dict(
            N=N, V=V, F=F, K=k, lateral=bool(lateral),
            ms=_median_ms(lambda: hull_sat.hull_ref_face_depth_cuda(
                pts, planes, k, mask, lateral, slack)),
            plain_ms=_median_ms(lambda: hull_sat.hull_ref_face_depth_plain(
                pts, planes, k, mask, lateral, slack)),
            bound_ms=bound, bound_by=by)
    # the exact query at the deepest-loaded capture, all lanes
    b, enabled = max(probe.mtv, key=lambda be: int(be[1].sum()))
    args = [b[k_] for k_ in _MTV_ORDER]
    N = b["wA"].shape[:-2].numel()
    V, E, F = b["wA"].shape[-2], b["heA"].shape[-3], b["nfA"].shape[-2]
    K, R_ = mtv_query.K_EDGE, mtv_query.REFINE_ROUNDS
    bound, by = _bound(4 * N * (6 * V + 14 * E + 8 * F + 30) + 16 * N,
                       N * ((2 * F + R_ * K * K) * 2 * V * 5
                            + R_ * 2 * E * 12))
    timing["mtv_query"] = dict(
        N=N, V=V, E=E, F=F, live_lanes=int(enabled.sum()),
        ms=_median_ms(lambda: mtv_query.mtv_query_cuda(*args)),
        plain_ms=_median_ms(lambda: mtv_query.mtv_query_plain(*args)),
        staged_ms=_median_ms(lambda: manifold.mtv_staged(*args)),
        bound_ms=bound, bound_by=by)
    # support_minmax at the staged query's two widths on the same verts
    rng = np.random.default_rng(5)
    for C in (2 * F, K * K):
        axes = _cuda(rng.normal(size=(N, C, 3))).reshape(
            b["wA"].shape[:-2] + (C, 3))
        err["support_minmax"] = max(err["support_minmax"], compare_support(
            axes, b["wA"], f"manip verts C={C}"))
        bound, by = _bound(4 * N * (5 * C + 3 * V), N * C * V * 5)
        timing[f"support_minmax_C{C}"] = dict(
            N=N, C=C, V=V,
            ms=_median_ms(lambda: smm.support_minmax_cuda(axes, b["wA"])),
            plain_ms=_median_ms(
                lambda: smm.support_minmax_plain(axes, b["wA"])),
            bound_ms=bound, bound_by=by)
    # the staged query as a path of its own: counts set to 0 just before,
    # read just after (engine.step never calls support_minmax)
    _reset_counts()
    manifold.mtv_staged(*args)
    torch.cuda.synchronize()
    staged_launches = _counts()["support_minmax"]
    if staged_launches == 0:
        raise AssertionError("mtv_staged never launched support_minmax")
    timing["support_minmax_launches_per_staged_query"] = staged_launches
    phase("manip_kernels", captured_sat_calls=len(probe.sat),
          captured_mtv_calls=len(probe.mtv), live_deep_slots_checked=live,
          max_abs_err=err, accepted_near_ties=ties, timing=timing,
          peaks="3.35 TB/s, 67 TFLOP/s f32")
    return err, timing


def manip_cross_check(m):
    import mujoco_sim_tpu_torch as mst
    n, nsteps = 16, 50
    m64 = mst.put_model(mst.load_model(MANIP), torch.float64, "cpu")
    outs = []
    for mm_ in (m, m64):
        d = mst.rollout(mm_, mst.make_data(mm_, n), nsteps,
                        ctrl_fn=_stir(n, mm_.nu, mm_.device, mm_.dtype))
        outs.append((d.qpos.double().cpu(), d.qvel.double().cpu()))
    dq = (outs[0][0] - outs[1][0]).abs()
    within = float((dq <= MANIP_CROSS_TOL).double().mean())
    dpos = float(torch.stack([dq[:, 6 + 7 * i:9 + 7 * i]
                              for i in range(6)]).max())
    if within < MANIP_CROSS_FRACTION or not dpos <= MANIP_CROSS_POS_TOL:
        raise AssertionError(
            f"manip card f32 vs CPU f64: {within:.3f} of qpos within "
            f"{MANIP_CROSS_TOL}, objects off by up to {dpos} m")
    phase("manip_cross_check", scene="manip_bin6.xml", nenv=n, steps=nsteps,
          max_dev_qpos=float(dq.max()), median_dev_qpos=float(dq.median()),
          fraction_within_band=within, band=MANIP_CROSS_TOL,
          required_fraction=MANIP_CROSS_FRACTION,
          max_dev_object_position=dpos, object_band=MANIP_CROSS_POS_TOL,
          max_dev_qvel=float((outs[0][1] - outs[1][1]).abs().max()))


def main(argv):
    t_start = time.perf_counter()
    only = set(argv)
    want = lambda name: not only or name in only
    card = environment()
    if want("build"):
        build()
    if want("kernels"):
        chol_err, chol_t = chol_vs_plain()
        rand_err = kernels_vs_plain()
    if want("box"):
        m, qpos, qvel, box_launches = box_main_path(card)
        box_cross_check(m, qpos, qvel)
        second_scene()
    if want("manip"):
        mm_, counts, probe = manip_main_path(card)
        cap_err, t = manip_kernels(probe)
        manip_cross_check(mm_)
    phase("total", seconds=time.perf_counter() - t_start)
    if only:
        return
    src = "mujoco_sim_tpu_torch/csrc/"
    c42 = chol_t[(42, MANIP_NENV)]
    worst = {k: max(rand_err[k], cap_err[k]) for k in rand_err}
    kernels = [
        dict(name="chol_solve", route="cuda", source=src + "chol_solve.cu",
             replaces="mujoco_sim_tpu/ops/pallas_chol.py:40",
             launches=counts["chol_solve"], max_abs_err=chol_err,
             ms=c42["ms"], plain_ms=c42["plain_ms"],
             bound_ms=c42["bound_ms"], bound_by=c42["bound_by"],
             library_ms=c42["library_ms"], launches_box_path=box_launches),
        dict(name="hull_ref_face_depth", route="cuda",
             source=src + "hull_sat.cu",
             replaces="mujoco_sim_tpu/ops/pallas_sat.py:40",
             launches=counts["hull_ref_face_depth"],
             max_abs_err=worst["hull_ref_face_depth"],
             ms=t["mesh_mesh"]["ms"], plain_ms=t["mesh_mesh"]["plain_ms"],
             bound_ms=t["mesh_mesh"]["bound_ms"],
             bound_by=t["mesh_mesh"]["bound_by"], library_ms=None),
        dict(name="mtv_query", route="cuda", source=src + "mtv_query.cu",
             replaces="mujoco_sim_tpu/ops/pallas_refine.py:73",
             launches=counts["mtv_query"], max_abs_err=worst["mtv_query"],
             ms=t["mtv_query"]["ms"], plain_ms=t["mtv_query"]["plain_ms"],
             bound_ms=t["mtv_query"]["bound_ms"],
             bound_by=t["mtv_query"]["bound_by"], library_ms=None),
        dict(name="support_minmax", route="cuda",
             source=src + "support_minmax.cu",
             replaces="mujoco_sim_tpu/ops/pallas_support.py:39",
             # engine.step does not call it (nor does the JAX package's
             # step with its fused query on): its path is the staged query
             # manifold.mtv_staged on the manip rollout's deep-pair slots
             launches=t["support_minmax_launches_per_staged_query"],
             launches_manip_step=counts["support_minmax"],
             max_abs_err=worst["support_minmax"],
             ms=t["support_minmax_C256"]["ms"],
             plain_ms=t["support_minmax_C256"]["plain_ms"],
             bound_ms=t["support_minmax_C256"]["bound_ms"],
             bound_by=t["support_minmax_C256"]["bound_by"],
             library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
