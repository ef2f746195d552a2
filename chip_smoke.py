"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main paths (mujoco_sim_tpu_torch: load_model -> put_model
-> make_data -> rollout of the batched step) on the card: the
primitive-geom box scene at 4096 envs (Euler, then short RK4 and implicit
rollouts), a pile of 11 free boxes (nv = 66, above the Cholesky kernels'
register classes) at 1024 envs, the contact-rich manipulation scene (an
arm stirring six convex meshes in a bin) at 1024 envs, the same scene
as a precise-contact, sensed step (elliptic cone, noslip, 31 sensor
values) at 1024 envs, the same scene with two objects replaced by
pebbles of 256 and 320 hull vertices (exact-manifold tables of (V, E, F)
= (320, 954, 636)) at 1024 envs, a muscle arm on six spatial tendons and
six loose objects on a 64 x 64 heightfield in air with wind at 1024 envs
(tendons with wraps and a pulley, tendon limits and equality, site and
tendon transmissions, fluid drag, tendon sensors, a heightfield ray;
its kernels held to their twins at the inputs its step gave them, and
the exact query driven on live lanes by a pass with the rock set into
the cylinder), the manipulation arm under the computed-torque controller at 1024 envs
(step1 -> pd_accel -> apply_control -> step2), BASELINE config 3 (the
mobile base: benchbot.xml with odom joints on the in-repo world at 1024
envs, 500 steps of the PD arm and set_odom_vels through
parallel/mesh.scan_reduced), BASELINE config 5 at its scale (the
manipulation scene at 8192 and 65 536 envs, each in one graph on one
card, its kernels held to their twins on the launches' rows at both ends
of the batch, its first 1024 envs against the 1024-env batch), and the
runtime on the in-repo world (tests/fixtures/world_empty.xml): the spawn scene of four
balls at 4096 envs with the batch services (health, auto_reset,
checkpoint, masks flipped mid-rollout), the TCP server at one env on the
RK4 world driven by the port's client (spawn, stream, destroy, reset,
screenshot, a hot swap by mesh path, cmd_vel on a second server), each
of the two with its kernels held to their twins at the inputs it gave
them, and the paced SimLoop; then the parallel path, the JAX package's
scaling workload (box @4096, 512 envs a device over 8 devices): the
batch in four shards on the card against the unsharded rollout, the ring
exchange, the chunked trajectory egress against the one-call trajectory
with its overhead, the sharded batch's egress against its shards' own
trajectories and, step by step, the unsharded one, one NCCL process through parallel.distributed, and
the USD/OWL exporters and (where matplotlib is installed) the CLI's
render on the card's state.  Every step path runs through the step graph
(utils/graph.StepGraph: one CUDA graph a step, the solver's and GJK's
loops as WHILE nodes), as a user's call of rollout, step_with_control,
the mesh, the egress, the simulation and the server does; each step
phase also runs the eager rollout of the same steps (the reference its
launch counts and kernel captures come from), holds the graph's final
state to it bit for bit, replays one step under
torch.cuda.set_sync_debug_mode("error"), counts the hand-written kernels
its replays launch on the card (in a second capture of the same step
with the count adds in it; no graph that is timed counts) and holds each
count to the eager steps' over the same steps from the same state (the
wrappers' counts and the card's), and prints both paths' env-steps/s
(also over the same steps from the same state), host and device ms a
step, device busy share and the graph's pool.  Builds the seven hand-written kernels from the
checkout's own sources, holds each against its plain PyTorch twin, and
checks the results.  Run from the root of a checkout, with one card:

    python3 chip_smoke.py

Each phase prints one line; a phase that fails raises, and the script exits
non-zero.  Without a CUDA device it exits non-zero before printing any
result.  It imports nothing of JAX.  The second-to-last line is the kernel
record (JSON); the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

``python3 chip_smoke.py build kernels`` runs only the named phases (of
env, build, kernels, box, pile, manip, precise, bighull, terrain,
control, mobile, manip_scale, runtime, parallel) and prints no final
record: a quick check of the kernels alone; ``build runtime`` is the
quick check of the runtime, ``build parallel`` that of the mesh, the
egress and the exporters, ``build mobile manip_scale`` that of
BASELINE configs 3 and 5.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BOX = os.path.join(ROOT, "tests", "fixtures", "floor_box.xml")
STACK = os.path.join(ROOT, "tests", "fixtures", "stack.xml")
MANIP = os.path.join(ROOT, "tests", "fixtures", "manip_bin6.xml")
PRECISE = os.path.join(ROOT, "tests", "fixtures", "manip_bin6_precise.xml")
PILE = os.path.join(ROOT, "tests", "fixtures", "box_pile11.xml")
BIGHULL = os.path.join(ROOT, "tests", "fixtures", "manip_bin6_bighull.xml")
TERRAIN = os.path.join(ROOT, "tests", "fixtures", "tendon_terrain.xml")
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
WORLD = os.path.join(FIXTURES, "world_empty.xml")
BALL = os.path.join(FIXTURES, "spawn_ball.xml")
BENCHBOT = os.path.join(FIXTURES, "benchbot.xml")
NENV = 4096
# the parallel path: benchmarks/scaling.py's 4096 envs (512 a device over 8
# devices) in four shards on the one card.  A shard is not bit-equal to its
# rows of the whole batch on the card: the batched matmul of the Newton
# gradient, J^T f at ops/solver.py:231 ((B, 6, 16) x (B, 16, 1)), rounds
# otherwise at B = 1024 than at B = 4096 (cuBLAS picks its kernel by the
# batch; scripts/torch_batch_bits.py: first at step 65, 4.2e-7 in qpos).
# The sharded rollout is held to SHARD_TOL, set from its own readings:
# qpos 4.8e-5 and 1.1e-4 from the unsharded rollout after 300 steps
# (PERF.md section 6, four card runs), and about 4x the larger; since the
# run was cut to 150 steps (the boxes have landed by then) it is held
# after 150.  It is held
# at every step of a 128-step sharded trajectory as well, through the
# boxes' landing (a 0.5-0.8 m fall lands at steps 65-82), so a fault that
# moves only the transients shows and is not settled away.
PARALLEL_SHARDS = 4
SHARD_TOL = 5e-4
MANIP_NENV = 1024
# chol_solve vs plain twin: |x_kernel - x_plain| <= ATOL + RTOL |x_plain|
# (f32, the two round differently; the band of tests/test_pallas_chol.py)
RTOL = ATOL = 2e-5
# chol_factor vs plain twin (ops/linalg.cholesky): the same band on L.  The
# kernel scales a column by 1 / sqrt(pivot), the twin divides by
# sqrt(pivot) and sums its blocked update in another order, so the two
# round differently by a few ulp of the largest entry of a row.
# chol_solve on a step's captured systems (compare_chol_step): LAPACK's
# test ratio of a solve and its threshold (xPOT02, 30 in its test input),
# and the forward error against f64 within 4x the plain f32 twin's (as
# accurate as the twin, but for the order of its sums)
CHOL_BWD_RATIO = 30.0
CHOL_FWD_FACTOR = 4.0
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
# the precise scene adds two more places where a last-bit difference turns
# into a different step: the elliptic Newton solver rejects a step whose
# cost rises by one ulp and then stops, and the noslip sweeps clip at their
# cone box.  Its objects are held to the same 2 cm; the fraction of qpos
# entries inside the 2.5e-3 band must be 85% (measured 91% on the card).
PRECISE_CROSS_FRACTION = 0.85
# the bighull scene's 320-vertex pebble is nearly round: it rests and rolls
# on one of many near-tied low vertices, so its orientation (and that of
# the rock it pushes) follows the last bit of the contact picks.  Its
# objects are held to the same 2 cm; the fraction of qpos entries inside
# the 2.5e-3 band must be 85%, as for the precise scene.  f32 alone does
# this, with no card and no kernel: the twins in f32 on the CPU read 89.6%
# against f64 on the same rollout, out of band in the same two bodies'
# quaternions (scripts/torch_f32_drift.py); the card read 91.0%.
# bighull_cross_check prints the fractions body by body.
BIGHULL_CROSS_FRACTION = 0.85
# terrain: the manip band (2.5e-3 on 95% of qpos, objects within 2 cm) over
# 50 stirred steps from the card's state after its 220-step main path, with
# every object on the ground.  The limited tendon may pass its range by
# the soft limit's give: TENDON_LIMIT_SLACK (rad of summed joint angle)
TERRAIN_CROSS_FRACTION = 0.95
TENDON_LIMIT_SLACK = 0.1
# control: read's effort against inverse() at the solved state, f32, each
# env's largest difference over the larger of 1 and its largest effort
CONTROL_EFFORT_RTOL = 1e-4
# precise step, first step, f32 card vs f64 CPU: each sensor value within
# SENSOR_RTOL of the f64 value, relative to the larger of 1 and the
# largest magnitude within that sensor's own reading (a 3-vector whose one
# component passes through zero is held to the vector's scale)
SENSOR_RTOL = 1e-3
# runtime: a ball of radius 0.1 at rest on the floor, to 2 cm (the JAX
# package's spawn test, tests/test_spawn.py:53); 64 seeded envs poisoned
# for auto_reset; the server's wall deadlines; the odom twist against the
# command it was given, in f32 (the arm's reaction moves it by ~1e-6)
BALL_REST_Z, BALL_REST_TOL = 0.1, 0.02
POISONED = 64
SERVER_DEADLINE = 60.0
ODOM_TOL = 1e-4
# the twins materialise an (instances, axes, vertices) product: they run
# over slices of the instances that keep it near 2^28 floats (1 GiB)
PLAIN_SLICE_ELEMS = 1 << 28
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
    from mujoco_sim_tpu_torch.ops import (chol, chol_factor, cuda_build,
                                          face_sat, hull_sat, loops,
                                          mtv_query, support_minmax)
    t0 = time.perf_counter()
    info = cuda_build.build_all()
    for mod in (chol, chol_factor, hull_sat, mtv_query, support_minmax,
                face_sat, loops):
        mod._load()
    if len(info) != 7:
        raise AssertionError(f"expected seven kernels, built {sorted(info)}")
    phase("build", wall_seconds=time.perf_counter() - t0,
          cuda_driver=loops.driver_version(), kernels={
        name: dict(source=os.path.relpath(cuda_build.source_path(name), ROOT),
                   library=os.path.relpath(i["path"], ROOT),
                   seconds=i["seconds"], ptxas=_ptxas(i["ptxas"]))
        for name, i in info.items()})


def graph_loop_vs_plain():
    """The predicate kernel of csrc/graph_loop.cu (writing its flag to
    memory) against mask.any() on the masks of the main paths' loops:
    (4096,) and (1024,) env masks and a (1024, 40) lane mask of GJK, each
    all clear, all set, one set at its last entry and seeded at random.
    Exact: a flag is 0 or 1.  Timed beside mask.any(), which is both its
    plain version and the one library call for the same function."""
    from mujoco_sim_tpu_torch.ops import loops
    rng = np.random.default_rng(5)
    err, cases = 0, 0
    for shape in ((NENV,), (MANIP_NENV,), (MANIP_NENV, 40)):
        n = int(np.prod(shape))
        last = np.zeros(n, bool)
        last[-1] = True
        for pat in (np.zeros(n, bool), np.ones(n, bool), last,
                    rng.uniform(size=n) < 0.01):
            mask = torch.tensor(pat.reshape(shape), device="cuda")
            err = max(err, abs(int(loops.any_cuda(mask))
                               - int(loops.any_plain(mask))))
            cases += 1
    if err:
        raise AssertionError("graph_loop: the predicate kernel differs "
                             "from mask.any()")
    mask = torch.tensor(rng.uniform(size=NENV) < 0.01, device="cuda")
    bound, by = _bound(NENV + 4, NENV)
    t = dict(N=NENV, ms=_median_ms(lambda: loops.any_cuda(mask)),
             device_ms=_graph_ms(lambda: loops.any_cuda(mask)),
             plain_ms=_median_ms(lambda: loops.any_plain(mask)),
             library_ms=_median_ms(lambda: torch.any(mask)),
             bound_ms=bound, bound_by=by)
    phase("graph_loop_vs_plain", cases=cases, max_abs_err=err, **t)
    return err, t


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


def _graph_ms(fn, launches=50, reps=5):
    """One launch's share of a replayed CUDA graph of `launches` launches:
    the kernel's time on the device with no host in the way (a single
    event-timed launch of a kernel this short is mostly the wrapper's
    host time)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return _median_ms(graph.replay, reps) / launches


def _bound(nbytes, flops):
    """Least time in ms for the work: the larger of bytes over the memory
    rate and flops over the f32 rate, and which of the two it is."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return max(tb, tf), "bytes" if tb >= tf else "operations"


def _cuda(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype, device="cuda")


# --------------------------------------------------------------- chol_solve

def compare_chol_step(A, b, what, x=None):
    """chol_solve kernel on a step's own SPD systems.  Mass and Newton
    matrices reach condition numbers of 1e5 with |x| spread over many
    decades inside one system, so an f32 solve's error scales with the
    system's largest |x|, not with each entry (the elementwise band of the
    random cases does not apply).  Held to (1) LAPACK's test of a solve,
    ||b - A x|| / (||A|| ||x|| eps) <= CHOL_BWD_RATIO (infinity norms, eps
    the unit roundoff), and (2) a forward error against an f64 solve, over
    each system's largest |x|, within CHOL_FWD_FACTOR times the plain f32
    twin's on the same systems.  ``x``: the kernel's solution where it
    was launched on a larger batch (these systems' rows of it), else the
    kernel is launched here.  Returns the measures."""
    from mujoco_sim_tpu_torch.ops import chol
    if x is None:
        x = chol.chol_solve_cuda(A, b)
    xp = chol.chol_solve_plain(A, b)
    A64, b64 = A.double(), b.double()
    x64 = torch.cholesky_solve(b64[..., None],
                               torch.linalg.cholesky(A64))[..., 0]
    torch.cuda.synchronize()
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"chol_solve {what}: kernel output not finite")
    eps = torch.finfo(torch.float32).eps / 2
    tiny = torch.finfo(torch.float64).tiny

    def bwd(x_):
        r = ((A64 @ x_.double()[..., None])[..., 0] - b64).abs().amax(-1)
        den = A64.abs().sum(-1).amax(-1) * x_.double().abs().amax(-1)
        return float((r / (eps * den.clamp(min=tiny))).max())

    scale = x64.abs().amax(-1).clamp(min=tiny)
    fwd_each = (x.double() - x64).abs().amax(-1) / scale
    fwd_plain_each = (xp.double() - x64).abs().amax(-1) / scale
    fwd, fwd_plain = float(fwd_each.max()), float(fwd_plain_each.max())
    ev = torch.linalg.eigvalsh(A64)
    out = dict(bwd_ratio=bwd(x), bwd_ratio_plain=bwd(xp), fwd_rel=fwd,
               fwd_rel_plain=fwd_plain, systems=fwd_each.numel(),
               fwd_rel_median=float(fwd_each.median()),
               fwd_rel_plain_median=float(fwd_plain_each.median()),
               max_abs_err=float((x - xp).abs().max()),
               systems_outside_random_band=int(
                   ((x - xp).abs() > ATOL + RTOL * xp.abs()).any(-1).sum()),
               cond_max=float((ev[..., -1] / ev[..., 0]).max()))
    if out["bwd_ratio"] > CHOL_BWD_RATIO:
        raise AssertionError(f"chol_solve {what}: backward error "
                             f"{out['bwd_ratio']} eps > {CHOL_BWD_RATIO}")
    if fwd > CHOL_FWD_FACTOR * max(fwd_plain, eps):
        raise AssertionError(f"chol_solve {what}: forward error {fwd} of "
                             f"the largest |x|, plain twin {fwd_plain} "
                             f"({out})")
    return out


def _chol_bound(N, n):
    """chol_solve's bound: A, b read and x written once; the factor and
    the two substitutions' flops."""
    return _bound(N * (n * n + 2 * n) * 4, N * (n ** 3 / 3 + 2 * n * n))


def chol_vs_plain():
    from mujoco_sim_tpu_torch.ops import chol
    from mujoco_sim_tpu_torch.utils import kernel_cases
    rng = np.random.default_rng(0)
    cases = [(n, N, False) for n in (6, 12, 42, 49) for N in (130, NENV)]
    cases.append((12, 130, True))         # stiff rows, as test_pallas_chol
    cases.append((38, MANIP_NENV, False))  # the terrain step's solves
    # the spawn scene's solves, and the server's at one env before and
    # after the cube's hot swap
    cases += [(24, NENV, False), (24, 1, False), (36, 1, False)]
    # both sides of every size class at a batch of 37, a stiff row at
    # n = 33, a pivot at the 1e-30 floor (utils/kernel_cases.py)
    cases += [(name, None, name == "stiff_n33")
              for name in kernel_cases.CHOL_CASES]
    # above the size classes: one block a system, in shared memory up to
    # n = 239, in device memory beyond; a stiff row, a floored pivot
    cases += [(name, None, name == "stiff_n96")
              for name in kernel_cases.CHOL_BIG_CASES]
    worst_abs, worst_rel = 0.0, 0.0
    for n, N, stiff in cases:
        if N is None:
            case = (kernel_cases.chol_big_case if n in
                    kernel_cases.CHOL_BIG_CASES else kernel_cases.chol_case)
            A, b = case(n)
            n, N = f"case {n}", A.shape[0]
        else:
            A, b = _spd(rng, N, n), rng.standard_normal((N, n))
            if stiff:
                A[:, 0, 0] += 1e9
        At, bt = _cuda(A), _cuda(b)
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
    for n, N in ((6, NENV), (38, MANIP_NENV), (42, NENV), (42, MANIP_NENV),
                 (66, MANIP_NENV), (128, 256)):
        A = _cuda(_spd(rng, N, n))
        b = torch.randn(N, n, device="cuda")
        bound, by = _chol_bound(N, n)
        timing[(n, N)] = dict(
            ms=_median_ms(lambda: chol.chol_solve_cuda(A, b)),
            device_ms=_graph_ms(lambda: chol.chol_solve_cuda(A, b)),
            plain_ms=_median_ms(lambda: chol.chol_solve_plain(A, b)),
            library_ms=_median_ms(lambda: torch.cholesky_solve(
                b[..., None], torch.linalg.cholesky(A))),
            bound_ms=bound, bound_by=by)
    phase("kernel_vs_plain", kernel="chol_solve", cases=len(cases),
          max_abs_err=worst_abs, max_rel_err=worst_rel,
          tolerance=f"atol {ATOL} + rtol {RTOL}", stiff_1e9_cases="ok",
          timing={f"n{n}_N{N}": t for (n, N), t in timing.items()})
    return worst_abs, timing


# -------------------------------------------------------------- chol_factor

def _factor_bound(N, n):
    return _bound(N * 2 * n * n * 4, N * n ** 3 / 3)


def _time_factor(A):
    from mujoco_sim_tpu_torch.ops import chol_factor
    N, n = A.shape[0], A.shape[-1]
    bound, by = _factor_bound(N, n)
    return dict(
        ms=_median_ms(lambda: chol_factor.chol_factor_cuda(A)),
        device_ms=_graph_ms(lambda: chol_factor.chol_factor_cuda(A)),
        plain_ms=_median_ms(lambda: chol_factor.chol_factor_plain(A)),
        library_ms=_median_ms(lambda: torch.linalg.cholesky(A)),
        bound_ms=bound, bound_by=by)


def chol_factor_vs_plain():
    from mujoco_sim_tpu_torch.ops import chol_factor
    from mujoco_sim_tpu_torch.utils import kernel_cases
    rng = np.random.default_rng(2)
    cases = [(NENV, 6, False), (MANIP_NENV, 42, False), (256, 49, False),
             (130, 64, False), (130, 12, True)]   # stiff: diagonal ~1e9
    # the factor is chol_solve's: the size-class edges at a batch of 37
    cases += [(None, n, False) for n in kernel_cases.CHOL_EDGE_SIZES]
    # above the size classes, timed at the step-like (1024, 66) and (256, 128)
    cases += [(None, n, False) for n in kernel_cases.CHOL_BIG_SIZES]
    cases += [(MANIP_NENV, 66, False), (256, 128, False)]
    worst_abs, worst_rel = 0.0, 0.0
    timing = {}
    for N, n, stiff in cases:
        edge = N is None
        case = (kernel_cases.chol_big_case if n in kernel_cases.CHOL_BIG_SIZES
                else kernel_cases.chol_case)
        A = case(f"n{n}")[0] if edge else _spd(rng, N, n)
        N = A.shape[0]
        if stiff:
            A[:, 0, 0] += 1e9
        At = _cuda(A)
        L = chol_factor.chol_factor_cuda(At)
        torch.cuda.synchronize()
        Lp = chol_factor.chol_factor_plain(At)
        if not bool(torch.isfinite(L).all()):
            raise AssertionError(f"chol_factor not finite at n={n} N={N}")
        if not bool((torch.triu(L, 1) == 0).all()):
            raise AssertionError("chol_factor: entries above the diagonal")
        err = (L - Lp).abs()
        if bool((err > ATOL + RTOL * Lp.abs()).any()):
            raise AssertionError(f"chol_factor disagrees with plain at n={n} "
                                 f"N={N}: max abs err {float(err.max())}")
        # the factor reproduces the matrix, relative to its diagonal scale
        scale = torch.diagonal(At, dim1=-2, dim2=-1).amax(-1)
        resid = float(((L @ L.transpose(-1, -2) - At).abs().amax((-1, -2))
                       / scale).max())
        if resid > 1e-5:
            raise AssertionError(f"chol_factor: |L L^T - A| / max diag = "
                                 f"{resid} at n={n} N={N}")
        worst_rel = max(worst_rel, float((err / Lp.abs().amax()).max()))
        if stiff:
            stiff_abs = float(err.max())     # entries up to sqrt(1e9)
        else:
            worst_abs = max(worst_abs, float(err.max()))
            if not edge:
                timing[(n, N)] = _time_factor(At)
    phase("kernel_vs_plain", kernel="chol_factor", cases=len(cases),
          max_abs_err=worst_abs, max_err_over_largest_entry=worst_rel,
          tolerance=f"atol {ATOL} + rtol {RTOL}",
          stiff_1e9_case=dict(max_abs_err=stiff_abs, largest_entry=1e9 ** 0.5),
          timing={f"n{n}_N{N}": t for (n, N), t in timing.items()})
    return worst_abs, timing


# ----------------------------------------------------------- face_sat_depth

def _face_sat_bound(N, V, F, K):
    return _bound(N * (4 * (4 * V + 4 * F) + 8 * K + 20),
                  N * (6 * V * F + 6 * V))


def face_sat_vs_plain():
    """face_sat_depth against its twin: random, masked and exactly tied
    inputs (two identical faces, two identical vertices), an all-masked
    instance; every index equal, values within the band."""
    from mujoco_sim_tpu_torch.ops import face_sat
    from mujoco_sim_tpu_torch.utils import kernel_cases
    rng = np.random.default_rng(3)
    worst, ncase, timing = 0.0, 0, {}
    for V, F in ((8, 12), (32, 60), (80, 144)):
        for N in (130, 8192):
            pts, planes, mask, _ = _sat_inputs(rng, N, V, F)
            mask[1] = 0.0                      # nothing left to pick
            for K in (2, 4):
                ncase += 1
                out = face_sat.face_sat_depth_cuda(pts, planes, mask, K)
                torch.cuda.synchronize()
                ref = face_sat.face_sat_depth_plain(pts, planes, mask, K)
                what = f"V={V} F={F} N={N} K={K}"
                if not bool((out[1] == ref[1]).all()):
                    raise AssertionError(
                        f"face_sat_depth {what}: {int((out[1] != ref[1]).sum())}"
                        " vertex indices differ from the twin's")
                for name, a, b in (("depth", out[0], ref[0]),
                                   ("plane", out[2], ref[2]),
                                   ("sep", out[3], ref[3])):
                    if not bool(_close(a, b).all()):
                        raise AssertionError(
                            f"face_sat_depth {what}: {name} disagrees with "
                            f"the twin, max abs err {_max_err(a, b)}")
                    worst = max(worst, _max_err(a, b))
            if (V, F, N) == (32, 60, 8192):
                bound, by = _face_sat_bound(N, V, F, 2)
                timing = dict(
                    N=N, V=V, F=F, K=2,
                    ms=_median_ms(lambda: face_sat.face_sat_depth_cuda(
                        pts, planes, mask, 2)),
                    device_ms=_graph_ms(lambda: face_sat.face_sat_depth_cuda(
                        pts, planes, mask, 2)),
                    plain_ms=_median_ms(lambda: face_sat.face_sat_depth_plain(
                        pts, planes, mask, 2)),
                    bound_ms=bound, bound_by=by)
    # the edge cases shared with the tests (utils/kernel_cases.py); a
    # missing mask is all ones here
    for name in kernel_cases.SAT_CASES:
        c = kernel_cases.sat_case(name)
        pts, planes = _cuda(c["pts"]), _cuda(c["planes"])
        mask = (torch.ones(pts.shape[:-1], device="cuda") if c["mask"] is None
                else _cuda(c["mask"]))
        ncase += 1
        out = face_sat.face_sat_depth_cuda(pts, planes, mask, c["K"])
        torch.cuda.synchronize()
        ref = face_sat.face_sat_depth_plain(pts, planes, mask, c["K"])
        if not (torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])):
            raise AssertionError(f"face_sat_depth case {name}: an index or "
                                 "the reference plane differs from the twin's")
        for what, a, b in (("depth", out[0], ref[0]), ("sep", out[3], ref[3])):
            if not bool(_close(a, b).all()):
                raise AssertionError(
                    f"face_sat_depth case {name}: {what} disagrees with the "
                    f"twin, max abs err {_max_err(a, b)}")
            worst = max(worst, _max_err(a, b))
    # its own entry point's path: counts set to 0 just before, read just
    # after (no step calls it; scripts/torch_sat_proto.py does)
    face_sat.LAUNCHES = 0
    face_sat.face_sat_depth(pts, planes, mask, 2)
    torch.cuda.synchronize()
    launches = face_sat.LAUNCHES
    if launches != 1:
        raise AssertionError(f"face_sat_depth launched {launches} times")
    phase("kernel_vs_plain", kernel="face_sat_depth", cases=ncase,
          edge_cases=len(kernel_cases.SAT_CASES),
          max_abs_err=worst, indices="all equal",
          tolerance=f"atol {HATOL} + rtol {HRTOL}", timing=timing)
    return worst, timing, launches


# ----------------------------------------------------- the collision kernels

def _close(a, b, atol=HATOL):
    """a within atol + HRTOL |b| of b elementwise (equal infinities agree)."""
    same_inf = torch.isinf(a) & torch.isinf(b) & (a == b)
    return same_inf | ((a - b).abs() <= atol + HRTOL * b.abs())


def _max_err(a, b):
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float(torch.where(fin, (a - b).abs(), 0.0).max()) if a.numel() \
        else 0.0


def compare_hull_sat(pts, planes, K, mask, lateral, slack, what, got=None):
    """Kernel vs twin on CUDA tensors; returns (max abs err, ties).
    ``got``: the kernel's outputs where it was launched on a larger batch
    (these instances' rows of them), else the kernel is launched here."""
    from mujoco_sim_tpu_torch.ops import hull_sat
    dep, idx, nref, sep = got or hull_sat.hull_ref_face_depth_cuda(
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


def _plain_sliced(fn, args, per_instance):
    """fn(*args) over slices of the leading axis, each slice's product at
    most PLAIN_SLICE_ELEMS floats (``per_instance`` an instance; args[0]
    is (lead..., rows, 3)); the results concatenated."""
    N = args[0].shape[0]
    unit = args[0][0].shape[:-2].numel() * max(per_instance, 1)
    step = max(1, PLAIN_SLICE_ELEMS // unit)
    outs = [fn(*(a[i:i + step] for a in args)) for i in range(0, N, step)]
    return tuple(torch.cat(o) for o in zip(*outs))


def compare_support(axes, w, what):
    """Kernel vs twin, bit for bit: both round every multiply and add (the
    kernel is built with -fmad=false), min and max are exact."""
    from mujoco_sim_tpu_torch.ops import support_minmax as smm
    mn, mx = smm.support_minmax_cuda(axes, w)
    torch.cuda.synchronize()
    mnT, mxT = _plain_sliced(smm.support_minmax_plain, (axes, w),
                             axes.shape[-2] * w.shape[-2])
    if not (torch.equal(mn, mnT) and torch.equal(mx, mxT)):
        raise AssertionError(f"support_minmax {what}: differs from the "
                             f"twin, max abs err {_max_err(mn, mnT)}, "
                             f"{_max_err(mx, mxT)}")
    return max(_max_err(mn, mnT), _max_err(mx, mxT))


_MTV_ORDER = ("wA", "wB", "heA", "heB", "hmA", "hmB", "nfA", "nfB", "fmA",
              "fmB", "RA", "RB", "pA", "pB", "cylA", "cylB")


def compare_mtv(b, what, lanes=None, got=None):
    """mtv_query kernel and mtv_staged (support_minmax inside) vs the twin.
    ``lanes`` (bool) restricts the comparison (captured disabled slots hold
    empty tables).  A lane with no valid axis (the twin's depth is +inf:
    an empty deep slot) must equal the twin bit for bit: the kernel
    returns it without scanning.  Returns {name: (max abs depth err, axis
    ties + lanes outside the tight band)}.  ``got``: the kernel's
    outputs where it was launched on a larger batch (these lanes' rows of
    them), else the kernel is launched here."""
    from mujoco_sim_tpu_torch.ops import manifold, mtv_query
    args = [b[k] for k in _MTV_ORDER]
    dep, n = got or mtv_query.mtv_query_cuda(*args)
    torch.cuda.synchronize()
    V, F = b["wA"].shape[-2], b["nfA"].shape[-2]
    depT, nT = _plain_sliced(mtv_query.mtv_query_plain, args, 2 * F * V)
    depS, nS = manifold.mtv_staged(*args)
    torch.cuda.synchronize()
    none = torch.isinf(depT) & (depT > 0)
    if not (torch.equal(dep[none], depT[none])
            and torch.equal(n[none], nT[none])):
        raise AssertionError(f"mtv_query {what}: a lane with no valid axis "
                             "differs from the twin's")
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
    from mujoco_sim_tpu_torch.utils import kernel_cases
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
    # the face-SAT edge cases shared with the tests (utils/kernel_cases.py),
    # with and without the filter
    for name in kernel_cases.SAT_CASES:
        c = kernel_cases.sat_case(name)
        mask = None if c["mask"] is None else _cuda(c["mask"])
        slack = c["slack"] if isinstance(c["slack"], float) \
            else _cuda(c["slack"])
        for lateral in (False, True):
            sat(_cuda(c["pts"]), _cuda(c["planes"]), c["K"], mask, lateral,
                slack, f"case {name} lateral={lateral}")
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
    # the edge ranking's corner cases and the cylinder support on either
    # side (utils/kernel_cases.py), held to the same bands; their near-ties
    # are counted apart from those of the random inputs above.  Then the
    # same cases with the compaction's empty slots (every third lane all
    # zero) and lanes with every face and one hull's edges masked, and the
    # tables compiled from full hulls of 256 and 1200 vertices (vertices
    # staged whole / in tiles) at N = 130 and 8192
    edge_ties = dict(mtv_query=0, mtv_staged=0)
    mtv_cases = [(f"case {name}", kernel_cases.mtv_case(name))
                 for name in kernel_cases.MTV_CASES]
    for name in ("duplicates", "cyl_both"):
        c = kernel_cases.mtv_case(name)
        for v in c.values():
            v[::3] = 0.0
        c["fmA"][1::3] = c["fmB"][1::3] = c["hmB"][1::3] = 0.0
        mtv_cases.append((f"case {name} with empty slots", c))
    for name in kernel_cases.MTV_BIG_CASES:
        for N in (130, 8192):
            mtv_cases.append((f"case {name} N={N}",
                              kernel_cases.mtv_big_case(name, N)))
    for what, c in mtv_cases:
        b = {k: _cuda(v) for k, v in c.items()}
        ncase += 1
        try:
            for kname, (e, t) in compare_mtv(b, what).items():
                err["mtv_query"] = max(err["mtv_query"], e)
                edge_ties[kname] += t
        except AssertionError as exc:
            failures.append(str(exc))
    # support_minmax at one width, the step's two, a chunked one, against
    # clouds of one stage, several tiles and past the old cap of 4096
    for V in (24, 256, 5000):
        for N in (130, 8192):
            w = _cuda(rng.normal(size=(N, V, 3)))
            for C in (1, 68, 256, 1016):
                ncase += 1
                axes = _cuda(rng.normal(size=(N, C, 3)))
                try:
                    err["support_minmax"] = max(
                        err["support_minmax"],
                        compare_support(axes, w, f"C={C} V={V} N={N}"))
                except AssertionError as exc:
                    failures.append(str(exc))
    if failures:
        raise AssertionError("kernels disagree with their twins:\n"
                             + "\n".join(failures))
    phase("kernels_vs_plain", cases=ncase, max_abs_err=err,
          accepted_near_ties=ties, edge_case_near_ties=edge_ties,
          tolerance=f"atol {HATOL} + rtol {HRTOL} (MTV depth: atol "
                    f"{MTV_ATOL}); indices equal except at ties of the twin "
                    "within that band; support_minmax and MTV lanes with no "
                    "valid axis bit for bit")
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
    from mujoco_sim_tpu_torch.ops import (chol, chol_factor, face_sat,
                                          hull_sat, mtv_query, support_minmax)
    for mod in (chol, chol_factor, face_sat, hull_sat, mtv_query,
                support_minmax):
        mod.LAUNCHES = 0


def _counts():
    from mujoco_sim_tpu_torch.ops import (chol, chol_factor, face_sat,
                                          hull_sat, mtv_query, support_minmax)
    return dict(chol_solve=chol.LAUNCHES,
                chol_factor=chol_factor.LAUNCHES,
                face_sat_depth=face_sat.LAUNCHES,
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


GRAPH_FIELDS = ("qpos", "qvel", "act", "qacc_warmstart")
# phase -> the wrappers' kernel counts over its graph main path: the
# graph's warm-up call and its capture (path_vs_eager)
GRAPH_COUNTS = {}
# phase -> the hand-written kernels a replayed step launches, counted on
# the card, and their device ms a step from the eager trace
# (hold_replay_counts)
REPLAY_COUNTS = {}
REPLAY_MS = {}
# the hand-written kernels by the names of their __global__ functions in
# mujoco_sim_tpu_torch/csrc/ (tests/test_torch_graph.py checks that every
# __global__ there is named here); the key is the wrapper module's count
# in _counts(), graph_loop the WHILE nodes' predicate
REPLAY_KERNELS = {
    "chol_solve": ("chol_solve_kernel", "chol_solve_big_kernel"),
    "chol_factor": ("chol_factor_kernel", "chol_factor_big_kernel"),
    "hull_ref_face_depth": ("hull_sat_kernel",),
    "face_sat_depth": ("face_sat_kernel",),
    "mtv_query": ("mtv_query_kernel",),
    "support_minmax": ("support_minmax_kernel",),
    "graph_loop": ("set_any",),
}
_KERNEL_OF = {g: k for k, gs in REPLAY_KERNELS.items() for g in gs}
_KERNEL_NAME = re.compile(r"(?<!\w)(" + "|".join(_KERNEL_OF) + r")(?!\w)")


def _start_tracer():
    """One short torch.profiler session before any graph is captured: the
    trace of a graph captured before the process's first session showed
    none of its WHILE bodies' kernels (box @4096: 1335 CUDA ops a replayed
    step, against 2000-2046 with the session first), so the first graph
    phase's device ms and CUDA ops a step read short."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def _hand_written(name):
    """The REPLAY_KERNELS key of a CUDA event's (demangled) kernel name, or
    None for any other kernel or copy."""
    hit = _KERNEL_NAME.search(name)
    return _KERNEL_OF[hit.group(1)] if hit else None


def _profile(fn, nsteps):
    """torch.profiler over fn() (nsteps steps, CUDA graph replays' kernels
    included): device ms and CUDA ops a step (the sum of the kernels and
    copies it ran), and each hand-written kernel's launches and device ms
    in all, by name."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the trace's own events: prof.events() would build PyTorch's event
    # tree from them first, seconds for the ~10^5 kernels of a few steps
    ev = [(e.name(), e.duration_ns() / 1e6)
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == torch.autograd.DeviceType.CUDA]
    counts = dict.fromkeys(REPLAY_KERNELS, 0)
    dev_ms = dict.fromkeys(REPLAY_KERNELS, 0.0)
    for name, ms in ev:
        k = _hand_written(name)
        if k is not None:
            counts[k] += 1
            dev_ms[k] += ms
    return dict(device_ms=sum(ms for _, ms in ev) / nsteps,
                ops=len(ev) / nsteps, counts=counts, kernel_ms=dev_ms)


def _graph_fields(x):
    """The leaves a path's graph is held to its eager steps on, by name:
    GRAPH_FIELDS of a Data, every leaf of another state (a carry's
    PDState, as pd/<leaf>), and those of each part of a tuple or list
    (prefixed with its index)."""
    from mujoco_sim_tpu_torch.models.model import Data
    from mujoco_sim_tpu_torch.utils.struct import leaves_with_keys
    if isinstance(x, (tuple, list)):
        return {f"{i}.{k}": v for i, part in enumerate(x)
                for k, v in _graph_fields(part).items()}
    if isinstance(x, Data):
        return {k: getattr(x, k) for k in GRAPH_FIELDS}
    return dict(leaves_with_keys(x, "pd"))


def _diffs(fa, fb):
    """max |a - b| of each field of two _graph_fields."""
    return {k: float((v.double() - fb[k].double()).abs().max())
            if v.numel() else 0.0 for k, v in fa.items()}


def count_eager(eager, nsteps):
    """eager() (nsteps eager steps) twice: under the profiler, counting
    nothing (device ms and CUDA ops a step, each hand-written kernel's
    device ms by name), then with the wrappers' counts (LAUNCHES) and the
    counts on the card (cuda_build.counting) set to 0 just before and
    read just after, its final fields kept: the reference of
    hold_replay_counts."""
    from mujoco_sim_tpu_torch.ops import cuda_build, loops
    eag = _profile(eager, nsteps)
    dev = torch.device("cuda", torch.cuda.current_device())
    _reset_counts()
    loops.LAUNCHES = 0
    with cuda_build.counting(dev):
        c0 = cuda_build.device_counts(dev)
        out = eager()
        c1 = cuda_build.device_counts(dev)
    eag.update(wrappers=_counts(), loop_launches=loops.LAUNCHES,
               on_card={k: c1[k] - c0[k] for k in REPLAY_KERNELS},
               final={k: v.clone() for k, v in _graph_fields(out).items()})
    return eag


def hold_replay_counts(what, replay, eager, nsteps, eag=None):
    """The hand-written kernels of a graph path's replays: replay() runs
    nsteps replays of the path's graph from a state and returns where they
    end, eager() the same nsteps eager steps from the same state (``eag``:
    count_eager's record of eager(), taken before, e.g. before the
    capture, so that the eager steps' memory and the graph's pool are not
    held at once).  replay() is profiled first on the graph as the path
    captured it, counting nothing: device ms and CUDA ops a step.  Then
    every graph is dropped and replay() runs twice with counts kept on the
    card (cuda_build.counting): its first call captures the graph again,
    now with each wrapper's count add in it (a replay adds its launches, a
    WHILE body's once an iteration), and the second call's replays are
    counted.  They must end where the eager steps end, bit for bit, and
    each kernel's count over them must equal the wrappers' count
    (LAUNCHES) over the eager steps and the card's count over them: the
    graph is bit-equal to eager, so the same data goes through the same
    loops, however often a WHILE body runs.  The WHILE nodes' predicate
    (graph_loop) has no eager launch and must only have run.  The counted
    graph is dropped and the path's graph captured again without counts,
    as the phase had it.
    A kernel's device ms a launch is the mean of its launches in the eager
    trace (the same launches on the same inputs).  Returns the replays'
    profile (``counts``: the card's), the kernels' ms a launch and the
    eager steps' device ms and CUDA ops a step."""
    from mujoco_sim_tpu_torch.ops import cuda_build
    from mujoco_sim_tpu_torch.utils import graph
    eag = eag or count_eager(eager, nsteps)
    dev = torch.device("cuda", torch.cuda.current_device())
    rep = _profile(replay, nsteps)
    # the dropped graph's pool goes back to the card before the counted
    # capture's warm-up call (manip @65 536: 77.4 GB reserved without)
    graph.clear_all()
    torch.cuda.empty_cache()
    with cuda_build.counting(dev):
        replay()                               # the counted capture
        c0 = cuda_build.device_counts(dev)
        got = replay()
        c1 = cuda_build.device_counts(dev)
    graph.clear_all()
    torch.cuda.empty_cache()
    replay()                      # captured again, without counts
    diffs = {k: v for k, v in _diffs(_graph_fields(got),
                                     eag["final"]).items() if v != 0.0}
    if diffs:
        raise AssertionError(f"{what}: the counted replays vs the eager "
                             f"steps from the same state: {diffs}")
    on_card = {k: c1[k] - c0[k] for k in REPLAY_KERNELS}
    eager_card = eag["on_card"]
    if eag["loop_launches"] or eager_card["graph_loop"]:
        raise AssertionError(f"{what}: the eager steps launched the WHILE "
                             "predicate")
    bad = {k: dict(replay=on_card[k], eager=n, eager_on_card=eager_card[k])
           for k, n in eag["wrappers"].items()
           if not on_card[k] == n == eager_card[k]}
    if bad:
        raise AssertionError(f"{what}: hand-written kernels in {nsteps} "
                             f"replays vs {nsteps} eager steps: {bad}")
    if on_card["graph_loop"] == 0:
        raise AssertionError(f"{what}: no WHILE predicate ran in the "
                             "replays")
    rep["counts"] = on_card
    # a kernel's device ms a launch: the mean of its launches that the
    # eager trace shows
    rep["eager_ms_per_launch"] = {
        k: eag["kernel_ms"][k] / eag["counts"][k]
        for k in REPLAY_KERNELS if eag["counts"][k]}
    REPLAY_COUNTS[what] = {k: v / nsteps for k, v in on_card.items()}
    REPLAY_MS[what] = {k: rep["eager_ms_per_launch"].get(k, 0.0)
                       * REPLAY_COUNTS[what][k] for k in REPLAY_KERNELS}
    rep["per_step"] = REPLAY_COUNTS[what]
    rep["eager_device_ms"], rep["eager_ops"] = eag["device_ms"], eag["ops"]
    return rep


def _replay_record(rep, nsteps):
    """The replay counts as a *_graph line prints them: the card's count
    a step, held to eager's, and each kernel's mean device ms a launch in
    the eager steps' trace."""
    return dict(steps=nsteps, launches_per_step=rep["per_step"],
                held="counted on the card in a capture of the same step "
                     "with the count adds in it, equal to the eager steps' "
                     "launches over the same steps from the same state, "
                     "which its replays equal bit for bit (graph_loop: > 0)",
                device_ms_per_launch=rep["eager_ms_per_launch"],
                device_ms_from="the eager steps' trace (same launches, "
                               "same inputs)")


def _syncs_per_step(fn):
    """Host syncs of one call of fn, counted from the warnings of
    torch.cuda.set_sync_debug_mode("warn")."""
    import warnings
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message).lower() for w in caught)


def _data_of(x):
    """The Data of a path's state (a Data, or a carry that starts with
    one)."""
    return x[0] if isinstance(x, tuple) else x


def path_vs_eager(what, run, eager, graph_of, x0, nsteps, eager_final,
                  card, band=0.0, band_cause=None, eager_steps=10,
                  need=("chol_solve", "graph_loop"), count_steps=3, then=0,
                  **extra):
    """A phase's path through its step graph: run(x, n) is the entry point
    a user calls (n steps from x, one CUDA graph a step, captured on its
    first call and replayed in place; graph_of() is its StepGraph) and
    eager(x, n) the same steps as a Python loop of eager steps.  From x0
    over nsteps, run is held to eager_final (eager(x0, nsteps), which the
    caller ran) on _graph_fields: bit for bit unless a band is given with
    its cause.  The kernel counts are set to 0 just before and read just
    after (the wrappers count the graph's warm-up call and its capture; a
    replay runs without them).  Then: the eager steps' and the graph's
    host time over the same eager_steps steps from x0; one replay under
    set_sync_debug_mode("error"), which raises at any host sync; host
    syncs of an eager step; device time and busy share; the graph's pool;
    and the hand-written kernels of count_steps replays from the graph's
    final state held to as many eager steps from eager_final, the same
    state (hold_replay_counts).  Every eager step runs before the
    capture, and no graph that is timed counts launches.  The graph's
    throughput is timed on a rollout of replays only: from x0 over nsteps
    again, or ``then`` steps from the compared final state onwards.
    Returns the wrappers' counts (``capture``), the replays' profile
    (``replay``), the state the timed rollout ended in (``final``) and
    the phase's line."""
    from mujoco_sim_tpu_torch.ops import loops
    from mujoco_sim_tpu_torch.utils import graph
    nenv = _data_of(x0).qpos.shape[0]
    graph.clear_all()
    # the eager steps first: their cached blocks go back to the card
    # before the capture (utils/graph), and are not held beside its pool
    k = min(eager_steps, nsteps)
    eager_s = min(_timed_rollouts(lambda: eager(x0, k), 1)) / k
    eag = count_eager(lambda: eager(eager_final, count_steps), count_steps)
    e_sync = _syncs_per_step(lambda: eager(eager_final, 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _reset_counts()
    loops.LAUNCHES = 0
    t0 = time.perf_counter()
    x = run(x0, nsteps)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = dict(_counts(), graph_loop=loops.LAUNCHES)
    GRAPH_COUNTS[what] = counts
    missing = [k_ for k_ in need if counts[k_] == 0]
    if missing:
        raise AssertionError(f"{what}: {missing} never launched on the "
                             "graph main path")
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
    cap = graph_of().last
    pool_mb, capture_s = cap.pool_mb, cap.capture_s
    del cap
    diffs = _diffs(_graph_fields(x), _graph_fields(eager_final))
    bad = {k_: v for k_, v in diffs.items() if not v <= band}
    if bad:
        raise AssertionError(f"{what}: graph rollout vs eager rollout over "
                             f"{nsteps} steps: {bad} > {band}")
    if nsteps > 1 and _float_leaves_finite(_data_of(x)):
        raise AssertionError(f"{what}: non-finite leaves in the graph run")
    # replays only: the capture is made; first over the eager steps
    graph_k_s = min(_timed_rollouts(lambda: run(x0, k), 1)) / k
    t0 = time.perf_counter()
    final = run(x, then) if then else run(x0, nsteps)
    torch.cuda.synchronize()
    graph_s = (time.perf_counter() - t0) / (then or nsteps)
    torch.cuda.set_sync_debug_mode("error")
    try:
        run(x, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    rep = hold_replay_counts(what, lambda: run(x, count_steps), None,
                             count_steps, eag)
    out = dict(
        steps=nsteps, nenv=nenv, held=("bit for bit" if band == 0.0
                                       else f"within {band}: {band_cause}"),
        max_abs_diff=diffs, launches_capture=counts, **extra,
        replay_kernels=_replay_record(rep, count_steps),
        same_steps=dict(steps=k, start="the phase's first state",
                        eager_host_ms_per_step=eager_s * 1e3,
                        graph_host_ms_per_step=graph_k_s * 1e3,
                        graph_speedup=eager_s / graph_k_s),
        eager=dict(env_steps_per_s=nenv / eager_s, host_ms_per_step=eager_s
                   * 1e3, device_ms_per_step=rep["eager_device_ms"],
                   device_busy_share=rep["eager_device_ms"] / (eager_s
                                                               * 1e3),
                   cuda_ops_per_step=rep["eager_ops"],
                   host_syncs_per_step=e_sync, timed_steps=k,
                   device_ms_from=f"{count_steps} steps from the compared "
                                  "final state"),
        graph=dict(env_steps_per_s=nenv / graph_s,
                   host_ms_per_step=graph_s * 1e3,
                   device_ms_per_step=rep["device_ms"],
                   device_busy_share=rep["device_ms"] / (graph_s * 1e3),
                   cuda_ops_per_step=rep["ops"], host_syncs_per_step=0,
                   replays_per_step=1, sync_free_replay=True,
                   timed_steps=then or nsteps,
                   timed_from=("the compared final state" if then
                               else "the phase's first state"),
                   pool_mb=pool_mb, peak_mb_over_rollout=peak_mb,
                   capture_s=capture_s, first_call_s=first_s),
        card=card)
    phase(f"{what}_graph", **out)
    return dict(capture=counts, replay=rep, final=final, line=out)


def graph_vs_eager(what, m, d0, nsteps, eager_final, card, ctrl_fn=None,
                   **kw):
    """path_vs_eager for mst.rollout (the batched rollout a user calls)
    against rollout_eager from d0, with ctrl_fn inside the step."""
    import mujoco_sim_tpu_torch as mst
    from mujoco_sim_tpu_torch.parallel.rollout import (rollout_eager,
                                                       step_graph)
    return path_vs_eager(
        what, lambda d, n: mst.rollout(m, d, n, ctrl_fn=ctrl_fn),
        lambda d, n: rollout_eager(m, d, n, ctrl_fn=ctrl_fn),
        lambda: step_graph(ctrl_fn), d0, nsteps, eager_final, card, **kw)


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

    # the eager rollout: the reference the graph is held to, and the
    # launches a step makes
    from mujoco_sim_tpu_torch.parallel.rollout import rollout_eager
    _reset_counts()
    d = rollout_eager(m, d0, nsteps)
    torch.cuda.synchronize()
    launches = _counts()["chol_solve"]
    graph_vs_eager("box", m, d0, nsteps, d, card)

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
          timed_path="rollout (the step graph); launches: rollout_eager",
          chol_launches=launches, launches_per_step=launches / nsteps,
          finite=True, settled=True, z_range=[zmin, zmax], max_speed=vmax,
          rollout_s=times, env_steps_per_s=NENV * nsteps / min(times),
          card=card)
    return m, qpos, qvel, launches, d


def box_integrators(m, d_rest, card):
    """Short RK4 and implicit rollouts of box @4096 from the settled state
    of the Euler rollouts: finite and still at rest, the graph's held to
    the eager rollout's."""
    import mujoco_sim_tpu_torch as mst
    from mujoco_sim_tpu_torch.models.model import Integrator
    from mujoco_sim_tpu_torch.parallel.rollout import rollout_eager
    nsteps, out = 50, {}
    for integ in (Integrator.RK4, Integrator.IMPLICIT):
        mi = m.replace(opt=m.opt.replace(integrator=int(integ)))
        graph_vs_eager(f"box_{integ.name.lower()}", mi, d_rest, nsteps,
                       rollout_eager(mi, d_rest, nsteps), card,
                       eager_steps=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = mst.rollout(mi, d_rest, nsteps)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        bad = _float_leaves_finite(d)
        if bad:
            raise AssertionError(f"{integ.name}: non-finite leaves: {bad}")
        ok, zmin, zmax, vmax = _settled(d, [0.08], 0.12 + 0.01, 0.05)
        if not bool(ok.all()):
            raise AssertionError(
                f"{integ.name}: {int((~ok).sum())} boxes not at rest: z in "
                f"[{zmin}, {zmax}], max speed {vmax}")
        out[integ.name] = dict(seconds=secs, z_range=[zmin, zmax],
                               max_speed=vmax)
    phase("box_integrators", scene="floor_box.xml", nenv=NENV, steps=nsteps,
          finite=True, settled=True, **out)


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


# ------------------------------------------------------------ pile main path

def pile_main_path(card):
    """box_pile11 @1024 (11 free boxes, nv = 66): every SPD solve of the
    step goes through chol_solve's one-block-a-system path; 100 steps from
    2 mm above rest, then every box finite and at rest."""
    import mujoco_sim_tpu_torch as mst
    from mujoco_sim_tpu_torch.ops import chol
    m = mst.put_model(mst.load_model(PILE))       # float32, on the card
    if m.nv <= chol.CLASS_MAX_N:
        raise AssertionError(f"box_pile11 has nv = {m.nv}: not above the "
                             "register classes")
    from mujoco_sim_tpu_torch.parallel.rollout import rollout_eager
    d0 = mst.make_data(m, MANIP_NENV)
    nsteps = 100
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = rollout_eager(m, d0, nsteps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts()
    graph_vs_eager("pile", m, d0, nsteps, d, card)
    bad = _float_leaves_finite(d)
    if bad:
        raise AssertionError(f"pile: non-finite leaves: {bad}")
    if counts["chol_solve"] < 2 * nsteps:
        raise AssertionError(f"pile: chol_solve ran {counts['chol_solve']} "
                             f"times in {nsteps} steps")
    # nine boxes of half-height 0.05 on the floor, two of 0.04 on top of
    # them (centres near 0.14)
    ok, zmin, zmax, vmax = _settled(d, [0.05] * 9 + [0.13] * 2, 0.155, 0.05)
    if not bool(ok.all()):
        raise AssertionError(f"pile: {int((~ok).sum())} envs not at rest: z "
                             f"in [{zmin}, {zmax}], max speed {vmax}")
    phase("pile_main_path", scene="box_pile11.xml", nv=m.nv,
          nenv=MANIP_NENV, steps=nsteps, launches=counts,
          timed_path="rollout_eager (the graph's: pile_graph)",
          launches_per_step={k: v / nsteps for k, v in counts.items()},
          finite=True, settled=True, z_range=[zmin, zmax], max_speed=vmax,
          rollout_s=secs, env_steps_per_s=MANIP_NENV * nsteps / secs,
          card=card)
    return counts


# ----------------------------------------------------------- manip main path

def _stir_phases(nenv, nu, seed=1):
    """bench.py's stir phases, seeded per env and actuator (numpy): the
    first rows of a larger batch's are a smaller batch's."""
    return np.random.default_rng(seed).uniform(0.0, 6.28, (nenv, nu))


def _stir_with(phases, device, dtype):
    """bench.py's stir control: ctrl = sin(4 time + phase)."""
    phase_ = torch.tensor(phases, dtype=dtype, device=device)
    return lambda d: torch.sin(4.0 * d.time[:, None] + phase_)


def _stir(nenv, nu, device, dtype, seed=1, rows=None):
    """The stir of a batch of nenv (``rows``: of those envs of it)."""
    phases = _stir_phases(nenv, nu, seed)
    return _stir_with(phases if rows is None else phases[rows], device,
                      dtype)


def _stir_ranged(m, nenv, seed=1):
    """The stir mapped into each actuator's ctrlrange:
    lo + (hi - lo) (0.5 + 0.5 sin(4 time + phase)); muscles (0, 1) read
    0.5 + 0.5 sin."""
    sin = _stir(nenv, m.nu, m.device, m.dtype, seed)
    cr = m.actuator_ctrlrange
    return lambda d: cr[:, 0] + (cr[:, 1] - cr[:, 0]) * (0.5 + 0.5 * sin(d))


class _Probe:
    """Device-side observers of a rollout, hung on the module
    attributes the step looks up at call time.  They call the real
    functions, add no host round trip, and are taken off again: how many
    deep-pair slots were enabled, the largest ncon, and copies of the
    kernels' inputs (the SPD solves, the face SAT, the exact query) at a
    few steps.  With ``rows`` (env indices) only those envs' inputs are
    copied, beside the same envs' rows of what the launch on the whole
    batch returned (``*_out``), the whole batch's shapes (``*_full``)
    and, for the exact query, the live lanes of each of its rounds over
    the whole batch: a batch too large to copy is held to the twins on
    its first and last envs."""

    def __init__(self, capture_calls=(), rows=None):
        from mujoco_sim_tpu_torch.ops import (chol, collision, hull_sat,
                                              manifold, mtv_query)
        self.mods = (chol, collision, hull_sat, manifold, mtv_query)
        self.enabled = torch.zeros((), dtype=torch.long, device="cuda")
        self.ncon_max = torch.zeros((), dtype=torch.int32, device="cuda")
        self.capture_calls = set(capture_calls)
        self.rows = rows
        self.calls = 0
        self.sat, self.mtv, self.chol = [], [], []
        self.sat_out, self.mtv_out, self.chol_out = [], [], []
        self.sat_full, self.mtv_full = [], []

    def _take(self, x, nenv, rows=None):
        """A copy of x, of its rows' entries where it has the env axis."""
        rows = self.rows if rows is None else rows
        if not isinstance(x, torch.Tensor):
            return x
        if rows is not None and x.dim() and x.shape[0] == nenv:
            return x[rows].clone()
        return x.clone()

    def _outs(self, out, nenv, rows=None):
        return tuple(self._take(o, nenv, rows) for o in out)

    def __enter__(self):
        chol, collision, hull_sat, manifold, mtv_query = self.mods
        self.saved = (chol.chol_solve, collision.collision,
                      hull_sat.hull_ref_face_depth_cuda,
                      manifold.exact_pair_contacts)
        real_chol, real_col, real_sat, real_epc = self.saved
        some = self.rows is not None

        def solve(A, b):
            x = real_chol(A, b)
            if self.calls in self.capture_calls:
                n = A.shape[0]
                self.chol.append((self._take(A, n), self._take(b, n)))
                if some:
                    self.chol_out.append(self._take(x, n))
            return x

        def col(m, d):
            self.calls += 1
            out = real_col(m, d)
            self.ncon_max = torch.maximum(self.ncon_max, out.ncon.max())
            return out

        def sat(pts, planes, k, mask=None, lateral=False, slack=0.0):
            out = real_sat(pts, planes, k, mask, lateral, slack)
            if self.calls in self.capture_calls:
                n = pts.shape[0]
                self.sat.append((self._take(pts, n), self._take(planes, n),
                                 k, self._take(mask, n), lateral,
                                 self._take(slack, n)))
                if some:
                    self.sat_out.append(self._outs(out, n))
                    self.sat_full.append(tuple(pts.shape))
            return out

        def epc(*args, **kw):
            enabled = args[8]
            self.enabled += enabled.sum()
            if self.calls in self.capture_calls:
                def grab(*a):
                    out = mtv_query.mtv_query(*a)
                    n = a[0].shape[0]
                    rows = None
                    if some:
                        # and up to as many envs again with a live slot,
                        # so that live lanes are held too
                        live = enabled.any(-1).nonzero()[:, 0]
                        rows = torch.cat([self.rows, live[:len(
                            self.rows)]]).unique()
                    self.mtv.append((dict(zip(_MTV_ORDER, (
                        self._take(x, n, rows) for x in a))),
                        self._take(enabled, n, rows)))
                    if some:
                        self.mtv_out.append(self._outs(out, n, rows))
                        launches = mtv_query.LAUNCHES
                        self.mtv_full.append(dict(
                            shape=tuple(a[0].shape),
                            live=int(enabled.sum()),
                            lanes_in_round=_mtv_lanes_in_round(list(a))))
                        mtv_query.LAUNCHES = launches
                    return out
                kw["mtv"] = grab
            return real_epc(*args, **kw)

        chol.chol_solve = solve
        collision.collision = col
        hull_sat.hull_ref_face_depth_cuda = sat
        manifold.exact_pair_contacts = epc
        return self

    def __exit__(self, *exc):
        chol, collision, hull_sat, manifold, _ = self.mods
        (chol.chol_solve, collision.collision,
         hull_sat.hull_ref_face_depth_cuda,
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
    if counts["chol_factor"] != (nsteps if m.opt.noslip_iterations else 0):
        raise AssertionError(
            f"manip {what}: chol_factor ran {counts['chol_factor']} times in "
            f"{nsteps} steps (one per step with noslip, none without)")
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
    nsteps = 150

    from mujoco_sim_tpu_torch.parallel.rollout import rollout_eager
    _reset_counts()
    with _Probe(capture_calls=(50, 100, 150)) as probe:
        d = rollout_eager(m, d0, nsteps, ctrl_fn=stir)
        torch.cuda.synchronize()
    counts = _counts()
    ncon_max, pos = _manip_checks(m, d, probe, counts, nsteps, "main path")
    enabled = int(probe.enabled)
    graph_vs_eager("manip", m, d0, nsteps, d, card, ctrl_fn=stir,
                   need=("chol_solve", "graph_loop", "hull_ref_face_depth", "mtv_query"))
    times = _timed_rollouts(
        lambda: mst.rollout(m, d0, nsteps, ctrl_fn=stir), 1)
    phase("manip_main_path", scene="manip_bin6.xml", nenv=MANIP_NENV,
          steps=nsteps, timed="1 rollout of 150 steps after 1 warm-up",
          timed_path="rollout (the step graph); launches: rollout_eager",
          launches=counts,
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
            dx = rollout_eager(mx, d0, 50, ctrl_fn=stir)
            torch.cuda.synchronize()
        cx = _counts()
        _manip_checks(mx, dx, probe_x, cx, 50, "exact_meshcollide")
        if int(probe_x.enabled) == 0:
            raise AssertionError("the exact manifold never ran on a contact")
        phase("manip_exact_meshcollide", steps=50, launches=cx,
              deep_slots_enabled=int(probe_x.enabled))
        probe.mtv += probe_x.mtv
    return m, counts, probe


def _hull_sat_bound(N, V, F, k, mask, lateral, slack):
    """hull_ref_face_depth's bound over N instances: points and planes,
    the mask and the slack where passed (bools), and the outputs moved
    once; the support tensor and the depths computed once (twice with
    the lateral filter)."""
    nbytes = (4 * N * (3 * V + 4 * F) + N * (12 * k + 16)
              + (4 * N * V if mask else 0) + (4 * N if slack else 0))
    return _bound(nbytes, N * (6 * V * F * (2 if lateral else 1) + 6 * V))


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
        bound, by = _hull_sat_bound(N, V, F, k, mask is not None, lateral,
                                    isinstance(slack, torch.Tensor))
        call = lambda: hull_sat.hull_ref_face_depth_cuda(
            pts, planes, k, mask, lateral, slack)
        timing["box_mesh" if V == 8 else "mesh_mesh"] = dict(
            N=N, V=V, F=F, K=k, lateral=bool(lateral),
            ms=_median_ms(call), device_ms=_graph_ms(call),
            plain_ms=_median_ms(lambda: hull_sat.hull_ref_face_depth_plain(
                pts, planes, k, mask, lateral, slack)),
            bound_ms=bound, bound_by=by)
    # the exact query at the deepest-loaded capture, all lanes
    b, enabled = max(probe.mtv, key=lambda be: int(be[1].sum()))
    args = [b[k_] for k_ in _MTV_ORDER]
    N = b["wA"].shape[:-2].numel()
    V, E, F = b["wA"].shape[-2], b["heA"].shape[-3], b["nfA"].shape[-2]
    K = mtv_query.K_EDGE
    # the work these inputs need: a lane with no valid axis (an empty deep
    # slot) ends before its scans, a round that does not improve the depth
    # ends its instance, so round r + 1 runs where round r improved
    round_lanes = _mtv_lanes_in_round(args)
    bound, by = _bound(*_mtv_work(b, round_lanes))
    timing["mtv_query"] = dict(
        N=N, V=V, E=E, F=F, live_lanes=int(enabled.sum()),
        lanes_in_round=round_lanes,
        ms=_median_ms(lambda: mtv_query.mtv_query_cuda(*args)),
        device_ms=_graph_ms(lambda: mtv_query.mtv_query_cuda(*args)),
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
            device_ms=_graph_ms(lambda: smm.support_minmax_cuda(axes,
                                                                b["wA"])),
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


def cross_drift(m, path, n=16, nsteps=50):
    """qpos of the model m against the same scene in f64 on the CPU after
    nsteps stirred steps from the fixture's initial state, n envs: the
    measures of _drift."""
    import mujoco_sim_tpu_torch as mst
    m64 = mst.put_model(mst.load_model(path), torch.float64, "cpu")
    outs = []
    for mm_ in (m, m64):
        d = mst.rollout(mm_, mst.make_data(mm_, n), nsteps,
                        ctrl_fn=_stir(n, mm_.nu, mm_.device, mm_.dtype))
        outs.append(d)
    return _drift(outs[0], outs[1], nsteps)


def _drift(d, ref, nsteps):
    """The manip scene's qpos in d against ref (Data or any object with
    its qpos and qvel, same envs): |dq| per entry, the fraction inside
    MANIP_CROSS_TOL, the largest deviation of an object's position, the
    fraction body by body (position and quaternion entries of the six
    objects) and the largest |dqvel|."""
    dq = (d.qpos.double().cpu() - ref.qpos.double().cpu()).abs()
    ok = dq <= MANIP_CROSS_TOL
    within = float(ok.double().mean())
    dpos = float(torch.stack([dq[:, 6 + 7 * i:9 + 7 * i]
                              for i in range(6)]).max())
    per_body = {name: dict(
        position=float(ok[:, 6 + 7 * i:9 + 7 * i].double().mean()),
        quaternion=float(ok[:, 9 + 7 * i:13 + 7 * i].double().mean()))
        for i, name in enumerate(("t1", "t2", "r1", "r2", "c1", "c2"))}
    return dict(nenv=dq.shape[0], steps=nsteps, max_dev_qpos=float(dq.max()),
                median_dev_qpos=float(dq.median()),
                fraction_within_band=within,
                fraction_within_band_by_body=per_body,
                max_dev_object_position=dpos,
                max_dev_qvel=float((d.qvel.double().cpu()
                                    - ref.qvel.double().cpu()).abs().max()))


def manip_cross_check(m):
    r = cross_drift(m, MANIP)
    within, dpos = r["fraction_within_band"], r["max_dev_object_position"]
    if within < MANIP_CROSS_FRACTION or not dpos <= MANIP_CROSS_POS_TOL:
        raise AssertionError(
            f"manip card f32 vs CPU f64: {within:.3f} of qpos within "
            f"{MANIP_CROSS_TOL}, objects off by up to {dpos} m")
    phase("manip_cross_check", scene="manip_bin6.xml", band=MANIP_CROSS_TOL,
          required_fraction=MANIP_CROSS_FRACTION,
          object_band=MANIP_CROSS_POS_TOL, **r)


# --------------------------------------------------------- bighull main path

def _mtv_work(b, going, N=None):
    """(bytes, flops) the exact query must move and do on these inputs: a
    lane with no valid axis needs both hulls' face masks and one hull's
    edge masks to show it, A's first face normal and its result; a live
    lane reads every table once, scans 2F face axes against 2V vertices,
    and K^2 cross axes and 2E edge scores in every round it runs
    (``going``: live lanes a round, from the kernel itself).  ``N``: the
    lanes of the launch where b holds some of them."""
    from mujoco_sim_tpu_torch.ops import mtv_query
    N = N or b["wA"].shape[:-2].numel()
    V, E, F = b["wA"].shape[-2], b["heA"].shape[-3], b["nfA"].shape[-2]
    K = mtv_query.K_EDGE
    live = int(going[0])
    nbytes = (live * 4 * (6 * V + 14 * E + 8 * F + 30)
              + (N - live) * 4 * (2 * F + E + 3) + 16 * N)
    flops = live * 2 * F * 2 * V * 5 + sum(going) * (K * K * 2 * V * 5
                                                     + 2 * E * 12)
    return nbytes, flops


def _mtv_lanes_in_round(args):
    """Lanes each round of the exact query runs on these inputs: round 0 on
    every lane with a valid axis, round r + 1 where round r improved."""
    from mujoco_sim_tpu_torch.ops import mtv_query
    R_ = mtv_query.REFINE_ROUNDS
    depths = [mtv_query.mtv_query_cuda(*args, rounds=r)[0]
              for r in range(R_ + 1)]
    going = torch.isfinite(depths[0])
    lanes = []
    for r in range(R_):
        lanes.append(int(going.sum()))
        going = going & (depths[r + 1] < depths[r])
    return lanes


def bighull_main_path(card):
    """manip_bin6_bighull @1024: the manip scene with two pebbles of 256 and
    320 hull vertices, so every step's exact query takes full-hull tables
    of (V, E, F) = (320, 954, 636), which the kernel refused before it took
    tables of any size.  20 warm-up steps, then 100 stirred steps with the
    launch counts set to 0 just before and read just after."""
    import mujoco_sim_tpu_torch as mst
    from mujoco_sim_tpu_torch.ops import mtv_query
    m = mst.put_model(mst.load_model(BIGHULL))   # float32, on the card
    V, E, F = (m.mesh_vert_hi.shape[1], m.mesh_hedge.shape[1],
               m.mesh_fplane.shape[1])
    Ep = (E + 3) & ~3
    if 8 * V + 2 * Ep + 14 * E + 8 * F + 30 + 6 * 16 <= 47 * 1024 // 4:
        raise AssertionError(f"bighull tables ({V}, {E}, {F}) fit the old "
                             "shared-memory line")
    d0 = mst.make_data(m, MANIP_NENV)
    stir = _stir(MANIP_NENV, m.nu, m.device, m.dtype)
    nwarm, nsteps = 20, 100
    dw = mst.rollout(m, d0, nwarm, ctrl_fn=stir)
    torch.cuda.synchronize()
    from mujoco_sim_tpu_torch.parallel.rollout import rollout_eager
    _reset_counts()
    final = []
    with _Probe(capture_calls=(25, 50, 75, 100)) as probe:
        times = _timed_rollouts(lambda: final.append(
            rollout_eager(m, dw, nsteps, ctrl_fn=stir)), 1)
    counts = _counts()
    d = final[0]
    ncon_max, pos = _manip_checks(m, d, probe, counts, nsteps, "bighull")
    graph_vs_eager("bighull", m, dw, nsteps, d, card, ctrl_fn=stir,
                   need=("chol_solve", "graph_loop", "hull_ref_face_depth", "mtv_query"))
    if counts["mtv_query"] != nsteps:
        raise AssertionError(f"bighull: mtv_query ran {counts['mtv_query']} "
                             f"times in {nsteps} steps (one per step)")
    # the query at the step's own inputs: against its twin (every live
    # lane), then timed at the capture with the most live deep slots
    err, ties, live = 0.0, 0, 0
    for b, enabled in probe.mtv:
        res = compare_mtv(b, "bighull capture", lanes=enabled)["mtv_query"]
        err, ties = max(err, res[0]), ties + res[1]
        live += int(enabled.sum())
    b, enabled = max(probe.mtv, key=lambda be: int(be[1].sum()))
    args = [b[k] for k in _MTV_ORDER]
    going = _mtv_lanes_in_round(args)
    bound, by = _bound(*_mtv_work(b, going))
    timing = dict(
        N=b["wA"].shape[:-2].numel(), V=V, E=E, F=F,
        live_lanes=int(enabled.sum()), lanes_in_round=going,
        ms=_median_ms(lambda: mtv_query.mtv_query_cuda(*args)),
        device_ms=_graph_ms(lambda: mtv_query.mtv_query_cuda(*args)),
        plain_ms=_median_ms(lambda: mtv_query.mtv_query_plain(*args)),
        bound_ms=bound, bound_by=by)
    phase("bighull_main_path", scene="manip_bin6_bighull.xml",
          tables=dict(V=V, E=E, F=F), nenv=MANIP_NENV, steps=nsteps,
          timed=f"1 rollout of {nsteps} steps after a {nwarm}-step warm-up",
          timed_path="rollout_eager (the graph's: bighull_graph)",
          launches=counts,
          launches_per_step={k: v / nsteps for k, v in counts.items()},
          finite=True, objects_in_bin=True,
          object_z_range=[float(pos[..., 2].min()), float(pos[..., 2].max())],
          ncon_max_seen=ncon_max, ncon_budget=m.ncon_max,
          deep_slots_enabled=int(probe.enabled),
          deep_slots_per_step=int(probe.enabled) / nsteps,
          captured_mtv_calls=len(probe.mtv), live_deep_slots_checked=live,
          mtv_query_vs_twin=dict(max_abs_err=err, near_ties=ties),
          mtv_query_timing=timing, rollout_s=times,
          ms_per_step=min(times) / nsteps * 1e3,
          env_steps_per_s=MANIP_NENV * nsteps / min(times), card=card)
    return m, counts, timing


def bighull_cross_check(m):
    """f32 card vs f64 CPU on manip_bin6_bighull, 50 stirred steps from
    the fixture's initial state: objects within the manip band's 2 cm, 85%
    of qpos within 2.5e-3 (BIGHULL_CROSS_FRACTION)."""
    r = cross_drift(m, BIGHULL)
    within, dpos = r["fraction_within_band"], r["max_dev_object_position"]
    if within < BIGHULL_CROSS_FRACTION or not dpos <= MANIP_CROSS_POS_TOL:
        raise AssertionError(
            f"bighull card f32 vs CPU f64: {within:.3f} of qpos within "
            f"{MANIP_CROSS_TOL}, objects off by up to {dpos} m")
    phase("bighull_cross_check", scene="manip_bin6_bighull.xml",
          band=MANIP_CROSS_TOL, required_fraction=BIGHULL_CROSS_FRACTION,
          object_band=MANIP_CROSS_POS_TOL, **r)


# --------------------------------------------------------- precise main path

def _sensor_slices(m):
    """{sensor type name: [(adr, dim), ...]} of the model's sensordata."""
    from mujoco_sim_tpu_torch.models.model import SensorType
    lay, out = m.layout, {}
    for k in range(m.nsensor):
        out.setdefault(SensorType(int(lay.sensor_type[k])).name, []).append(
            (int(lay.sensor_adr[k]), int(lay.sensor_dim[k])))
    return out


def _stage_ms(fn):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def precise_main_path(card):
    """manip_precise @1024: elliptic cone, three noslip sweeps, the qLD
    factor from the chol_factor kernel, 31 sensor values per step."""
    import mujoco_sim_tpu_torch as mst
    from mujoco_sim_tpu_torch import engine
    from mujoco_sim_tpu_torch.ops import noslip, sensor, solver
    m = mst.put_model(mst.load_model(PRECISE))   # float32, on the card
    d0 = mst.make_data(m, MANIP_NENV)
    stir = _stir(MANIP_NENV, m.nu, m.device, m.dtype)
    # 50 timed steps (200 before the runtime phase was added, 100 before
    # the parallel phase's sharded egress): the script stays inside its time
    nsteps = 50

    # warm-up rollout: short (plans, allocator); the timed rollout starts
    # from the same state and repeats its first steps bit for bit
    nwarm = 20
    dw = mst.rollout(m, d0, nwarm, ctrl_fn=stir)
    torch.cuda.synchronize()
    # the timed eager rollout is the one whose launches are counted
    from mujoco_sim_tpu_torch.parallel.rollout import rollout_eager
    _reset_counts()
    final = []
    with _Probe() as probe:
        times = _timed_rollouts(lambda: final.append(
            rollout_eager(m, d0, nsteps, ctrl_fn=stir)), 1)
    counts = _counts()
    d = final[0]
    ncon_max, pos = _manip_checks(m, d, probe, counts, nsteps, "precise")
    graph_vs_eager("precise", m, d0, nsteps, d, card, ctrl_fn=stir,
                   eager_steps=5, need=("chol_solve", "graph_loop",
                                        "hull_ref_face_depth", "mtv_query",
                                        "chol_factor"))
    bad = _float_leaves_finite(dw)
    if bad:
        raise AssertionError(f"precise warm-up: non-finite leaves: {bad}")
    repeat_dev = float((mst.rollout(m, d0, nwarm, ctrl_fn=stir).qpos
                        - dw.qpos).abs().max())

    # the factor the noslip pass used
    if not bool((d.qLD != 0).any(-1).any(-1).all()):
        raise AssertionError("precise: qLD is zero in some env")
    scale = torch.diagonal(d.qM, dim1=-2, dim2=-1).amax(-1)
    resid = float(((d.qLD @ d.qLD.transpose(-1, -2) - d.qM).abs().amax(
        (-1, -2)) / scale).max())
    if resid > 1e-5:
        raise AssertionError(f"precise: |qLD qLD^T - qM| / max diag {resid}")

    # sensors
    sl = _sensor_slices(m)
    sd = d.sensordata
    if sd.shape != (MANIP_NENV, 31) or not bool(torch.isfinite(sd).all()):
        raise AssertionError(f"precise: sensordata {tuple(sd.shape)} or "
                             "not finite")
    rf = sd[:, sl["RANGEFINDER"][0][0]]
    # a hit is a distance >= 0 (0: the ray starts inside a convex hull,
    # whose intersector clamps the entry parameter at 0), a miss exactly -1
    if not bool(((rf >= 0) | (rf == -1.0)).all()):
        raise AssertionError("precise: a rangefinder reading is neither a "
                             "distance nor -1")
    touch = sd[:, sl["TOUCH"][0][0]]
    if not bool((touch >= 0).all()):
        raise AssertionError("precise: negative touch reading")

    # stage times on the final state, each stage alone and synchronised
    dpre = engine.fwd_acceleration(m, engine.fwd_actuation(
        m, engine.fwd_velocity(m, engine.fwd_position(m, d))))
    dsol, solve_ms = _stage_ms(lambda: solver.solve(m, dpre))
    dnos, noslip_ms = _stage_ms(lambda: noslip.noslip(m, dsol))
    _, sensor_ms = _stage_ms(lambda: sensor.sensors(m, dnos))
    _, step_ms = _stage_ms(lambda: engine.step(m, d))
    # noslip's matrix right-hand side M^-1 Jd^T (two triangular solves)
    # at the shape of the 64 friction rows
    rhs = torch.randn(MANIP_NENV, m.nv, 64, device=d.qLD.device)
    solve_mat_ms = _median_ms(lambda: torch.linalg.solve_triangular(
        d.qLD.mT, torch.linalg.solve_triangular(d.qLD, rhs, upper=False),
        upper=True))
    phase("precise_stages", state="after the timed rollout", step_ms=step_ms,
          elliptic_solve_ms=solve_ms, noslip_ms=noslip_ms,
          noslip_triangular_solves_ms=solve_mat_ms, sensors_ms=sensor_ms,
          card=card)
    # chol_factor at the rollout's own mass matrices
    ferr = float((engine.smooth.factor_chol(d.qM) - d.qLD).abs().max())
    ftime = _time_factor(d.qM.contiguous())
    phase("precise_chol_factor", shape=list(d.qM.shape),
          refactor_max_abs_diff=ferr, **ftime)

    phase("precise_main_path", scene="manip_bin6_precise.xml",
          nenv=MANIP_NENV, steps=nsteps,
          timed=f"1 rollout of {nsteps} steps after a 20-step warm-up",
          timed_path="rollout_eager (the graph's: precise_graph)",
          launches=counts,
          launches_per_step={k: v / nsteps for k, v in counts.items()},
          finite=True, objects_in_bin=True,
          object_z_range=[float(pos[..., 2].min()), float(pos[..., 2].max())],
          ncon_max_seen=ncon_max, ncon_budget=m.ncon_max,
          qLD_residual=resid, max_dev_qpos_between_two_20_step_rollouts=repeat_dev,
          rangefinder_hits=int((rf > 0).sum()),
          rangefinder_starts_inside_a_hull=int((rf == 0).sum()),
          rangefinder_range=[float(rf.min()), float(rf.max())],
          touch_max=float(touch.max()), touching_envs=int((touch > 0).sum()),
          rollout_s=times, ms_per_step=min(times) / nsteps * 1e3,
          env_steps_per_s=MANIP_NENV * nsteps / min(times), card=card)
    return m, counts, ftime


def precise_cross_check(m):
    """f32 card vs f64 CPU on manip_precise: sensordata after the first
    step, then 50 stirred steps at the manip band."""
    import mujoco_sim_tpu_torch as mst
    n, nsteps = 16, 50
    m64 = mst.put_model(mst.load_model(PRECISE), torch.float64, "cpu")
    outs, first = [], []
    for mm_ in (m, m64):
        stir = _stir(n, mm_.nu, mm_.device, mm_.dtype)
        d0 = mst.make_data(mm_, n)
        first.append(mst.rollout(mm_, d0, 1, ctrl_fn=stir)
                     .sensordata.double().cpu())
        d = mst.rollout(mm_, d0, nsteps, ctrl_fn=stir)
        outs.append((d.qpos.double().cpu(), d.qvel.double().cpu()))
    worst_sensor, worst_name = 0.0, ""
    for name, slices in _sensor_slices(m).items():
        for adr, dim in slices:
            a, b = first[0][:, adr:adr + dim], first[1][:, adr:adr + dim]
            rel = float(((a - b).abs().amax(-1)
                         / b.abs().amax(-1).clamp(min=1.0)).max())
            if rel > worst_sensor:
                worst_sensor, worst_name = rel, name
    if worst_sensor > SENSOR_RTOL:
        raise AssertionError(
            f"precise card f32 vs CPU f64: sensor {worst_name} of the first "
            f"step off by {worst_sensor} relative > {SENSOR_RTOL}")
    dq = (outs[0][0] - outs[1][0]).abs()
    within = float((dq <= MANIP_CROSS_TOL).double().mean())
    dpos = float(torch.stack([dq[:, 6 + 7 * i:9 + 7 * i]
                              for i in range(6)]).max())
    if within < PRECISE_CROSS_FRACTION or not dpos <= MANIP_CROSS_POS_TOL:
        raise AssertionError(
            f"precise card f32 vs CPU f64: {within:.3f} of qpos within "
            f"{MANIP_CROSS_TOL} (median {float(dq.median())}, max "
            f"{float(dq.max())}), objects off by up to {dpos} m")
    phase("precise_cross_check", scene="manip_bin6_precise.xml", nenv=n,
          steps=nsteps, max_dev_qpos=float(dq.max()),
          median_dev_qpos=float(dq.median()), fraction_within_band=within,
          band=MANIP_CROSS_TOL, required_fraction=PRECISE_CROSS_FRACTION,
          max_dev_object_position=dpos, object_band=MANIP_CROSS_POS_TOL,
          first_step_sensor_max_rel=worst_sensor,
          first_step_sensor_worst=worst_name, sensor_band=SENSOR_RTOL)


# --------------------------------------------------------- terrain main path

def _terrain_checks(m, d, probe, what):
    """Finite leaves; objects above the ground's bottom and over its x-y
    extent; ncon within budget; the limited tendon inside its range plus
    the soft limit's give; rangefinder readings a distance or -1; muscle
    activations in [0, 1]."""
    bad = _float_leaves_finite(d)
    if bad:
        raise AssertionError(f"terrain {what}: non-finite leaves: {bad}")
    lay = m.layout
    hid = int(lay.geom_hfieldid[m.names.geom_id("ground")])
    rx, ry, _, zbot = (float(v) for v in m.hfield_size[hid].cpu())
    pos = torch.stack([d.qpos[:, 7 * i:7 * i + 3] for i in range(6)], 1)
    ok = ((pos[..., 2] > -zbot) & (pos[..., 0].abs() < rx)
          & (pos[..., 1].abs() < ry))
    if not bool(ok.all()):
        raise AssertionError(f"terrain {what}: {int((~ok).sum())} objects "
                             "below the ground or off its extent")
    ncon_max = int(probe.ncon_max)
    if ncon_max > m.ncon_max:
        raise AssertionError(f"terrain {what}: ncon reached {ncon_max} > "
                             f"ncon_max {m.ncon_max}")
    tid = m.names.tendon_id("couple")
    lo, hi = (float(v) for v in m.ten_range[tid].cpu())
    tl = d.ten_length[:, tid]
    tl_range = [float(tl.min()), float(tl.max())]
    if tl_range[0] < lo - TENDON_LIMIT_SLACK or \
            tl_range[1] > hi + TENDON_LIMIT_SLACK:
        raise AssertionError(f"terrain {what}: limited tendon length "
                             f"{tl_range} outside [{lo}, {hi}] + "
                             f"{TENDON_LIMIT_SLACK}")
    sl = _sensor_slices(m)
    rf = d.sensordata[:, sl["RANGEFINDER"][0][0]]
    if not bool(((rf >= 0) | (rf == -1.0)).all()):
        raise AssertionError(f"terrain {what}: a rangefinder reading is "
                             "neither a distance nor -1")
    from mujoco_sim_tpu_torch.models.model import DynType
    mus = np.nonzero(np.asarray(lay.act_dyntype) == int(DynType.MUSCLE))[0]
    act = d.act[:, torch.as_tensor(mus, device=d.act.device)]
    if not bool(((act >= 0) & (act <= 1)).all()):
        raise AssertionError(f"terrain {what}: muscle act out of [0, 1]")
    return dict(object_z_range=[float(pos[..., 2].min()),
                                float(pos[..., 2].max())],
                ncon_max_seen=ncon_max, ncon_budget=m.ncon_max,
                final_ncon_range=[int(d.ncon.min()), int(d.ncon.max())],
                limited_tendon_range=tl_range, limited_tendon_limit=[lo, hi],
                rangefinder_range=[float(rf.min()), float(rf.max())],
                rangefinder_hits=int((rf >= 0).sum()),
                muscle_act_range=[float(act.min()), float(act.max())])


def terrain_main_path(card):
    """tendon_terrain @1024: a 20-step warm-up, then 200 stirred steps with
    the launch counts set to 0 just before and read just after, and the
    kernels' inputs captured at four of them."""
    import mujoco_sim_tpu_torch as mst
    m = mst.put_model(mst.load_model(TERRAIN))   # float32, on the card
    d0 = mst.make_data(m, MANIP_NENV)
    stir = _stir_ranged(m, MANIP_NENV)
    nwarm, nsteps = 20, 200
    t0 = time.perf_counter()
    dw = mst.rollout(m, d0, nwarm, ctrl_fn=stir)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    from mujoco_sim_tpu_torch.parallel.rollout import rollout_eager
    _reset_counts()
    final = []
    with _Probe(capture_calls=(50, 100, 150, 200)) as probe:
        times = _timed_rollouts(lambda: final.append(
            rollout_eager(m, dw, nsteps, ctrl_fn=stir)), 1)
    counts = _counts()
    d = final[0]
    for k in ("chol_solve", "hull_ref_face_depth", "mtv_query"):
        if counts[k] == 0:
            raise AssertionError(f"terrain: {k} was never launched")
    graph_vs_eager("terrain", m, dw, nsteps, d, card, ctrl_fn=stir,
                   need=("chol_solve", "graph_loop", "hull_ref_face_depth", "mtv_query"))
    # mtv_query runs once a step on the deep-pair slots; where no pair is
    # deep its lanes are empty slots (terrain_deep_pass drives live ones)
    if counts["mtv_query"] != nsteps:
        raise AssertionError(f"terrain: mtv_query ran {counts['mtv_query']} "
                             f"times in {nsteps} steps (one per step)")
    checks = _terrain_checks(m, d, probe, "main path")
    if checks["final_ncon_range"][0] < 6:
        raise AssertionError("terrain: the objects are not all on the "
                             f"ground after {nwarm + nsteps} steps")
    phase("terrain_main_path", scene="tendon_terrain.xml", nv=m.nv,
          ntendon=m.ntendon, nenv=MANIP_NENV, steps=nsteps,
          timed=f"1 rollout of {nsteps} steps after a {nwarm}-step warm-up",
          timed_path="rollout_eager (the graph's: terrain_graph)",
          warmup_s=warm_s, launches=counts,
          launches_per_step={k: v / nsteps for k, v in counts.items()},
          finite=True, deep_slots_enabled=int(probe.enabled),
          deep_slots_per_step=int(probe.enabled) / nsteps, **checks,
          rollout_s=times, ms_per_step=min(times) / nsteps * 1e3,
          env_steps_per_s=MANIP_NENV * nsteps / min(times), card=card)
    return m, counts, d, probe


def _rock_on_cylinder(m, d, depth=0.02):
    """d with the cylinder set upright 1 cm above where it lies and the
    rock set into its top face, ``depth`` deep (the rock's lowest hull
    vertex below the face), both at rest, in every env: the rock-prism
    pair of the terrain scene beyond the deep gate (5 mm)."""
    from mujoco_sim_tpu_torch.ops import smooth
    qpos, qvel = d.qpos.clone(), d.qvel.clone()
    cyl, rock = 7 * 4, 7 * 5                 # free joints of the objects
    upright = torch.zeros(4, dtype=qpos.dtype, device=qpos.device)
    upright[0] = 1.0
    qpos[:, cyl + 2] += 0.01
    qpos[:, cyl + 3:cyl + 7] = upright
    qpos[:, rock:rock + 3] = qpos[:, cyl:cyl + 3]
    qpos[:, rock + 3:rock + 7] = upright
    qvel[:, 6 * 4:6 * 6] = 0.0
    kin = smooth.kinematics(m, qpos, d.mocap_pos, d.mocap_quat)
    gc, gr = m.names.geom_id("cylinder"), m.names.geom_id("rock")
    hid = int(m.layout.geom_hullid[gr])
    vz = kin["geom_xpos"][:, gr, None, 2] + torch.einsum(
        "bj,vj->bv", kin["geom_xmat"][:, gr, 2], m.mesh_vert_hi[hid])
    low = torch.where(m.mesh_vert_hi_mask[hid] > 0.5, vz, torch.inf).amin(-1)
    top = kin["geom_xpos"][:, gc, 2] + m.geom_size[gc, 1]
    qpos[:, rock:rock + 2] += (kin["geom_xpos"][:, gc, :2]
                               - kin["geom_xpos"][:, gr, :2])
    qpos[:, rock + 2] += top - depth - low
    return d.replace(qpos=qpos, qvel=qvel)


def terrain_deep_pass(m, d_end, nsteps=5):
    """The main path's rollout has no deep pair, so its mtv_query lanes
    are empty slots.  From its final state with the rock set 2 cm into the
    upright cylinder's top in every env, nsteps stirred steps: every step
    enables deep slots (the first in every env), and the exact query's
    inputs are captured at three of them."""
    from mujoco_sim_tpu_torch.parallel.rollout import rollout_eager
    d0 = _rock_on_cylinder(m, d_end)
    _reset_counts()
    with _Probe(capture_calls=(1, 3, 5)) as probe:
        d = rollout_eager(m, d0, nsteps,
                          ctrl_fn=_stir_ranged(m, MANIP_NENV))
        torch.cuda.synchronize()
    counts = _counts()
    bad = _float_leaves_finite(d)
    if bad:
        raise AssertionError(f"terrain deep pass: non-finite leaves: {bad}")
    if counts["mtv_query"] != nsteps:
        raise AssertionError(f"terrain deep pass: mtv_query ran "
                             f"{counts['mtv_query']} times in {nsteps} steps")
    live = [int(en.sum()) for _, en in probe.mtv]
    if live[0] < MANIP_NENV or min(live) == 0:
        raise AssertionError("terrain deep pass: the rock-prism pair was "
                             "not deep in every env at the first step, or "
                             f"in none at a later one (live slots {live})")
    phase("terrain_deep_pass", start="the main path's final state, rock "
          "2 cm into the upright cylinder's top", steps=nsteps,
          launches=counts, deep_slots_enabled=int(probe.enabled),
          live_slots_at_captures=live)
    return counts, probe


def hold_captures(chol_calls, sat_calls, what, chol_out=None, sat_out=None):
    """The chol_solve and face-SAT inputs a _Probe captured (its ``chol``
    and ``sat`` lists), each held to its twin at the path's own shapes
    (compare_chol_step, compare_hull_sat; one env's solves pooled, see
    below).  ``chol_out`` / ``sat_out``: the rows of the launches on the
    whole batch that a _Probe with ``rows`` kept, held in place of a new
    launch on the captured rows.  Returns the solves' worst measures, the
    SAT's max abs err and accepted near-ties, and the shapes."""
    from mujoco_sim_tpu_torch.ops import chol
    if not chol_calls:
        raise AssertionError(f"{what}: no chol_solve input captured")
    solves, singles = {}, {}

    def hold(A, b, label, x=None):
        r = compare_chol_step(A, b, f"{what} {label}", x)
        for k, v in r.items():
            solves[k] = max(solves.get(k, v), v)

    for i, (A, b) in enumerate(chol_calls):
        if chol_out is not None:
            hold(A, b, f"capture {tuple(A.shape)}", chol_out[i])
        elif A.shape[0] == 1:
            singles.setdefault(A.shape[-1], []).append((A, b))
        else:
            hold(A, b, f"capture {tuple(A.shape)}")
    for n, pairs in singles.items():
        # one env's solves: the forward-error criterion on one system
        # compares two single samples, so its captured systems are pooled
        # into one batch and held there, as a batched path's are; each
        # launch at N = 1 gives its system's row of the pooled launch bit
        # for bit (a system's work depends on n alone)
        A = torch.cat([a for a, _ in pairs])
        b = torch.cat([x for _, x in pairs])
        one = torch.cat([chol.chol_solve_cuda(a, x) for a, x in pairs])
        if not torch.equal(one, chol.chol_solve_cuda(A, b)):
            raise AssertionError(f"chol_solve {what}: a one-env launch of "
                                 f"n = {n} differs from its pooled row")
        hold(A, b, f"{len(pairs)} one-env captures of n = {n}")
    sat_err, ties = 0.0, 0
    for i, (pts, planes, k, mask, lateral, slack) in enumerate(sat_calls):
        e, t = compare_hull_sat(pts, planes, k, mask, lateral, slack,
                                f"{what} capture {tuple(pts.shape)}",
                                sat_out[i] if sat_out else None)
        sat_err, ties = max(sat_err, e), ties + t
    return dict(
        captured_chol_calls=len(chol_calls),
        chol_shapes=sorted({tuple(A.shape) for A, _ in chol_calls}),
        chol_solve_vs_f64=dict(solves, bwd_ratio_limit=CHOL_BWD_RATIO,
                               fwd_factor_limit=CHOL_FWD_FACTOR),
        captured_sat_calls=len(sat_calls),
        sat_shapes=sorted({tuple(c[0].shape) for c in sat_calls}),
        sat_max_abs_err=sat_err, sat_accepted_near_ties=ties)


def terrain_kernels(probe, deep):
    """The terrain step's kernels at the inputs it gave them: the SPD
    solves and the face SAT of the main path's captured steps, the face
    SAT and the exact query (live lanes) of the deep pass, each held to
    its twin; the query timed at the deep pass's capture beside its twin
    and the bound of the work these inputs need."""
    from mujoco_sim_tpu_torch.ops import mtv_query
    held = hold_captures(probe.chol, probe.sat + deep.sat, "terrain")
    err = dict(hull_ref_face_depth=held["sat_max_abs_err"], mtv_query=0.0)
    ties = dict(hull_ref_face_depth=held["sat_accepted_near_ties"],
                mtv_query=0, mtv_staged=0)
    live = 0
    for b, enabled in deep.mtv:
        for name, (e, t) in compare_mtv(b, "terrain deep capture",
                                        lanes=enabled).items():
            if name == "mtv_query":
                err["mtv_query"] = max(err["mtv_query"], e)
            ties[name] += t
        live += int(enabled.sum())
    if not probe.sat or live == 0:
        raise AssertionError("the terrain rollout gave no kernel inputs to "
                             f"check (live deep slots {live})")
    b = deep.mtv[0][0]
    args = [b[k] for k in _MTV_ORDER]
    going = _mtv_lanes_in_round(args)
    bound, by = _bound(*_mtv_work(b, going))
    timing = dict(
        N=b["wA"].shape[:-2].numel(), V=b["wA"].shape[-2],
        E=b["heA"].shape[-3], F=b["nfA"].shape[-2],
        live_lanes=int(deep.mtv[0][1].sum()), lanes_in_round=going,
        ms=_median_ms(lambda: mtv_query.mtv_query_cuda(*args)),
        device_ms=_graph_ms(lambda: mtv_query.mtv_query_cuda(*args)),
        plain_ms=_median_ms(lambda: mtv_query.mtv_query_plain(*args)),
        bound_ms=bound, bound_by=by)
    phase("terrain_kernels", **held, captured_mtv_calls=len(deep.mtv),
          live_deep_slots_checked=live, max_abs_err=err,
          accepted_near_ties=ties, mtv_query_deep_timing=timing)
    return err, held["chol_solve_vs_f64"], timing


def terrain_cross_drift(m, start, n=16, nsteps=50):
    """qpos of model m (f32) against the terrain scene in f64 on the CPU
    after nsteps stirred steps from the first n envs of ``start`` (a state
    of the f32 model with every object on the ground), both from the same
    numbers: the fraction of qpos inside MANIP_CROSS_TOL, overall and body
    by body, and the largest deviation of an object's position."""
    import mujoco_sim_tpu_torch as mst
    m64 = mst.put_model(mst.load_model(TERRAIN), torch.float64, "cpu")
    outs = []
    for mm_ in (m, m64):
        d = mst.make_data(mm_, n)
        d = d.replace(**{k: getattr(start, k)[:n].to(mm_.device, mm_.dtype)
                         for k in ("time", "qpos", "qvel", "act",
                                   "qacc_warmstart")})
        d = mst.rollout(mm_, d, nsteps, ctrl_fn=_stir_ranged(mm_, n))
        outs.append((d.qpos.double().cpu(), d.qvel.double().cpu(),
                     d.ncon.cpu()))
    dq = (outs[0][0] - outs[1][0]).abs()
    ok = dq <= MANIP_CROSS_TOL
    names = ("sphere", "capsule", "box", "ellipsoid", "cylinder", "rock")
    return dict(
        nenv=n, steps=nsteps, max_dev_qpos=float(dq.max()),
        median_dev_qpos=float(dq.median()),
        fraction_within_band=float(ok.double().mean()),
        fraction_within_band_by_body={
            nm: dict(position=float(ok[:, 7 * i:7 * i + 3].double().mean()),
                     quaternion=float(ok[:, 7 * i + 3:7 * i + 7].double()
                                      .mean()))
            for i, nm in enumerate(names)},
        arm=float(ok[:, 42:].double().mean()),
        max_dev_object_position=float(torch.stack(
            [dq[:, 7 * i:7 * i + 3] for i in range(6)]).max()),
        max_dev_qvel=float((outs[0][1] - outs[1][1]).abs().max()),
        ncon_range=[int(outs[1][2].min()), int(outs[1][2].max())])


def terrain_cross_check(m, start):
    r = terrain_cross_drift(m, start)
    within, dpos = r["fraction_within_band"], r["max_dev_object_position"]
    if within < TERRAIN_CROSS_FRACTION or not dpos <= MANIP_CROSS_POS_TOL:
        raise AssertionError(
            f"terrain card f32 vs CPU f64: {within:.3f} of qpos within "
            f"{MANIP_CROSS_TOL}, objects off by up to {dpos} m")
    phase("terrain_cross_check", scene="tendon_terrain.xml",
          start="the card's state after the 220-step main path",
          band=MANIP_CROSS_TOL, required_fraction=TERRAIN_CROSS_FRACTION,
          object_band=MANIP_CROSS_POS_TOL, **r)


# --------------------------------------------------------- control main path

def control_main_path(card):
    """manip_bin6's arm at 1024 envs under the computed-torque controller:
    100 steps of step1 -> pd_accel -> apply_control -> step2 towards
    seeded joint setpoints; then hw_interface.read's effort against
    inverse() at the solved state."""
    import mujoco_sim_tpu_torch as mst
    from mujoco_sim_tpu_torch.control import controllers as C
    from mujoco_sim_tpu_torch.control import hw_interface as HW
    m = mst.put_model(mst.load_model(MANIP))     # float32, on the card
    joints = [f"a{i}" for i in range(1, 7)]
    cfg = C.pd_config_for_joints(m, joints, kp=200.0, kd=30.0)
    dofs = HW.joint_dofs(m, joints)
    qadr = np.asarray(m.layout.jnt_qposadr)[
        [m.names.joint_id(j) for j in joints]]
    n, nsteps = MANIP_NENV, 100
    rng = np.random.default_rng(3)
    d = mst.make_data(m, n)
    des = torch.zeros((n, m.nv), dtype=m.dtype, device=m.device)
    target = torch.tensor(rng.uniform(-0.3, 0.3, (n, len(dofs))),
                          dtype=m.dtype, device=m.device)
    dofs_t = torch.as_tensor(dofs, device=m.device)
    des[:, dofs_t] = target
    st = C.make_pd_state(m, n)

    def ctrl(m_, d_, st_):
        st2 = C.pd_accel(cfg, st_, d_, des, m_.opt.timestep)
        return C.apply_control(m_, d_, st2, cfg.ctrl_mask)

    qa = torch.as_tensor(qadr, device=m.device)
    err0 = float((d.qpos[:, qa] - target).abs().max())
    # the eager reference (step_with_control_eager), then the main path:
    # step_with_control, one graph a step with the controller inside
    from mujoco_sim_tpu_torch import engine
    from mujoco_sim_tpu_torch.utils import graph

    def chain(step):
        def run(c, k):
            for _ in range(k):
                c = step(m, c[0], ctrl, c[1])
            return c
        return run

    eager = chain(engine.step_with_control_eager)
    ce = eager((d, st), nsteps)
    res = path_vs_eager("control", chain(mst.step_with_control), eager,
                        lambda: graph.cached("control", ctrl, None),
                        (d, st), nsteps, ce, card)
    del ce
    counts = res["capture"]
    d, st = res["final"]
    bad = _float_leaves_finite(d)
    if bad:
        raise AssertionError(f"control: non-finite leaves: {bad}")
    # the arm sweeps through the objects, whose contacts hold some joints
    # short of their setpoints: the error is reported, not bounded
    err = (d.qpos[:, qa] - target).abs()
    # effort at the solved state against inverse dynamics
    ds = mst.forward(m, d)
    _, _, eff = HW.read(m, ds, dofs)
    inv = mst.inverse(m, ds, ds.qacc)[:, dofs_t]
    rel = float(((eff - inv).abs().amax(-1)
                 / inv.abs().amax(-1).clamp(min=1.0)).max())
    if rel > CONTROL_EFFORT_RTOL:
        raise AssertionError(f"control: read effort vs inverse {rel} > "
                             f"{CONTROL_EFFORT_RTOL} relative")
    phase("control_main_path", scene="manip_bin6.xml",
          controller="computed-torque PD, kp 200, kd 30, joints a1-a6",
          nenv=n, steps=nsteps, launches=counts,
          tracking_error_start=err0,
          tracking_error_end_max=float(err.max()),
          tracking_error_end_median=float(err.median()),
          tracking_error_end_by_joint_median=[
              float(v) for v in err.median(0).values],
          ncon_end_range=[int(d.ncon.min()), int(d.ncon.max())],
          effort_vs_inverse_max_rel=rel,
          effort_band=CONTROL_EFFORT_RTOL,
          env_steps_per_s=res["line"]["graph"]["env_steps_per_s"],
          card=card)


# ------------------------------------------- mobile base (BASELINE config 3)

# bench.py's bench_mobile: 1024 envs, 500 steps, no jitter; the base's
# command and the arm's PD gains; a1-a3 settle within MOBILE_ARM_TOL rad
# of their setpoint 0
MOBILE_NENV, MOBILE_STEPS = 1024, 500
MOBILE_CMD = (0.4, 0.0, 0.0, 0.0, 0.0, 0.3)
MOBILE_ARM_TOL = 5e-2
# card against CPU: MOBILE_CROSS_NENV envs spread over the batch after
# MOBILE_CROSS_STEPS steps, f32 card vs f64 CPU, within box's CROSS_TOL
MOBILE_CROSS_NENV, MOBILE_CROSS_STEPS = 16, 100
ODOM_JOINTS = ("lin_odom_x_joint", "lin_odom_y_joint", "ang_odom_z_joint")


def mobile_model(dtype=torch.float32, device="cuda"):
    """bench.py's _mobile_model on the in-repo world (world_empty.xml in
    place of the reference's empty.xml): benchbot.xml with the odom joints
    lin x, lin y and ang z, set_const on the compiled spec, the integrator
    set to Euler as bench_mobile sets it."""
    from mujoco_sim_tpu_torch import engine
    from mujoco_sim_tpu_torch.models import scene
    from mujoco_sim_tpu_torch.models.compile import compile_spec
    from mujoco_sim_tpu_torch.models.model import Integrator
    spec = scene.compose(WORLD, robots={"benchbot": scene.RobotConfig(
        path=BENCHBOT, add_odom_joints=dict.fromkeys(ODOM_JOINTS, True))})
    m = engine.set_const(compile_spec(spec))
    m = m.replace(opt=m.opt.replace(integrator=int(Integrator.EULER)))
    return engine.put_model(m, dtype, device)


def mobile_step(m, nenv):
    """bench_mobile's one_env_step on a batch of nenv, as a step function
    of the (Data, PDState) carry: step1, the PD arm on a1-a3 (kp 80, kd
    8, setpoint 0), apply_control, set_odom_vels with MOBILE_CMD, step2.
    Returns it and the odom config."""
    from mujoco_sim_tpu_torch import engine
    from mujoco_sim_tpu_torch.control import controllers as C
    ocfg = C.odom_config(m, "benchbot")
    pdc = C.pd_config_for_joints(m, ["a1", "a2", "a3"], kp=80.0, kd=8.0)
    qdes = torch.zeros((nenv, m.nv), dtype=m.dtype, device=m.device)
    cmd = torch.tensor(MOBILE_CMD, dtype=m.dtype, device=m.device)

    def step(carry):
        d, st = carry
        d = engine.step1(m, d)
        st = C.pd_accel(pdc, st, d, qdes, m.opt.timestep)
        d, st = C.apply_control(m, d, st, pdc.ctrl_mask)
        d = C.set_odom_vels(m, d, ocfg, cmd)
        return engine.step2(m, d), st

    return step, ocfg


def _spread(nenv, n):
    """n env indices spread over a batch of nenv, the first and the last
    included."""
    return np.unique(np.linspace(0, nenv - 1, n).round().astype(np.int64))


def mobile_main_path(card):
    """BASELINE config 3, the batched mobile base (bench.py's
    bench_mobile): 1024 envs of benchbot.xml with odom joints on the
    in-repo world, Euler, 500 steps of step1 -> the PD arm ->
    apply_control -> set_odom_vels -> step2 through parallel/mesh.
    scan_reduced (one StepGraph of the controlled step over the (Data,
    PDState) carry), held to the same step as a Python loop bit for bit;
    the base follows the command, the arm settles, and 16 envs agree with
    the CPU in f64."""
    import mujoco_sim_tpu_torch as mst
    from mujoco_sim_tpu_torch.control import controllers as C
    from mujoco_sim_tpu_torch.parallel import mesh as pmesh
    from mujoco_sim_tpu_torch.utils import graph
    m = mobile_model()
    n, nsteps = MOBILE_NENV, MOBILE_STEPS
    step, ocfg = mobile_step(m, n)
    c0 = (mst.make_data(m, n), C.make_pd_state(m, n))

    def eager(c, k):
        for _ in range(k):
            c = step(c)
        return c

    # the eager reference: the same step as a Python loop
    _reset_counts()
    ce = eager(c0, nsteps)
    torch.cuda.synchronize()
    eager_counts = _counts()
    # the main path: scan_reduced, captured on its first call
    res = path_vs_eager(
        "mobile", lambda c, k: pmesh.scan_reduced(step, c, k), eager,
        lambda: graph.cached("scan", step, None), c0, nsteps, ce, card,
        launches_eager=eager_counts)
    del ce
    cg = res["final"]
    d = cg[0]
    bad = _float_leaves_finite(d) + [
        f"pd.{k}" for k in ("ddq", "dq", "err_int")
        if not bool(torch.isfinite(getattr(cg[1], k)).all())]
    if bad:
        raise AssertionError(f"mobile: non-finite leaves: {bad}")
    # the base follows the command in every env: the odom twist against
    # the command rotated by the yaw the step set it at (as odom_server)
    x_, y_, yaw_ = (int(ocfg.qpos_ids[i]) for i in (0, 1, 5))
    vx_, vy_, w_ = (int(ocfg.dof_ids[i]) for i in (0, 1, 5))
    q, v = d.qpos.double(), d.qvel.double()
    dt = float(m.opt.timestep)
    yaw0 = q[:, yaw_] - dt * v[:, w_]
    dev = torch.stack([
        (v[:, vx_] - MOBILE_CMD[0] * torch.cos(yaw0)).abs(),
        (v[:, vy_] - MOBILE_CMD[0] * torch.sin(yaw0)).abs(),
        (v[:, w_] - MOBILE_CMD[5]).abs()], 1).amax(1)
    twist_dev = float(dev.max())
    if not twist_dev <= ODOM_TOL:
        raise AssertionError(f"mobile: odom twist off the command by "
                             f"{twist_dev} in {int((dev > ODOM_TOL).sum())} "
                             "envs")
    # x and yaw rise: from the start through step MOBILE_CROSS_STEPS to the
    # end, in every env
    c_mid = pmesh.scan_reduced(step, c0, MOBILE_CROSS_STEPS)
    q_mid = c_mid[0].qpos.double()
    rise = [c0[0].qpos.double(), q_mid, q]
    for a, b in zip(rise, rise[1:]):
        if not bool(((b[:, x_] > a[:, x_]) & (b[:, yaw_] > a[:, yaw_]))
                    .all()):
            raise AssertionError("mobile: x and yaw did not rise in every "
                                 "env")
    arm = [int(m.layout.jnt_qposadr[m.names.joint_id(j)])
           for j in ("a1", "a2", "a3")]
    arm_dev = float(q[:, arm].abs().max())
    if not arm_dev <= MOBILE_ARM_TOL:
        raise AssertionError(f"mobile: the arm is {arm_dev} rad off its "
                             "setpoint")
    # card f32 against CPU f64: envs spread over the batch, after
    # MOBILE_CROSS_STEPS steps from the same start
    rows = _spread(n, MOBILE_CROSS_NENV)
    m64 = mobile_model(torch.float64, "cpu")
    step64, _ = mobile_step(m64, len(rows))
    c64 = pmesh.scan_reduced(step64, (mst.make_data(m64, len(rows)),
                                      C.make_pd_state(m64, len(rows))),
                             MOBILE_CROSS_STEPS)
    cross = {k: float((getattr(c_mid[0], k)[rows].double().cpu()
                       - getattr(c64[0], k)).abs().max())
             for k in ("qpos", "qvel")}
    if not cross["qpos"] <= CROSS_TOL:
        raise AssertionError(f"mobile: card f32 vs CPU f64 after "
                             f"{MOBILE_CROSS_STEPS} steps: {cross}")
    phase("mobile_main_path",
          scene="world_empty.xml + benchbot.xml, odom joints lin x, lin y, "
                "ang z; Euler", nenv=n, steps=nsteps,
          controller="PD a1-a3 kp 80 kd 8 to 0, set_odom_vels "
                     f"{list(MOBILE_CMD)}",
          path="parallel/mesh.scan_reduced (one StepGraph of the "
               "controlled step)",
          finite=True, odom_twist_max_dev=twist_dev, odom_tol=ODOM_TOL,
          x_range=[float(q[:, x_].min()), float(q[:, x_].max())],
          yaw_range=[float(q[:, yaw_].min()), float(q[:, yaw_].max())],
          arm_max_abs=arm_dev, arm_tol=MOBILE_ARM_TOL,
          ncon_range=[int(d.ncon.min()), int(d.ncon.max())],
          cross_check=dict(envs=rows.tolist(), steps=MOBILE_CROSS_STEPS,
                           max_dev=cross, band=CROSS_TOL),
          env_steps_per_s=res["line"]["graph"]["env_steps_per_s"],
          card=card)


# --------------------------------- manip at scale (BASELINE config 5)

# bench.py's manip_8k cell (8192 envs, 100 steps) and BASELINE config 5's
# 65 536 envs (20 steps), each on one card in one graph
MANIP_SCALE = ((8192, 100), (65536, 20))
# the envs at each end of a batch whose kernel inputs (and the rows of the
# launches on the whole batch) are held to the twins
SCALE_ENDS = 64
# the first 1024 envs of a batch against the 1024-env batch from the same
# start: within SHARD_TOL after one step (cuBLAS's batched J^T f rounds by
# batch, ROADMAP C), in manip's band (MANIP_CROSS_FRACTION of qpos within
# MANIP_CROSS_TOL) after SCALE_BAND_STEPS
SCALE_BAND_STEPS = 50
# envs spread over each batch, the first and the last included, against
# the CPU in f64 (cross_drift's band)
SCALE_CROSS_NENV = 16


def _scale_bounds(m, nenv, probe, what):
    """Each hand-written kernel of a replayed step at this batch: its
    launches a step (counted on the card) and device ms a step (the eager
    steps' trace from the same state: the same launches on the same
    inputs; the WHILE predicate, which eager steps do not launch, timed in
    a graph of launches on an (nenv,) mask), beside the bound of its
    launches at the whole batch's shapes: chol_solve at (nenv, nv), the
    face SAT's calls at the shapes the probe kept, the exact query at the
    live lanes of each round over the whole batch (the probe's first
    capture), the WHILE predicate on (nenv,) masks."""
    from mujoco_sim_tpu_torch.ops import loops, mtv_query
    per, ms = REPLAY_COUNTS[what], REPLAY_MS[what]
    out = {}

    def row(name, per_launch_ms, bound, by):
        out[name] = dict(launches_per_step=per[name],
                         device_ms_per_launch=per_launch_ms,
                         device_ms_per_step=per_launch_ms * per[name],
                         bound_ms_per_step=bound, bound_by=by)

    def eager_ms(name):
        return ms[name] / per[name] if per[name] else 0.0

    b, by = _chol_bound(nenv, m.nv)
    row("chol_solve", eager_ms("chol_solve"), per["chol_solve"] * b, by)
    sat = {}
    for (pts, planes, k, mask, lateral, slack), full in zip(probe.sat,
                                                              probe.sat_full):
        N = int(np.prod(full[:-2]))
        sat[full] = _hull_sat_bound(N, full[-2], planes.shape[-2], k,
                                    mask is not None, lateral,
                                    isinstance(slack, torch.Tensor))
    row("hull_ref_face_depth", eager_ms("hull_ref_face_depth"),
        sum(v[0] for v in sat.values()), max(sat.values())[1])
    (bq, _), info = probe.mtv[0], probe.mtv_full[0]
    lanes = int(np.prod(info["shape"][:-2]))
    b, by = _bound(*_mtv_work(bq, info["lanes_in_round"], lanes))
    row("mtv_query", eager_ms("mtv_query"), b, by)
    out["mtv_query"].update(lanes=lanes, live=info["live"],
                            lanes_in_round=info["lanes_in_round"],
                            K=mtv_query.K_EDGE)
    mask = torch.rand(nenv, device=m.device) < 0.01
    b, by = _bound(nenv + 4, nenv)
    row("graph_loop", _graph_ms(lambda: loops.any_cuda(mask)),
        per["graph_loop"] * b, by)
    out["face_sat_shapes"] = [list(k) for k in sat]
    return out


def manip_scale_size(m, nenv, nsteps, card):
    """manip_main_path's stirred step at nenv envs through mst.rollout:
    the eager reference (its launches, and the kernels' inputs and outputs
    for the envs at both ends of the batch at two steps), the manip
    checks, the graph held to eager bit for bit with its replay counts
    (graph_vs_eager), the captured kernel launches held to their twins,
    the first 1024 envs against the 1024-env batch, and each kernel's
    device ms a replayed step beside its bound.  Returns the phase's
    record and the card's state after SCALE_BAND_STEPS steps."""
    import mujoco_sim_tpu_torch as mst
    from mujoco_sim_tpu_torch.parallel.rollout import rollout_eager
    from mujoco_sim_tpu_torch.utils import graph
    t_size = time.perf_counter()
    what = f"manip_{nenv}"
    graph.clear_all()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    d0 = mst.make_data(m, nenv)
    stir = _stir(nenv, m.nu, m.device, m.dtype)
    ends = torch.cat([torch.arange(SCALE_ENDS),
                      torch.arange(nenv - SCALE_ENDS, nenv)]).to(m.device)
    _reset_counts()
    with _Probe(capture_calls=(nsteps // 2, nsteps), rows=ends) as probe:
        de = rollout_eager(m, d0, nsteps, ctrl_fn=stir)
        torch.cuda.synchronize()
    eager_peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
    counts = _counts()
    ncon_max, pos = _manip_checks(m, de, probe, counts, nsteps, what)
    # the eager state's carried leaves on d0's others (a step reads no
    # other): the eager steps after it, without a second Data of the batch
    from mujoco_sim_tpu_torch.parallel.rollout import RECURRENT
    eager_final = d0.replace(**{k: getattr(de, k) for k in RECURRENT})
    del de
    then = max(0, SCALE_BAND_STEPS - nsteps)
    res = graph_vs_eager(
        what, m, d0, nsteps, eager_final, card, ctrl_fn=stir,
        eager_steps=2, count_steps=2, then=then,
        need=("chol_solve", "graph_loop", "hull_ref_face_depth",
              "mtv_query"))
    del eager_final
    for k in ("chol_solve", "hull_ref_face_depth", "mtv_query",
              "graph_loop"):
        if not REPLAY_COUNTS[what][k]:
            raise AssertionError(f"{what}: {k} did not run in a replay")
    d50 = res["final"] if then else mst.rollout(m, d0, SCALE_BAND_STEPS,
                                                 ctrl_fn=stir)
    # the kernels' launches on the whole batch, at the envs of both ends
    held = hold_captures(probe.chol, probe.sat, what, probe.chol_out,
                         probe.sat_out)
    mtv_err, mtv_ties, live = 0.0, {}, 0
    for (b, enabled), got in zip(probe.mtv, probe.mtv_out):
        for name, (e, t) in compare_mtv(b, f"{what} capture", lanes=enabled,
                                        got=got).items():
            mtv_err = max(mtv_err, e) if name == "mtv_query" else mtv_err
            mtv_ties[name] = mtv_ties.get(name, 0) + t
        live += int(enabled.sum())
    if not probe.mtv:
        raise AssertionError(f"{what}: no exact-query input captured")
    # the first 1024 envs against the 1024-env batch from the same start
    first = slice(0, MANIP_NENV)
    d0s = mst.make_data(m, MANIP_NENV)
    stir_s = _stir(nenv, m.nu, m.device, m.dtype, rows=first)
    one = mst.rollout(m, d0, 1, ctrl_fn=stir).qpos[first]
    one_s = mst.rollout(m, d0s, 1, ctrl_fn=stir_s).qpos
    dev_one = float((one - one_s).abs().max())
    if not dev_one <= SHARD_TOL:
        raise AssertionError(f"{what}: the first {MANIP_NENV} envs after one "
                             f"step, {dev_one} from the {MANIP_NENV}-env "
                             "batch")
    d_s = mst.rollout(m, d0s, SCALE_BAND_STEPS, ctrl_fn=stir_s)
    sub = types.SimpleNamespace(qpos=d50.qpos[first], qvel=d50.qvel[first])
    band = _drift(sub, d_s, SCALE_BAND_STEPS)
    if band["fraction_within_band"] < MANIP_CROSS_FRACTION:
        raise AssertionError(f"{what}: the first {MANIP_NENV} envs after "
                             f"{SCALE_BAND_STEPS} steps: {band}")
    line = res["line"]["graph"]
    kernels = _scale_bounds(m, nenv, probe, what)
    rows = _spread(nenv, SCALE_CROSS_NENV)
    out = dict(
        nenv=nenv, steps=nsteps, launches_eager=counts,
        launches_eager_per_step={k: v / nsteps for k, v in counts.items()},
        finite=True, objects_in_bin=True,
        object_z_range=[float(pos[..., 2].min()), float(pos[..., 2].max())],
        ncon_max_seen=ncon_max, ncon_budget=m.ncon_max,
        env_steps_per_s=line["env_steps_per_s"],
        host_ms_per_step=line["host_ms_per_step"],
        device_ms_per_step=line["device_ms_per_step"],
        timed_steps=line["timed_steps"], timed_from=line["timed_from"],
        same_steps=res["line"]["same_steps"],
        pool_mb=line["pool_mb"], pool_mb_per_env=line["pool_mb"] / nenv,
        peak_mb_over_rollout=line["peak_mb_over_rollout"],
        eager_peak_mb=eager_peak_mb,
        max_reserved_mb=torch.cuda.max_memory_reserved() / 2**20,
        capture_s=line["capture_s"],
        replay_launches_per_step=REPLAY_COUNTS[what],
        kernels_per_step=kernels,
        kernels_vs_twins=dict(
            envs=f"0-{SCALE_ENDS - 1} and {nenv - SCALE_ENDS}-{nenv - 1} "
                 "(and envs with a live deep slot for the exact query), "
                 "rows of the launches on the whole batch",
            **held, mtv_query_max_abs_err=mtv_err, mtv_ties=mtv_ties,
            mtv_live_lanes=live),
        first_1024=dict(after_one_step=dev_one, tol=SHARD_TOL,
                        after_band_steps=band,
                        required_fraction=MANIP_CROSS_FRACTION),
        peaks="3.35 TB/s, 67 TFLOP/s f32",
        seconds=time.perf_counter() - t_size, card=card)
    card_rows = types.SimpleNamespace(qpos=d50.qpos[rows], qvel=d50.qvel[rows])
    return out, rows, card_rows


def manip_scale_main_path(card):
    """BASELINE config 5 at its scale: manip_bin6 at 8192 envs (bench.py's
    manip_8k) and 65 536 envs, each in one graph on one card
    (manip_scale_size); then the envs spread over each batch (the first
    and the last included) against the CPU in f64 after SCALE_BAND_STEPS
    stirred steps (cross_drift's measures and band), both sizes' envs in
    one CPU batch."""
    import mujoco_sim_tpu_torch as mst
    from mujoco_sim_tpu_torch.utils import graph
    m = mst.put_model(mst.load_model(MANIP))
    picked, records = [], {}
    for nenv, nsteps in MANIP_SCALE:
        rec, rows, card_rows = manip_scale_size(m, nenv, nsteps, card)
        phase(f"manip_scale_{nenv}", **rec)
        picked.append((nenv, rows, card_rows))
        records[nenv] = rec
    graph.clear_all()
    torch.cuda.empty_cache()
    m64 = mst.put_model(mst.load_model(MANIP), torch.float64, "cpu")
    phases_ = np.concatenate([_stir_phases(nenv, m.nu)[rows]
                              for nenv, rows, _ in picked])
    ref = mst.rollout(m64, mst.make_data(m64, len(phases_)),
                      SCALE_BAND_STEPS,
                      ctrl_fn=_stir_with(phases_, "cpu", torch.float64))
    out, at = {}, 0
    for nenv, rows, card_rows in picked:
        part = types.SimpleNamespace(qpos=ref.qpos[at:at + len(rows)],
                                     qvel=ref.qvel[at:at + len(rows)])
        at += len(rows)
        r = _drift(card_rows, part, SCALE_BAND_STEPS)
        within = r["fraction_within_band"]
        dpos = r["max_dev_object_position"]
        if within < MANIP_CROSS_FRACTION or not dpos <= MANIP_CROSS_POS_TOL:
            raise AssertionError(
                f"manip_{nenv} card f32 vs CPU f64: {within:.3f} of qpos "
                f"within {MANIP_CROSS_TOL}, objects off by up to {dpos} m")
        out[str(nenv)] = dict(r, envs=rows.tolist())
    phase("manip_scale_cross_check", scene="manip_bin6.xml",
          band=MANIP_CROSS_TOL, required_fraction=MANIP_CROSS_FRACTION,
          object_band=MANIP_CROSS_POS_TOL, **out)
    return {nenv: rec["kernels_per_step"] for nenv, rec in records.items()}


# ----------------------------------------------------------- runtime phase

def _consts(m):
    return dict(m.layout._consts)


def _same_consts(before, after):
    return after.keys() == before.keys() and all(
        after[k] is before[k] for k in before)


def _spawn_model(dtype, device):
    """bench.py's config 4 on the in-repo world: spawn_ball.xml composed
    with 4 instances, Euler as the bench sets it."""
    from mujoco_sim_tpu_torch import engine
    from mujoco_sim_tpu_torch.models import scene
    from mujoco_sim_tpu_torch.models.compile import compile_spec
    from mujoco_sim_tpu_torch.models.model import Integrator
    spec = scene.compose(WORLD, robots={
        "sball": scene.RobotConfig(path=BALL)}, instances=4)
    m = engine.set_const(compile_spec(spec))
    m = m.replace(opt=m.opt.replace(integrator=int(Integrator.EULER)))
    return engine.put_model(m, dtype, device)


def _ball_qadr(m, name):
    b = m.names.body_id(name)
    return int(m.layout.jnt_qposadr[m.layout.body_jntadr[b]])


def _spawn_state(m, nenv, seed):
    """Slots 2_* and 3_* inactive (bench_spawn's half); the two active
    balls, which compile at one pose, set apart at x = -0.3 and +0.3, as a
    spawn request would place them, with a seeded jitter of 5 cm in x and
    y per env; all drop from 0.5 m."""
    import mujoco_sim_tpu_torch as mst
    rng = np.random.default_rng(seed)
    d = mst.make_data(m, nenv)
    active = np.ones((nenv, m.nbody), bool)
    for i, name in enumerate(m.names.body):
        if name.startswith(("2_", "3_")):
            active[:, i] = False
    qpos = d.qpos.cpu().numpy().astype(np.float64)
    for name, x0 in (("sball", -0.3), ("1_sball", 0.3)):
        qa = _ball_qadr(m, name)
        qpos[:, qa] = x0 + rng.uniform(-0.05, 0.05, nenv)
        qpos[:, qa + 1] = rng.uniform(-0.05, 0.05, nenv)
    return d.replace(
        qpos=torch.tensor(qpos, dtype=d.qpos.dtype, device=d.qpos.device),
        body_active=torch.as_tensor(active, device=d.qpos.device))


def spawn_main_path(card):
    """The spawn scene at 4096 envs in f32 on the card: 100 + 200 steps of
    parallel.rollout, the checks of the runtime's batch services on the
    final state (health, auto_reset, checkpoint), the plan cache across a
    mid-rollout flip of the masks, and f32 card vs f64 CPU."""
    import tempfile
    import mujoco_sim_tpu_torch as mst
    from mujoco_sim_tpu_torch.runtime import checkpoint, health
    from mujoco_sim_tpu_torch.utils.struct import leaves_with_keys, map_leaves
    m = _spawn_model(torch.float32, "cuda")
    n = NENV
    d0 = _spawn_state(m, n, 4)
    inactive = [_ball_qadr(m, nm) for nm in ("2_sball", "3_sball")]
    q_inactive0 = torch.cat([d0.qpos[:, a:a + 7] for a in inactive], 1)

    from mujoco_sim_tpu_torch.parallel.rollout import rollout_eager
    _reset_counts()
    torch.cuda.synchronize()
    # the eager reference; the solves of a step in the air and of two
    # steps at rest are kept
    with _Probe(capture_calls=(50, 150, 250)) as probe:
        d100 = rollout_eager(m, d0, 100)
        d = rollout_eager(m, d100, 200)
        torch.cuda.synchronize()
    launches = _counts()["chol_solve"]
    # the main path: parallel.rollout through the step graph, held to it
    graph_counts = graph_vs_eager("spawn", m, d0, 300, d, card)["capture"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d100 = mst.rollout(m, d0, 100)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    d = mst.rollout(m, d100, 200)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if launches < 300:
        raise AssertionError(f"spawn: chol_solve ran {launches} times in "
                             "300 steps")
    bad = _float_leaves_finite(d)
    if bad:
        raise AssertionError(f"spawn: non-finite leaves: {bad}")
    z = torch.stack([d.qpos[:, _ball_qadr(m, nm) + 2]
                     for nm in ("sball", "1_sball")], 1)
    zdev = float((z - BALL_REST_Z).abs().max())
    if not zdev <= BALL_REST_TOL:
        raise AssertionError(f"spawn: active balls not at rest on the "
                             f"floor: |z - 0.1| up to {zdev}")
    q_inactive = torch.cat([d.qpos[:, a:a + 7] for a in inactive], 1)
    if not torch.equal(q_inactive, q_inactive0):
        raise AssertionError("spawn: an inactive body moved")
    healthy = health.env_healthy(d)
    saturated = health.contact_saturated(m, d)
    if not bool(healthy.all()) or bool(saturated.any()):
        raise AssertionError(f"spawn: {int((~healthy).sum())} unhealthy, "
                             f"{int(saturated.sum())} saturated envs")

    # auto_reset mends exactly the poisoned envs, the rest bit-identical
    rng = np.random.default_rng(11)
    bad_envs = np.sort(rng.choice(n, POISONED, replace=False))
    bad_t = torch.as_tensor(bad_envs, device=m.device)
    qvel = d.qvel.clone()
    qvel[bad_t, 0] = float("nan")
    dp = d.replace(qvel=qvel)
    mended, mask = health.auto_reset(m, dp)
    if not torch.equal(torch.nonzero(~mask)[:, 0], bad_t):
        raise AssertionError("auto_reset: the unhealthy mask is not the "
                             "poisoned envs")
    fresh = dict(leaves_with_keys(mst.make_data(m, 1)))
    keep = torch.as_tensor(np.setdiff1d(np.arange(n), bad_envs),
                           device=m.device)
    diffs = [k for (k, a), (_, b) in zip(leaves_with_keys(mended),
                                         leaves_with_keys(dp))
             if not torch.equal(a[keep], b[keep])
             or not torch.equal(a[bad_t], fresh[k].expand_as(a[bad_t]))]
    if diffs:
        raise AssertionError(f"auto_reset: {diffs} changed a healthy env "
                             "or left a poisoned one unmended")

    # the 4096-env checkpoint round-trips bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "spawn.npz")
        tc = time.perf_counter()
        checkpoint.save_state(d, path, extra={"nenv": n})
        d2, meta = checkpoint.load_state(m, path)
        ck_s = time.perf_counter() - tc
        ck_mb = os.path.getsize(path) / 2 ** 20
    same = all(a.dtype == b.dtype and torch.equal(a, b)
               for (_, a), (_, b) in zip(leaves_with_keys(d),
                                         leaves_with_keys(d2)))
    if not same or meta != {"nenv": n}:
        raise AssertionError("checkpoint: the 4096-env batch did not "
                             "round-trip bit for bit")

    # flip the masks mid-rollout: slot 2 wakes in half the envs, slot 1
    # sleeps in the other half; the plans are reused, none is built
    before = _consts(m)
    ba = d.body_active.clone()
    half = n // 2
    ba[:half, m.names.body_id("2_sball")] = True
    ba[half:, m.names.body_id("1_sball")] = False
    d3 = mst.rollout(m, d.replace(body_active=ba), 20)
    torch.cuda.synchronize()
    flip_dev = float((d3.qpos - rollout_eager(
        m, d.replace(body_active=ba), 20).qpos).abs().max())
    if flip_dev != 0.0:
        raise AssertionError(f"spawn: the graph after the mask flip is "
                             f"{flip_dev} from the eager rollout")
    if not _same_consts(before, _consts(m)):
        raise AssertionError("spawn: the plan cache changed when the masks "
                             "flipped")
    bad = _float_leaves_finite(d3)
    if bad:
        raise AssertionError(f"spawn: non-finite leaves after the flip: "
                             f"{bad}")

    held = hold_captures(probe.chol, probe.sat, "spawn")
    del probe
    cross = spawn_cross_check(m, map_leaves(lambda x: x[:64], d100))
    steps_s = t2 - t1
    phase("spawn_main_path", scene="world_empty.xml + 4 x spawn_ball.xml, "
          "Euler, slots 2_* and 3_* inactive", nenv=n, steps=300,
          timed="the last 200 of 300 graph steps",
          step_ms=1e3 * steps_s / 200, first_100_steps_s=t1 - t0,
          env_steps_per_s=n * 200 / steps_s,
          chol_launches=launches, chol_launches_per_step=launches / 300,
          graph_launches=graph_counts, mask_flip_graph_vs_eager=flip_dev,
          max_rest_dev=zdev, inactive_still=True, healthy=True,
          saturated=0, auto_reset_mended=POISONED,
          checkpoint_mb=ck_mb, checkpoint_round_trip_s=ck_s,
          plan_cache_entries=len(before), plan_cache_unchanged=True,
          kernels_at_path_inputs=held, cross_check=cross, card=card)
    return launches, held


def spawn_cross_check(m, d_start, nsteps=100):
    """64 envs from the card's state after 100 steps (in the air, landing
    at ~145): 100 more steps in f32 on the card and in f64 on the CPU."""
    import mujoco_sim_tpu_torch as mst
    from mujoco_sim_tpu_torch.utils.struct import map_leaves
    m64 = _spawn_model(torch.float64, "cpu")
    d64 = map_leaves(lambda x: (x.double() if x.is_floating_point() else x)
                     .cpu(), d_start)
    outs = []
    for mm_, dd in ((m, d_start), (m64, d64)):
        dd = mst.rollout(mm_, dd, nsteps)
        outs.append((dd.qpos.double().cpu(), dd.qvel.double().cpu()))
    dq = float((outs[0][0] - outs[1][0]).abs().max())
    dv = float((outs[0][1] - outs[1][1]).abs().max())
    if not dq <= CROSS_TOL or not dv <= CROSS_TOL:
        raise AssertionError(f"spawn card f32 vs CPU f64 deviation qpos "
                             f"{dq}, qvel {dv} > {CROSS_TOL}")
    return dict(nenv=d_start.qpos.shape[0], steps=nsteps, max_dev_qpos=dq,
                max_dev_qvel=dv, tolerance=CROSS_TOL)


class _Timed:
    """The port's client with each call's wall time kept (op, ms)."""

    def __init__(self, port):
        from mujoco_sim_tpu_torch.io.client import SimClient
        self.c = SimClient(port=port, timeout=SERVER_DEADLINE)
        self.ms = []

    def call(self, op, **kw):
        t0 = time.perf_counter()
        r = self.c.call(op, **kw)
        self.ms.append((op, 1e3 * (time.perf_counter() - t0)))
        if "error" in r:
            raise AssertionError(f"server: {op} failed: {r['error']}")
        return r

    def close(self):
        # SimClient.close() closes the socket, but the connection stays
        # open while the client's file object lives: close that too, or
        # the server goes on streaming to it
        self.c.f.close()
        self.c.close()


def _latency(c, n=20):
    """p50 and max wall ms of n get_state requests."""
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        c.call("get_state")
        ms.append(1e3 * (time.perf_counter() - t0))
    return dict(requests=n, p50_ms=statistics.median(ms), max_ms=max(ms))


def _until(cond, what):
    deadline = time.monotonic() + SERVER_DEADLINE
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"server: no {what} within {SERVER_DEADLINE} s")


def _alive(srv):
    if not srv._sim_thread.is_alive():
        raise AssertionError(f"server: the sim thread died:\n{srv.sim_error}")


def _server_step_vs_eager(srv, sim, capture_calls, what):
    """Between two of the sim thread's steps (under its lock): one eager
    step at the simulation's state with the kernels' inputs kept at
    ``capture_calls``, and one call of the simulation's step graph at the
    same state, held to it bit for bit, under set_sync_debug_mode("error")
    (it raises at any host sync); then one more replay and eager step at
    that state, their hand-written kernels counted (hold_replay_counts).
    Returns the probe and the record."""
    from mujoco_sim_tpu_torch import engine
    with srv._lock:
        d = sim.d
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _Probe(capture_calls=capture_calls) as probe:
            de = engine.step(sim.m, d)
            torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            dg = sim.step_graph(sim.m, d)
            torch.cuda.synchronize()
            graph_ms = (time.perf_counter() - t0) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode(0)
        cap = sim.step_graph.last
        pool_mb, capture_s = cap.pool_mb, cap.capture_s
        del cap
        rep = hold_replay_counts(what, lambda: sim.step_graph(sim.m, d),
                                 lambda: engine.step(sim.m, d), 1)
    diffs = {k: float((getattr(dg, k) - getattr(de, k)).abs().max())
             if getattr(dg, k).numel() else 0.0 for k in GRAPH_FIELDS}
    if any(v != 0.0 for v in diffs.values()):
        raise AssertionError(f"server: graph step vs eager step {diffs}")
    return probe, dict(held="bit for bit", max_abs_diff=diffs,
                       replay_kernels=_replay_record(rep, 1),
                       sync_free_replay=True, eager_step_ms=eager_ms,
                       graph_step_ms=graph_ms, pool_mb=pool_mb,
                       capture_s=capture_s,
                       captures=sim.step_graph.captures)


def server_main_path(card):
    """One env on the RK4 world, as the reference runs it, served over TCP
    on a free local port: the scenario of tests/test_server.py through the
    port's client, then a second server for cmd_vel."""
    import tempfile
    from mujoco_sim_tpu_torch.io.server import SimServer
    from mujoco_sim_tpu_torch.ops import hull_sat
    from mujoco_sim_tpu_torch.runtime import config
    spec, m, sim, _ = config.build(
        {"world": WORLD, "robots": {"sball": {"path": BALL}},
         "spawn_instances": 4}, device="cuda")
    if m.opt.integrator != 1:
        raise AssertionError("server: the world is not RK4")
    dt = float(m.opt.timestep)
    srv = SimServer(sim, port=0, spec=spec, asset_dirs=[FIXTURES])
    swaps = []
    hot_swap = sim.hot_swap

    def spy(new_m, spawnable):       # the state on either side of the swap
        old_m, old_d = sim.m, sim.d
        hot_swap(new_m, spawnable)
        swaps.append((old_m, old_d, sim.m, sim.d))
        return sim.d

    sim.hot_swap = spy
    _reset_counts()
    srv.start(run_sim=True)
    c = _Timed(srv.port)
    try:
        names = []
        for i in range(3):
            a = 2 * np.pi * i / 3
            names += c.call("spawn_objects", objects=[{
                "info": {"name": f"ball{i}", "type": 1}, "class": "sball",
                "pose": [0.6 * np.cos(a), 0.6 * np.sin(a), 0.5,
                         1, 0, 0, 0]}])["names"]
        t_stream, steps0 = time.perf_counter(), srv.steps
        stream = _Timed(srv.port)
        for msg in stream.c.subscribe(["object_states"], rate=30.0):
            if msg["object_states"]["time"] >= 0.6:
                break
            if time.perf_counter() - t_stream > SERVER_DEADLINE:
                raise AssertionError("server: sim time did not reach "
                                     f"0.6 s in {SERVER_DEADLINE} s")
        wall = time.perf_counter() - t_stream
        stream.close()
        nsteps = srv.steps - steps0
        # the sim thread steps through its step graph: the wrappers count
        # its warm-up call and its capture, not its replays
        graph_launches = _counts()
        _alive(srv)
        if nsteps == 0 or graph_launches["chol_solve"] == 0:
            raise AssertionError(f"server: {graph_launches} launches for "
                                 f"{nsteps} sim-thread steps")
        # the sim thread's graph step held to the eager step at its own
        # state (under the lock, between two of its steps), and the
        # solves (nv = 24) of that eager step kept: RK4 runs collision 4
        # times a step
        probe_balls, graph_balls = _server_step_vs_eager(srv, sim, (1, 3),
                                                          "server_balls")
        state = c.call("get_state", names=names)
        zs = [o["pose"]["position"][2] for o in state["objects"]]
        if len(zs) != 3 or max(abs(z - BALL_REST_Z) for z in zs) > \
                BALL_REST_TOL:
            raise AssertionError(f"server: the balls did not land: {zs}")
        # a request waits for the step in progress; a subscriber's
        # publisher also waits for the lock on the server's event loop
        lat_idle = _latency(c)
        sub = _Timed(srv.port)
        next(iter(sub.c.subscribe(["object_states"], rate=30.0)))
        lat_sub = _latency(c)
        sub.close()
        final = c.call("destroy_objects", names=names[2:])["object_states"]
        if len(final[0]["pose"]) != 7 or abs(
                final[0]["pose"][2] - BALL_REST_Z) > BALL_REST_TOL:
            raise AssertionError(f"server: destroy answered {final}")
        if not c.call("reset")["success"]:
            raise AssertionError("server: reset failed its verification")
        with tempfile.TemporaryDirectory() as tmp:
            files = c.call("screenshot", out_dir=tmp, name="shot")["files"]
            if sorted(files) != ["data_txt", "model_txt", "state", "xml"] \
                    or not all(os.path.getsize(f) > 0
                               for f in files.values()):
                raise AssertionError(f"server: screenshot wrote {files}")
        service_ms = {}
        for op, ms in c.ms:
            if op != "get_state":
                service_ms.setdefault(op, []).append(ms)
        # the hot-swap path: cube.stl is no registered class; found through
        # asset_dirs, it is compiled in with two slots and swapped in
        t_swap = time.perf_counter()
        cube0 = c.call("spawn_objects", objects=[{
            "info": {"name": "cube", "type": 3, "mesh": "cube.stl"},
            "pose": [0, 0, 0.12, 1, 0, 0, 0]}])["names"]
        swap_ms = 1e3 * (time.perf_counter() - t_swap)
        if len(swaps) != 1:
            raise AssertionError("server: the mesh spawn did not hot-swap")
        old_m, old_d, new_m, new_d = swaps[0]
        for nm in names[:2]:
            slot = sim.by_public_name[nm]
            jn = new_m.names.joint[slot.free_jnt]
            jo = old_m.names.joint_id(jn)
            qo = int(old_m.layout.jnt_qposadr[jo])
            if not torch.equal(new_d.qpos[0, slot.qpos_adr:slot.qpos_adr + 7],
                               old_d.qpos[0, qo:qo + 7]):
                raise AssertionError(f"server: {nm}'s qpos changed across "
                                     "the hot swap")
        # the second cube (the registered class now, no swap) drops onto
        # the first: a mesh-mesh pair for the face-SAT kernel
        cube1 = c.call("spawn_objects", objects=[{
            "info": {"name": "cube", "type": 3, "mesh": "cube.stl"},
            "pose": [0.02, 0.01, 0.36, 1, 0, 0, 0]}])["names"]
        if len(swaps) != 1:
            raise AssertionError("server: a registered class hot-swapped")
        top = sim.by_public_name[cube1[0]].qpos_adr + 2
        _until(lambda: float(sim.d.qpos[0, top]) < 0.32, "cube landing")
        steps1 = srv.steps
        _until(lambda: srv.steps >= steps1 + 20, "20 steps after")
        # the solves (nv = 36 after the swap) and the cubes' face SAT of
        # an eager step at the sim thread's state, 20 steps on
        sat0 = hull_sat.LAUNCHES
        probe_cubes, graph_cubes = _server_step_vs_eager(srv, sim, (1, 3),
                                                          "server_cubes")
        sat_launches = hull_sat.LAUNCHES - sat0
        sat_steps = 1
        if sat_launches == 0:
            raise AssertionError("server: no hull_ref_face_depth launch "
                                 "with the two cubes in contact")
        t_end, steps_end = time.perf_counter(), srv.steps
        _alive(srv)
        sim_time = float(sim.d.time[0])
        if sim_time <= 0:
            raise AssertionError("server: sim time did not advance")
        chol_total = _counts()["chol_solve"]
        c.call("destroy_objects", names=names[:2] + cube0 + cube1)
    finally:
        c.close()
        srv.stop()
    if srv._sim_thread.is_alive():
        raise AssertionError("server: the sim thread did not stop")
    if not probe_cubes.sat:
        raise AssertionError("server: no face-SAT input of the cube pair "
                             "captured")
    held = {name: hold_captures(p.chol, p.sat, f"server {name}")
            for name, p in (("balls", probe_balls),
                            ("cube_pair", probe_cubes))}
    del probe_balls, probe_cubes
    odom = odom_server(card)
    phase("server_main_path", scene="world_empty.xml (RK4) + 4 x "
          "spawn_ball.xml slots, one env", dt=dt,
          timed="sim-thread steps while one client streams object_states "
          "at 30 Hz, from the spawn of three balls to sim time 0.6 s",
          steps_per_s=nsteps / wall, rtf=nsteps * dt / wall,
          window_steps=nsteps, window_s=wall,
          step="the sim thread's step graph (one replay a step)",
          graph_launches=graph_launches,
          graph_vs_eager=dict(balls=graph_balls, cube_pair=graph_cubes),
          get_state_latency=lat_idle,
          get_state_latency_with_30hz_subscriber=lat_sub,
          service_request_ms=service_ms, hot_swap_request_ms=swap_ms,
          cube_pair_hull_ref_face_depth_launches=sat_launches,
          cube_pair_steps=sat_steps, kernels_at_path_inputs=held,
          sim_thread_steps=steps_end, sim_time_after_reset=sim_time,
          chol_launches=chol_total, odom=odom, card=card,
          wall_s=t_end - t_stream)
    return chol_total, sat_launches, sat_steps, held


def odom_server(card):
    """benchbot.xml with odom joints on the RK4 world: cmd_vel sets the
    odom joints' velocity; the base moves forward and turns."""
    from mujoco_sim_tpu_torch.io.server import SimServer
    from mujoco_sim_tpu_torch.runtime import config
    spec, m, sim, meta = config.build(
        {"world": WORLD, "robot": BENCHBOT,
         "add_odom_joints": {"benchbot": True}}, device="cuda")
    srv = SimServer(sim, port=0, spec=spec, robots=meta)
    srv.start(run_sim=True)
    c = _Timed(srv.port)
    try:
        cmd = [0.4, 0.0, 0.0, 0.0, 0.0, 0.3]
        c.call("cmd_vel", robot="benchbot", twist=cmd)
        s0 = srv.steps
        _until(lambda: srv.steps >= s0 + 3, "steps after cmd_vel")
        msgs = []
        for msg in c.c.subscribe(["base_pose"], rate=10.0):
            msgs.append(msg["base_pose"]["odom"][0])
            if len(msgs) == 2:
                break
        _alive(srv)
    finally:
        c.close()
        srv.stop()
    first, last = msgs
    dt = float(m.opt.timestep)
    yaw0 = last["pose"][5] - dt * last["twist"][5]
    want = [cmd[0] * np.cos(yaw0), cmd[0] * np.sin(yaw0)]
    dev = max(abs(last["twist"][0] - want[0]),
              abs(last["twist"][1] - want[1]),
              abs(last["twist"][5] - cmd[5]))
    if not dev <= ODOM_TOL:
        raise AssertionError(f"odom: twist {last['twist']} vs command "
                             f"{cmd} at yaw {yaw0}: {dev}")
    if not (last["pose"][0] > first["pose"][0]
            and last["pose"][5] > first["pose"][5]):
        raise AssertionError(f"odom: x and yaw did not rise: {first} -> "
                             f"{last}")
    return dict(twist_dev=dev, x=[first["pose"][0], last["pose"][0]],
                yaw=[first["pose"][5], last["pose"][5]])


def loop_main_path(card):
    """SimLoop paced to the wall clock on the RK4 ball world, one env,
    max_time_step 4x the nominal step: the RTF and the step the governor
    settles on."""
    import mujoco_sim_tpu_torch as mst
    from mujoco_sim_tpu_torch.runtime.loop import SimLoop
    from mujoco_sim_tpu_torch.runtime.sim import Simulation
    from mujoco_sim_tpu_torch.models import scene
    from mujoco_sim_tpu_torch.models.compile import compile_spec
    spec = scene.compose(WORLD, robots={
        "sball": scene.RobotConfig(path=BALL)}, instances=2)
    sim = Simulation(mst.set_const(compile_spec(spec)),
                     spawnable={"sball": ["sball", "1_sball"]})
    sim.spawn("sball", "a", pose=np.array([-0.3, 0, 0.5, 1, 0, 0, 0]))
    sim.spawn("sball", "b", pose=np.array([0.3, 0, 0.5, 1, 0, 0, 0]))
    nominal = float(sim.m.opt.timestep)
    loop = SimLoop(sim.m, sim.d, max_time_step=4 * nominal, real_time=True)
    t0 = time.perf_counter()
    d = loop.run(0.5)
    wall = time.perf_counter() - t0
    if float(d.time[0]) < 0.5 or _float_leaves_finite(d):
        raise AssertionError("loop: did not reach 0.5 s of finite state")
    phase("loop_main_path", scene="world_empty.xml (RK4) + 2 balls, one env",
          sim_s=float(d.time[0]), wall_s=wall, rtf=loop.rtf,
          nominal_dt=nominal, max_dt=loop.max_dt,
          settled_dt=loop.current_dt,
          step_graph_captures=loop.step_graph.captures, card=card)


# ----------------------------------------------------------- parallel path

def parallel_main_path(card):
    """The JAX package's scaling workload (benchmarks/scaling.py: floor_box,
    512 envs a device over 8 devices) at full width on one card, with
    bench.py's seeded jitter (lift and spin): 4096 envs in four shards on
    cuda:0 against the unsharded rollout of the same batch, the ring
    exchange, the trajectory egress against the one-call trajectory, the
    sharded batch's egress against its shards' own trajectories and the
    unsharded one step by step, and one NCCL process through
    parallel.distributed."""
    import mujoco_sim_tpu_torch as mst
    from mujoco_sim_tpu_torch.parallel import egress, mesh as pmesh
    m = mst.put_model(mst.load_model(BOX))
    d0 = _with_state(*_jittered(m, NENV, 9))
    mesh = pmesh.make_env_mesh(["cuda:0"] * PARALLEL_SHARDS)
    mR = pmesh.replicate_model(m, mesh)
    if mR.on("cuda:0") is not m:
        raise AssertionError("replicate_model copied the model onto the "
                             "device it is on")
    dS = pmesh.shard_batch(d0, mesh)
    per = NENV // PARALLEL_SHARDS
    nsteps = 150
    run = pmesh.make_sharded_rollout(mR, mesh, nsteps)

    # a. the eager sharded rollout (each shard's rollout_eager), with two
    # steps of each shard's solves kept: the reference of the sharded
    # graphs
    from mujoco_sim_tpu_torch.ops import loops
    from mujoco_sim_tpu_torch.parallel.rollout import rollout_eager
    _reset_counts()
    torch.cuda.synchronize()
    with _Probe(capture_calls=[k * nsteps + s for k in range(
            PARALLEL_SHARDS) for s in (20, 120)]) as probe:
        t0 = time.perf_counter()
        eager = [rollout_eager(mR.on(dv), sh, nsteps)
                 for dv, sh in zip(mesh.local_devices, dS.shards)]
        torch.cuda.synchronize()
        eager_sharded_s = time.perf_counter() - t0
    launches = _counts()["chol_solve"]
    if launches < PARALLEL_SHARDS * 2 * nsteps:
        raise AssertionError(f"parallel: chol_solve ran {launches} times "
                             f"in {nsteps} steps of {PARALLEL_SHARDS} "
                             "shards")
    # the main path: make_sharded_rollout, one step graph per shard, held
    # to the eager shards bit for bit; then timed on its captured graphs
    _reset_counts()
    loops.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(mR, dS)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    graph_counts = dict(_counts(), graph_loop=loops.LAUNCHES)
    shard_diff = max(float((o.qpos - e.qpos).abs().max()) for o, e in
                     zip(out.shards, eager))
    if shard_diff != 0.0:
        raise AssertionError(f"parallel: sharded graphs vs eager shards "
                             f"{shard_diff}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(mR, dS)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    torch.cuda.set_sync_debug_mode("error")
    try:
        run.graphs[0](mR.on("cuda:0"), dS.shards[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    pools = [g.last.pool_mb for g in run.graphs]
    capture_s = [g.last.capture_s for g in run.graphs]
    shards = list(zip(run.graphs, mesh.local_devices, out.shards))
    rep = hold_replay_counts(
        "parallel", lambda: [g.run(mR.on(dv), sh, n=3)
                             for g, dv, sh in shards],
        lambda: [rollout_eager(mR.on(dv), sh, 3) for _, dv, sh in shards],
        3)
    phase("parallel_graph", steps=nsteps, shards=PARALLEL_SHARDS,
          held="bit for bit, shard by shard", max_abs_diff_qpos=shard_diff,
          launches_capture=graph_counts,
          replay_kernels=dict(_replay_record(rep, 3),
                              step="one step of each of the four shards"),
          sync_free_replay=True,
          eager=dict(env_steps_per_s=NENV * nsteps / eager_sharded_s,
                     host_ms_per_step=eager_sharded_s / nsteps * 1e3),
          graph=dict(env_steps_per_s=NENV * nsteps / sharded_s,
                     host_ms_per_step=sharded_s / nsteps * 1e3,
                     first_call_s=first_s, pool_mb_per_shard=pools,
                     capture_s=capture_s),
          card=card)
    mst.rollout(m, d0, 1)          # its capture, outside the timing
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = mst.rollout(m, d0, nsteps)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    got = out.gather()
    bad = _float_leaves_finite(got)
    if bad:
        raise AssertionError(f"parallel: non-finite leaves: {bad}")
    bit_equal = all(torch.equal(getattr(got, k), getattr(ref, k))
                    for k in ("qpos", "qvel", "xpos", "xquat", "qacc"))
    dev = float((got.qpos - ref.qpos).abs().max())
    if not dev <= SHARD_TOL:
        raise AssertionError(f"parallel: sharded qpos {dev} from the "
                             f"unsharded rollout, over {SHARD_TOL}")
    ok, zmin, zmax, vmax = _settled(got, [0.08], 0.12 + 0.01, 0.05)
    held = hold_captures(probe.chol, [], "parallel")
    del probe

    # b. the ring: shard i receives shard i-1's block of envs, on the
    # unsharded final state split over the mesh and on the sharded one
    def ring_is_roll(dS, d):
        pos, quat = pmesh.exchange_body_state(dS, mesh, 1)
        return (torch.equal(pos.gather(), torch.roll(d.xpos[:, 1], per, 0))
                and torch.equal(quat.gather(),
                                torch.roll(d.xquat[:, 1], per, 0)))

    ring_plain = ring_is_roll(pmesh.shard_batch(ref, mesh), ref)
    ring = ring_is_roll(out, got)
    if not (ring and ring_plain):
        raise AssertionError("parallel: the ring is not the block roll")

    # c. egress: chunked rollout_traj without and with the copies out
    n_eg, chunk = 256, 64
    cache = {}
    final, traj = pmesh.rollout_traj(m, d0, n_eg)
    collected = []

    def chunked():
        d = d0
        for _ in range(n_eg // chunk):
            d, _ = pmesh.rollout_traj(m, d, chunk)

    # in turns (chunked, egress, egress, chunked), best of 2 each;
    # rollout_collect times each chunk's read-out (the wait on its copy
    # and the memcpy out of the pinned buffer) into cache["read_s"]
    times = {"c": [], "e": []}
    for c in "ceec":
        times[c] += _timed_rollouts(chunked if c == "c" else (
            lambda: collected.append(egress.rollout_collect(
                m, d0, n_eg, chunk, jit_cache=cache))), 1)
    reads = cache["read_s"]
    rate_chunked = NENV * n_eg / min(times["c"])
    rate_egress = NENV * n_eg / min(times["e"])
    ref_traj = traj.cpu().numpy()
    for got_final, host in collected:
        if not (np.array_equal(host, ref_traj)
                and torch.equal(got_final.qpos, final.qpos)):
            dev_step = np.abs(host - ref_traj).max(axis=(1, 2))
            raise AssertionError(
                "egress: the chunked trajectory differs from the one-call "
                f"rollout_traj: final {float((got_final.qpos - final.qpos).abs().max())}, "
                f"first differing step {int(np.flatnonzero(dev_step)[0]) + 1 if dev_step.any() else None}, "
                f"max {float(dev_step.max())}, steps 1-3 {dev_step[:3].tolist()}, "
                f"64-66 {dev_step[63:66].tolist()}")

    # the sharded batch egresses shard by shard into its env columns, as
    # benchmarks/scaling.py egresses its sharded batch: equal bit for bit
    # to each shard's own rollout_traj, and at every step within SHARD_TOL
    # of the unsharded trajectory
    n_sh, chunk_sh = 128, 32
    sh_final, sh_traj = egress.rollout_collect(mR, dS, n_sh, chunk_sh,
                                               jit_cache=cache)
    own = [pmesh.rollout_traj(mR.on(dev), s, n_sh)
           for dev, s in zip(mesh.local_devices, dS.shards)]
    if not (np.array_equal(sh_traj, torch.cat([t for _, t in own],
                                              1).cpu().numpy())
            and all(torch.equal(f.qpos, g.qpos)
                    for (f, _), g in zip(own, sh_final.shards))):
        raise AssertionError("egress: the sharded trajectory differs from "
                             "its shards' rollout_traj")
    step_dev = np.abs(sh_traj - traj[:n_sh].cpu().numpy()).max(axis=(1, 2))
    if not step_dev.max() <= SHARD_TOL:
        raise AssertionError(
            f"parallel: sharded trajectory {step_dev.max()} from the "
            f"unsharded at step {int(step_dev.argmax()) + 1}, over "
            f"{SHARD_TOL}")
    first = np.flatnonzero(step_dev)

    # d. one NCCL process: initialize, the global mesh, a host-local batch
    dist_out = parallel_distributed(m, d0, traj)
    phase("parallel_main_path", scene="floor_box.xml", nenv=NENV,
          shards=PARALLEL_SHARDS, mesh=[str(x) for x in mesh.devices],
          steps=nsteps, sharded_bit_equal=bit_equal, sharded_max_dev=dev,
          sharded_tol=SHARD_TOL,
          sharded_traj=dict(steps=n_sh, chunk=chunk_sh,
                            bit_equal_own_shards=True,
                            max_dev=float(step_dev.max()),
                            max_dev_step=int(step_dev.argmax()) + 1,
                            dev_at_step_20=float(step_dev[19]),
                            first_differing_step=(int(first[0]) + 1
                                                  if first.size else None)),
          settled=bool(ok.all()), z_range=[zmin, zmax], max_speed=vmax,
          sharded_s=sharded_s, unsharded_s=plain_s,
          sharded_env_steps_per_s=NENV * nsteps / sharded_s,
          unsharded_env_steps_per_s=NENV * nsteps / plain_s,
          chol_launches=launches,
          chol_launches_per_step=launches / nsteps,
          chol_launches_per_shard_step=launches / nsteps / PARALLEL_SHARDS,
          kernels_at_path_inputs=held, ring_block=per,
          ring_unsharded_equals_roll=ring_plain,
          ring_sharded_equals_roll=ring,
          egress=dict(steps=n_eg, chunk=chunk, traj_shape=list(host.shape),
                      traj_mb=host.nbytes / 2 ** 20, bit_equal=True,
                      chunked_env_steps_per_s=rate_chunked,
                      egress_env_steps_per_s=rate_egress,
                      egress_overhead_pct=100.0 * (
                          1.0 - rate_egress / rate_chunked),
                      chunked_s=times["c"], egress_s=times["e"],
                      read_ms_per_chunk=[1e3 * r for r in reads[-(
                          n_eg // chunk):]],
                      timed="in turns c e e c, best of 2 each"),
          distributed=dist_out, card=card)
    return launches, held


def parallel_distributed(m, d0, traj):
    """initialize with one NCCL process on a free port, global_env_mesh,
    host_local_batch of the same 4096 envs, a 50-step sharded rollout
    (held to step 50 of the plain trajectory ``traj`` from d0) and the
    ring through NCCL point-to-point (one process: its block comes back
    to it)."""
    import socket
    import torch.distributed as dist
    from mujoco_sim_tpu_torch.parallel import distributed as D
    from mujoco_sim_tpu_torch.parallel import mesh as pmesh
    from mujoco_sim_tpu_torch.utils.struct import map_leaves
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    D.initialize(f"127.0.0.1:{port}", 1, 0, device="cuda", timeout=120)
    try:
        backend = dist.get_backend()
        if backend != "nccl":
            raise AssertionError(f"initialize chose {backend}, not nccl")
        mesh = D.global_env_mesh()
        if mesh.world != 1 or mesh.local_devices != (torch.device(
                "cuda", 0),):
            raise AssertionError(f"global_env_mesh: {mesh}")
        def env(i):
            return map_leaves(lambda x: x[i:i + 1], d0)

        dS = D.host_local_batch(env, NENV, mesh)
        nsteps = 50
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = pmesh.make_sharded_rollout(m, mesh, nsteps)(m, dS)
        torch.cuda.synchronize()
        roll_s = time.perf_counter() - t1
        got = out.gather()
        if not torch.equal(got.qpos, traj[nsteps - 1]):
            raise AssertionError("distributed: the one-process rollout "
                                 "differs from the plain one")
        pos, quat = pmesh.exchange_body_state(out, mesh, 1)
        torch.cuda.synchronize()
        if not (torch.equal(pos.gather(), got.xpos[:, 1])
                and torch.equal(quat.gather(), got.xquat[:, 1])):
            raise AssertionError("distributed: the NCCL self-ring changed "
                                 "the block")
    finally:
        dist.destroy_process_group()
    return dict(backend=backend, world=1, nenv=NENV, steps=nsteps,
                rollout_s=roll_s, env_steps_per_s=NENV * nsteps / roll_s,
                bit_equal_plain=True, nccl_self_ring=True,
                seconds=time.perf_counter() - t0)


def cli_export_path(card):
    """The CLI's render of the manip scene after 20 steps on the card, and
    the USD stage and OWL ABox of the card's env-0 state."""
    import importlib.util
    import tempfile
    import mujoco_sim_tpu_torch as mst
    from mujoco_sim_tpu_torch.__main__ import main as cli
    from mujoco_sim_tpu_torch.export import owl, usd
    from mujoco_sim_tpu_torch.utils.struct import host_env
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "manip.png")
        t0 = time.perf_counter()
        if has_mpl:
            if cli(["render", MANIP, png, "--steps", "20"]) != 0:
                raise AssertionError("render: the CLI returned non-zero")
            png_kb = os.path.getsize(png) / 1024
            if not png_kb > 10:
                raise AssertionError(f"render: {png_kb} KB PNG")
        render_s = time.perf_counter() - t0
        m = mst.put_model(mst.load_model(MANIP))
        d = mst.forward(m, mst.rollout(m, mst.make_data(m, 1), 20))
        hm, hd = host_env(m, d)
        stage = usd.export_usd(hm, hd, os.path.join(tmp, "manip.usda"))
        with open(stage) as f:
            text = f.read()
        prims = len(re.findall(r"def (?:Cube|Sphere|Cylinder|Capsule|Plane|"
                               r"Mesh) ", text))
        if prims != hm.ngeom:
            raise AssertionError(f"usd: {prims} geom prims for "
                                 f"{hm.ngeom} geoms")
        for b in range(1, hm.nbody):
            x = ", ".join(str(float(v)) for v in hd.xpos[b])
            if f"double3 xformOp:translate = ({x})" not in text:
                raise AssertionError(f"usd: body {b} not at env 0's pose")
        abox = owl.usd_to_abox(stage, os.path.join(tmp, "manip_ABox.owl"))
        with open(abox) as f:
            atext = f.read()
        missing = [b for b in hm.names.body[1:] if f"#{b}\"" not in atext]
        if missing:
            raise AssertionError(f"owl: bodies missing from the ABox: "
                                 f"{missing}")
    phase("cli_export", scene="manip_bin6.xml", steps=20,
          matplotlib=has_mpl,
          render=("CLI render, PNG checked" if has_mpl else
                  "not called: no matplotlib on this machine"),
          png_kb=png_kb if has_mpl else None,
          render_s=render_s if has_mpl else None,
          usd_geom_prims=prims, usd_bodies_at_env0_pose=hm.nbody - 1,
          abox_bytes=len(atext), card=card)


def main(argv):
    t_start = time.perf_counter()
    only = set(argv)
    want = lambda name: not only or name in only
    card = environment()
    _start_tracer()
    if want("build"):
        build()
    t_phase = time.perf_counter()

    def done(name):
        nonlocal t_phase
        phase(f"{name}_phase", seconds=time.perf_counter() - t_phase)
        t_phase = time.perf_counter()

    if want("kernels"):
        chol_err, chol_t = chol_vs_plain()
        fact_err, fact_t = chol_factor_vs_plain()
        fsat_err, fsat_t, fsat_launches = face_sat_vs_plain()
        rand_err = kernels_vs_plain()
        gl_err, gl_t = graph_loop_vs_plain()
        done("kernels")
    if want("box"):
        m, qpos, qvel, box_launches, d_rest = box_main_path(card)
        box_integrators(m, d_rest, card)
        box_cross_check(m, qpos, qvel)
        second_scene()
        done("box")
    if want("pile"):
        pile_counts = pile_main_path(card)
        done("pile")
    if want("manip"):
        mm_, counts, probe = manip_main_path(card)
        cap_err, t = manip_kernels(probe)
        manip_cross_check(mm_)
        done("manip")
    if want("precise"):
        mp_, pcounts, fact_step_t = precise_main_path(card)
        precise_cross_check(mp_)
        done("precise")
    if want("bighull"):
        mb_, bcounts, big_t = bighull_main_path(card)
        bighull_cross_check(mb_)
        done("bighull")
    if want("terrain"):
        mt_, tcounts, dt_end, tprobe = terrain_main_path(card)
        tdeep_counts, tdeep = terrain_deep_pass(mt_, dt_end)
        terr, tsolves, tdeep_t = terrain_kernels(tprobe, tdeep)
        del tprobe, tdeep
        terrain_cross_check(mt_, dt_end)
        done("terrain")
    if want("control"):
        control_main_path(card)
        done("control")
    if want("mobile"):
        mobile_main_path(card)
        done("mobile")
    if want("manip_scale"):
        scale = manip_scale_main_path(card)
        done("manip_scale")
    if want("runtime"):
        spawn_launches, spawn_held = spawn_main_path(card)
        rt_launches, cube_sat, cube_steps, rt_held = server_main_path(card)
        loop_main_path(card)
        done("runtime")
    if want("parallel"):
        par_launches, par_held = parallel_main_path(card)
        cli_export_path(card)
        done("parallel")
    phase("total", seconds=time.perf_counter() - t_start)
    if only:
        return
    src = "mujoco_sim_tpu_torch/csrc/"
    c42 = chol_t[(42, MANIP_NENV)]
    c66 = chol_t[(66, MANIP_NENV)]
    f66 = fact_t[(66, MANIP_NENV)]
    worst = {k: max(rand_err[k], cap_err[k], terr.get(k, 0.0))
             for k in rand_err}
    worst["hull_ref_face_depth"] = max(
        worst["hull_ref_face_depth"],
        rt_held["cube_pair"]["sat_max_abs_err"])
    mm, bm = t["mesh_mesh"], t["box_mesh"]
    kernels = [
        dict(name="chol_solve", route="cuda", source=src + "chol_solve.cu",
             replaces="mujoco_sim_tpu/ops/pallas_chol.py:40",
             launches=GRAPH_COUNTS["manip"]["chol_solve"],
             launches_eager=counts["chol_solve"], max_abs_err=chol_err,
             terrain_capture=tsolves,
             ms=c42["ms"], device_ms=c42["device_ms"],
             plain_ms=c42["plain_ms"],
             bound_ms=c42["bound_ms"], bound_by=c42["bound_by"],
             library_ms=c42["library_ms"], launches_box_path=box_launches,
             launches_terrain_path=tcounts["chol_solve"],
             launches_precise_path=pcounts["chol_solve"],
             launches_pile_path=pile_counts["chol_solve"],
             launches_spawn_path=spawn_launches,
             launches_runtime_path=rt_launches,
             launches_parallel_path=par_launches,
             parallel_capture=par_held["chol_solve_vs_f64"],
             spawn_capture=spawn_held["chol_solve_vs_f64"],
             runtime_capture={k: h["chol_solve_vs_f64"]
                              for k, h in rt_held.items()},
             n38_N1024=chol_t[(38, MANIP_NENV)],
             n66_N1024=c66, n128_N256=chol_t[(128, 256)]),
        dict(name="hull_ref_face_depth", route="cuda",
             source=src + "hull_sat.cu",
             replaces="mujoco_sim_tpu/ops/pallas_sat.py:40",
             launches=GRAPH_COUNTS["manip"]["hull_ref_face_depth"],
             launches_eager=counts["hull_ref_face_depth"],
             launches_precise_path=pcounts["hull_ref_face_depth"],
             launches_terrain_path=tcounts["hull_ref_face_depth"],
             launches_runtime_cube_pair=cube_sat,
             runtime_cube_pair_max_abs_err=rt_held["cube_pair"][
                 "sat_max_abs_err"],
             runtime_cube_pair_steps=cube_steps,
             max_abs_err=worst["hull_ref_face_depth"],
             ms=mm["ms"], device_ms=mm["device_ms"], plain_ms=mm["plain_ms"],
             bound_ms=mm["bound_ms"], bound_by=mm["bound_by"],
             library_ms=None,
             box_mesh=dict(N=bm["N"], ms=bm["ms"],
                           device_ms=bm["device_ms"],
                           plain_ms=bm["plain_ms"],
                           bound_ms=bm["bound_ms"],
                           bound_by=bm["bound_by"])),
        dict(name="mtv_query", route="cuda", source=src + "mtv_query.cu",
             replaces="mujoco_sim_tpu/ops/pallas_refine.py:73",
             launches=GRAPH_COUNTS["manip"]["mtv_query"],
             launches_eager=counts["mtv_query"],
             launches_precise_path=pcounts["mtv_query"],
             launches_terrain_path=tcounts["mtv_query"],
             launches_terrain_deep_pass=tdeep_counts["mtv_query"],
             terrain_deep=tdeep_t,
             max_abs_err=worst["mtv_query"],
             launches_bighull_path=bcounts["mtv_query"],
             ms=t["mtv_query"]["ms"], device_ms=t["mtv_query"]["device_ms"],
             plain_ms=t["mtv_query"]["plain_ms"],
             bound_ms=t["mtv_query"]["bound_ms"],
             bound_by=t["mtv_query"]["bound_by"], library_ms=None,
             bighull=big_t),
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
             device_ms=t["support_minmax_C256"]["device_ms"],
             device_ms_by_width={
                 k[len("support_minmax_"):]: v["device_ms"]
                 for k, v in t.items() if k.startswith("support_minmax_C")},
             plain_ms=t["support_minmax_C256"]["plain_ms"],
             bound_ms=t["support_minmax_C256"]["bound_ms"],
             bound_by=t["support_minmax_C256"]["bound_by"],
             library_ms=None),
        # launched once per step of the precise path (qLD for noslip);
        # timed on the mass matrices of that rollout's final state
        dict(name="chol_factor", route="cuda", source=src + "chol_factor.cu",
             replaces="benchmarks/pallas_chol_proto.py:24",
             launches=GRAPH_COUNTS["precise"]["chol_factor"],
             launches_eager=pcounts["chol_factor"], max_abs_err=fact_err,
             ms=fact_step_t["ms"], device_ms=fact_step_t["device_ms"],
             plain_ms=fact_step_t["plain_ms"],
             bound_ms=fact_step_t["bound_ms"],
             bound_by=fact_step_t["bound_by"],
             library_ms=fact_step_t["library_ms"],
             ms_random_n42_N1024=fact_t[(42, MANIP_NENV)]["ms"],
             n66_N1024=f66, n128_N256=fact_t[(128, 256)]),
        # no step calls it: its path is its own entry point
        # (scripts/torch_sat_proto.py), driven in face_sat_vs_plain with
        # the count set to 0 just before and read just after
        dict(name="face_sat_depth", route="cuda", source=src + "face_sat.cu",
             replaces="benchmarks/pallas_sat_proto.py:28",
             launches=fsat_launches,
             launches_precise_step=pcounts["face_sat_depth"],
             max_abs_err=fsat_err, ms=fsat_t["ms"],
             device_ms=fsat_t["device_ms"],
             plain_ms=fsat_t["plain_ms"], bound_ms=fsat_t["bound_ms"],
             bound_by=fsat_t["bound_by"], library_ms=None),
        # the predicate of every captured while loop (two launches a
        # WHILE node: before it and at the end of its body); counted over
        # the box path's graph rollout (its captures), and per path
        dict(name="graph_loop", route="cuda", source=src + "graph_loop.cu",
             replaces="mujoco_sim_tpu/ops/solver.py:373",
             launches=GRAPH_COUNTS["manip"]["graph_loop"],
             max_abs_err=gl_err,
             launches_by_path={k: v["graph_loop"]
                               for k, v in GRAPH_COUNTS.items()},
             ms=gl_t["ms"], device_ms=gl_t["device_ms"],
             plain_ms=gl_t["plain_ms"], bound_ms=gl_t["bound_ms"],
             bound_by=gl_t["bound_by"], library_ms=gl_t["library_ms"]),
    ]
    # by path: the wrappers' counts over each graph main path (its warm-up
    # call and its capture; ``launches`` is the manip path's, or the
    # kernel's own path's), and the launches a replayed step makes,
    # counted on the card (hold_replay_counts); at scale, each kernel's device
    # ms a replayed step beside its bound
    for k in kernels:
        name = k["name"]
        k["launches_capture"] = {p: c[name] for p, c in GRAPH_COUNTS.items()}
        k["launches_per_replay_step"] = {p: c[name]
                                         for p, c in REPLAY_COUNTS.items()}
        if name in scale[MANIP_SCALE[0][0]]:
            k["scale"] = {str(n): r[name] for n, r in scale.items()}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
