"""Times of the hand-written kernels of whichever checkout of
mujoco_sim_tpu_torch is on PYTHONPATH, on one NVIDIA GPU.

To compare two commits on one card, unpack the other commit beside this one
(``git archive <commit> | tar -x -C _chipcheck/parent``) and run this same
script against each in turn on the same card, the other commit first and
last:

    for p in _chipcheck/parent . . _chipcheck/parent; do
        PYTHONPATH=$p python3 scripts/torch_kernel_bench.py; done

It imports the package through its public wrappers only (the
``*_cuda`` functions of ``ops/chol.py``, ``chol_factor.py``,
``mtv_query.py``, ``hull_sat.py``, ``face_sat.py`` and
``support_minmax.py``), so it runs unchanged against any commit that has
them.  A shape a commit's wrapper refuses (``chol_solve`` at n > 64 before
the large-n path existed, ``mtv_query`` on tables over 47 KB before it
took any size) is reported as ``{"refused": <message>}``.  It
prints one JSON object; per kernel and shape it holds

* ``event_ms``: median of 20 single launches between CUDA events (the
  figure chip_smoke.py prints; it includes the wrapper's host time when
  that exceeds the kernel's),
* ``graph_ms``: one launch's share of a replayed CUDA graph of 50 launches
  (device time with no host in the way),
* ``profiler_ms``: the kernel's mean device time in a torch.profiler trace
  of 50 launches (null when the trace shows no device time),
* ``host_us``: wall time per call over 1000 unsynchronised wrapper calls,
* ``library_ms`` for chol_solve: torch.linalg.cholesky + cholesky_solve;
  for chol_factor: torch.linalg.cholesky,
* ``bound_ms`` (and ``bound_by``): the larger of the bytes the call must
  move over 3.35 TB/s and its flops over 67 TFLOP/s f32 (H100 SXM peaks).

Shapes: chol_solve at (1024, 42), (4096, 42) and (4096, 6), the manip and
box scenes' systems, at (1024, 66) and (256, 128), systems above the
register-resident size classes, and at (8192, 42) and (65 536, 42), the
manip scene at scale; chol_factor at (1024, 42), (1024, 66), (256, 128),
(8192, 42) and (65 536, 42); mtv_query at N = 8192, V = 24, E = 56,
F = 34, K = 16, 2 rounds, the manip step's query, at V = 256, E = 762,
F = 508 (random hull pairs), and at the tables of
tests/fixtures/manip_bin6_bighull.xml (V = 320, E = 954, F = 636: its two
pebbles posed in deep interpenetration in every lane, then in 7 lanes of
the 8192, the rest empty slots: the bighull step's pattern);
hull_ref_face_depth at the manip step's two calls
(mesh-mesh: N = 43 008, V = 24, F = 44, K = 2, lateral filter, slack per
instance, masked padding vertices; box-mesh: N = 28 672, V = 8, F = 44,
K = 2, no mask, scalar slack); face_sat_depth at N = 8192, V = 32, F = 60,
K = 2; support_minmax at N = 8192, V = 24 and 256, C = 68 and 256.  Inputs
are seeded random hull pairs.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the live lanes of the bighull step's pattern: a few deep pairs spread
# over the compaction's 8192 slots, the rest empty
FEW_LIVE = (0, 17, 1000, 4095, 5001, 7777, 8191)


def _event_ms(fn, reps=20):
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


def _graph_ms(fn, launches=50, reps=10):
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
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def _profiler_ms(fn, needle, launches=50):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in p.key_averages():
        if needle in ev.key:
            dev = getattr(ev, "device_time_total", None)
            if dev is None:
                dev = getattr(ev, "cuda_time_total", 0.0)
            total_us += dev
            count += ev.count
    return total_us / count / 1e3 if count and total_us > 0 else None


def _host_us(fn, calls=1000):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def _measure(fn, needle):
    return dict(event_ms=_event_ms(fn), graph_ms=_graph_ms(fn),
                profiler_ms=_profiler_ms(fn, needle), host_us=_host_us(fn))


def _bound(nbytes, flops):
    tb, tf = nbytes / 3.35e12 * 1e3, flops / 67e12 * 1e3
    return dict(bound_ms=max(tb, tf),
                bound_by="bytes" if tb >= tf else "operations")


def _measure_or_refused(fn, needle):
    """_measure, or {"refused": message} where the wrapper raises
    ValueError for the shape (a limit of the commit under test)."""
    try:
        fn()
    except ValueError as exc:
        return dict(refused=str(exc))
    return _measure(fn, needle)


def _spd(rng, N, n):
    A = rng.standard_normal((N, n, n))
    return A @ A.transpose(0, 2, 1) + n * np.eye(n)


def _hull_pairs(rng, N, V, E, F):
    """Seeded random hull pairs: the generator of tests/test_pallas_refine.py,
    vectorised; masked edges and faces, no cylinder lanes."""
    def hull():
        pts = rng.normal(size=(N, V, 3)) * 0.3
        R = np.linalg.qr(rng.normal(size=(N, 3, 3)))[0]
        R[:, :, 0] *= np.sign(np.linalg.det(R))[:, None]
        p = rng.normal(size=(N, 3)) * 0.1
        w = p[:, None] + pts @ R.transpose(0, 2, 1)
        he = rng.normal(size=(N, E, 2, 3)) * 0.3
        hm = (rng.uniform(size=(N, E)) > 0.2).astype(np.float64)
        nf = rng.normal(size=(N, F, 3))
        nf /= np.linalg.norm(nf, axis=-1, keepdims=True)
        fm = (rng.uniform(size=(N, F)) > 0.15).astype(np.float64)
        fm[:, 0] = 1.0
        return w, he, hm, nf, fm, R, p, np.zeros((N, 3))
    A, B = hull(), hull()
    out = []
    for a, b in zip(A, B):
        out += [torch.tensor(a, dtype=torch.float32, device="cuda"),
                torch.tensor(b, dtype=torch.float32, device="cuda")]
    return out


def _sat_pairs(rng, N, V, F, box=False, vmin=None):
    """Seeded inputs of the face-SAT queries, built like _hull_pairs' hulls:
    points of one hull (random points * 0.3, or the 8 corners of a box of
    half-extents U(0.03, 0.12) when ``box``), rotated and moved by U(0.1),
    against the face planes of another (unit normals, offsets that make
    each plane a support plane of that hull's own random points).  With
    ``vmin`` an instance has U(vmin, V) real points, the rest padding at
    1e6 as in the compiled hull tables (mask 0), and its last faces padded
    as the tables pad them (normal 0, offset 1e9).  Returns float32 CUDA
    tensors (pts (N, V, 3), planes (N, F, 4), mask (N, V), slack (N,))."""
    if box:
        corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                            for sz in (-1, 1)], dtype=np.float64)
        pts = corners[None] * rng.uniform(0.03, 0.12, (N, 1, 3))
    else:
        pts = rng.normal(size=(N, V, 3)) * 0.3
    R = np.linalg.qr(rng.normal(size=(N, 3, 3)))[0]
    pts = rng.normal(size=(N, 1, 3)) * 0.1 + pts @ R.transpose(0, 2, 1)
    own = rng.normal(size=(N, 24, 3)) * 0.3
    nf = rng.normal(size=(N, F, 3))
    nf /= np.linalg.norm(nf, axis=-1, keepdims=True)
    d = np.einsum("nfc,nvc->nfv", nf, own).max(-1)
    planes = np.concatenate([nf, d[..., None]], axis=-1)
    mask = np.ones((N, V))
    if vmin is not None:
        nreal = rng.integers(vmin, V + 1, N)
        pad = np.arange(V)[None] >= nreal[:, None]
        mask[pad] = 0.0
        pts[pad] = 1e6
        fpad = np.arange(F)[None] >= F - rng.integers(0, 5, N)[:, None]
        planes[fpad] = [0.0, 0.0, 0.0, 1e9]
    rb = np.sqrt(np.where(mask > 0.5, (pts ** 2).sum(-1), 0.0).max(-1))
    return tuple(torch.tensor(x, dtype=torch.float32, device="cuda")
                 for x in (pts, planes, mask, 0.15 * rb))


def _fixture_pairs(rng, N):
    """The two pebbles of manip_bin6_bighull.xml (hulls 4 and 5 of its
    full-hull tables, compiled by the package under test), posed as the
    deep-pair compaction hands a live slot to the query: random
    orientations, centres 0.3-1.2 of the smaller c semi-axis apart."""
    import mujoco_sim_tpu_torch as mst
    m = mst.load_model(os.path.join(ROOT, "tests", "fixtures",
                                    "manip_bin6_bighull.xml"))
    each = lambda x: np.broadcast_to(x, (N,) + x.shape)
    out = {}
    for side, hid, sgn in (("A", 4, 0.5), ("B", 5, -0.5)):
        R = np.linalg.qr(rng.normal(size=(N, 3, 3)))[0]
        R[:, :, 0] *= np.sign(np.linalg.det(R))[:, None]
        d = rng.normal(size=(N, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        p = sgn * d * rng.uniform(0.3, 1.2, (N, 1)) * 0.024
        fpl = np.asarray(m.mesh_fplane)[hid]
        tabs = dict(
            w=p[:, None] + np.asarray(m.mesh_vert_hi)[hid] @ R.transpose(
                0, 2, 1),
            he=each(np.asarray(m.mesh_hedge)[hid]),
            hm=each(np.asarray(m.mesh_hedge_mask)[hid]),
            nf=fpl[:, :3] @ R.transpose(0, 2, 1),
            fm=each(np.asarray(m.mesh_fmask)[hid]), R=R, p=p,
            cyl=np.zeros((N, 3)))
        for k, v in tabs.items():
            out[k + side] = torch.tensor(np.ascontiguousarray(v),
                                         dtype=torch.float32, device="cuda")
    order = ("wA", "wB", "heA", "heB", "hmA", "hmB", "nfA", "nfB", "fmA",
             "fmB", "RA", "RB", "pA", "pB", "cylA", "cylB")
    return [out[k] for k in order]


def _mtv_work(N, live, improved, V, E, F, K):
    """(bytes, flops) of mtv_query over N lanes: ``live`` lanes read every
    table once and scan 2F face axes against 2V vertices, and K^2 cross
    axes and 2E edge scores in round 1 and, on the ``improved`` lanes, in
    round 2; an empty slot shows itself by both hulls' face masks, A's
    edge masks (all zero, so B's are never read) and A's first face
    normal; every lane writes its result (chip_smoke.py's count)."""
    nbytes = (4 * live * (6 * V + 14 * E + 8 * F + 30)
              + 4 * (N - live) * (2 * F + E + 3) + 16 * N)
    flops = live * 2 * F * 2 * V * 5 + (live + improved) * (
        K * K * 2 * V * 5 + 2 * E * 12)
    return nbytes, flops


def _mtv_entry(mtv_query, args, live=None):
    """Time mtv_query on args, or {"refused": ...}; with the lanes round 1
    improved, and the bound of the ``live`` lanes (all when None), the
    rest read as empty slots (_mtv_work)."""
    m = _measure_or_refused(lambda: mtv_query.mtv_query_cuda(*args),
                            "mtv_query_kernel")
    if "refused" in m:
        return m
    d0 = mtv_query.mtv_query_cuda(*args, rounds=0)[0]
    d1 = mtv_query.mtv_query_cuda(*args, rounds=1)[0]
    m["improved_by_round_1"] = int((d1 < d0).sum())
    N, V = args[0].shape[0], args[0].shape[1]
    E, F, K = args[2].shape[1], args[6].shape[1], 16
    live = N if live is None else live
    m.update(_bound(*_mtv_work(N, live, m["improved_by_round_1"], V, E, F,
                               K)))
    return m


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_bench: no CUDA device")
    import mujoco_sim_tpu_torch
    from mujoco_sim_tpu_torch.ops import (chol, chol_factor, cuda_build,
                                          face_sat, hull_sat, mtv_query,
                                          support_minmax)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    cuda_build.build_all()
    out = dict(package=os.path.dirname(os.path.dirname(
        os.path.abspath(mujoco_sim_tpu_torch.__file__))), card=card,
        build_s=time.perf_counter() - t0, chol_solve={}, chol_factor={},
        mtv_query={}, hull_ref_face_depth={}, face_sat_depth={},
        support_minmax={})
    rng = np.random.default_rng(0)
    for N, n in ((1024, 42), (4096, 42), (4096, 6), (1024, 66), (256, 128),
                 (8192, 42), (65536, 42)):
        A = torch.tensor(_spd(rng, N, n), dtype=torch.float32, device="cuda")
        b = torch.randn(N, n, device="cuda")
        m = _measure_or_refused(lambda: chol.chol_solve_cuda(A, b),
                                "chol_solve_kernel")
        m["library_ms"] = _event_ms(lambda: torch.cholesky_solve(
            b[..., None], torch.linalg.cholesky(A)))
        m.update(_bound(N * (n * n + 2 * n) * 4,
                        N * (n ** 3 / 3 + 2 * n * n)))
        out["chol_solve"][f"N{N}_n{n}"] = m
    for N, n in ((1024, 42), (1024, 66), (256, 128), (8192, 42),
                 (65536, 42)):
        A = torch.tensor(_spd(rng, N, n), dtype=torch.float32, device="cuda")
        m = _measure_or_refused(lambda: chol_factor.chol_factor_cuda(A),
                                "chol_factor_kernel")
        m["library_ms"] = _event_ms(lambda: torch.linalg.cholesky(A))
        m.update(_bound(N * 2 * n * n * 4, N * n ** 3 / 3))
        out["chol_factor"][f"N{N}_n{n}"] = m
    args = _hull_pairs(rng, 8192, 24, 56, 34)
    m = _measure(lambda: mtv_query.mtv_query_cuda(*args), "mtv_query_kernel")
    # instances whose first round found a better axis than the face normals:
    # only those have anything left to find in the second
    d0 = mtv_query.mtv_query_cuda(*args, rounds=0)[0]
    d1 = mtv_query.mtv_query_cuda(*args, rounds=1)[0]
    m["improved_by_round_1"] = int((d1 < d0).sum())
    out["mtv_query"]["N8192_V24_E56_F34_K16_r2"] = m
    # tables over the 47 KB line: random hull pairs, the fixture's pebbles
    big = _hull_pairs(rng, 8192, 256, 762, 508)
    out["mtv_query"]["N8192_V256_E762_F508_K16_r2"] = _mtv_entry(mtv_query,
                                                                 big)
    del big
    pebbles = _fixture_pairs(rng, 8192)
    out["mtv_query"]["N8192_bighull_V320_E954_F636_K16_r2"] = _mtv_entry(
        mtv_query, pebbles)
    # the bighull step's pattern: a few live lanes among the deep-pair
    # compaction's empty slots (every table zero)
    dead = torch.ones(8192, dtype=torch.bool, device="cuda")
    dead[list(FEW_LIVE)] = False
    for a in pebbles:
        a[dead] = 0.0
    out["mtv_query"]["N8192_bighull_7_live"] = _mtv_entry(
        mtv_query, pebbles, live=len(FEW_LIVE))
    del pebbles
    # the manip step's two hull_ref_face_depth calls
    for name, N, V, box in (("mesh_mesh", 43008, 24, False),
                            ("box_mesh", 28672, 8, True)):
        F, K = 44, 2
        pts, planes, mask, slack = _sat_pairs(rng, N, V, F, box=box,
                                              vmin=None if box else 16)
        if box:
            call = lambda: hull_sat.hull_ref_face_depth_cuda(pts, planes, K)
        else:
            call = lambda: hull_sat.hull_ref_face_depth_cuda(
                pts, planes, K, mask, True, slack)
        m = _measure(call, "hull_sat_kernel")
        # bytes: points, planes, and the mask and slack where given
        m.update(_bound(4 * N * (3 * V + 4 * F + (0 if box else V + 1))
                        + N * (12 * K + 16),
                        N * (6 * V * F * (1 if box else 2) + 6 * V)))
        out["hull_ref_face_depth"][f"{name}_N{N}_V{V}_F{F}_K{K}"] = m
    N, V, F, K = 8192, 32, 60, 2
    pts, planes, mask, _ = _sat_pairs(rng, N, V, F, vmin=20)
    m = _measure(lambda: face_sat.face_sat_depth_cuda(pts, planes, mask, K),
                 "face_sat_kernel")
    m.update(_bound(N * (4 * (4 * V + 4 * F) + 8 * K + 20),
                    N * (6 * V * F + 6 * V)))
    out["face_sat_depth"][f"N{N}_V{V}_F{F}_K{K}"] = m
    N = args[0].shape[0]
    for V in (24, 256):
        w = args[0] if V == 24 else torch.tensor(
            rng.normal(size=(N, V, 3)) * 0.3, dtype=torch.float32,
            device="cuda")
        for C in (68, 256):
            axes = torch.tensor(rng.normal(size=(N, C, 3)),
                                dtype=torch.float32, device="cuda")
            m = _measure(lambda: support_minmax.support_minmax_cuda(axes, w),
                         "support_minmax_kernel")
            m.update(_bound(4 * N * (5 * C + 3 * V), N * C * V * 5))
            out["support_minmax"][f"N{N}_C{C}_V{V}"] = m
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
