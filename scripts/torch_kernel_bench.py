"""Times of the chol_solve and mtv_query kernels of whichever checkout of
mujoco_sim_tpu_torch is on PYTHONPATH, on one NVIDIA GPU.

To compare two commits on one card, unpack the other commit beside this one
(``git archive <commit> | tar -x -C _chipcheck/parent``) and run this same
script against each in turn on the same card, the other commit first and
last:

    for p in _chipcheck/parent . . _chipcheck/parent; do
        PYTHONPATH=$p python3 scripts/torch_kernel_bench.py; done

It imports the package through its public wrappers only
(``chol.chol_solve_cuda``, ``mtv_query.mtv_query_cuda``), so it runs
unchanged against any commit that has them.  Per kernel and shape it prints
one JSON object with

* ``event_ms``: median of 20 single launches between CUDA events (the
  figure chip_smoke.py prints; it includes the wrapper's host time when
  that exceeds the kernel's),
* ``graph_ms``: one launch's share of a replayed CUDA graph of 50 launches
  (device time with no host in the way),
* ``profiler_ms``: the kernel's mean device time in a torch.profiler trace
  of 50 launches (null when the trace shows no device time),
* ``host_us``: wall time per call over 1000 unsynchronised wrapper calls,
* ``library_ms`` for chol_solve: torch.linalg.cholesky + cholesky_solve.

Shapes: chol_solve at (1024, 42), (4096, 42) and (4096, 6), the manip and
box scenes' systems; mtv_query at N = 8192, V = 24, E = 56, F = 34, K = 16,
2 rounds, the manip step's query, on seeded random hull pairs.
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


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_bench: no CUDA device")
    import mujoco_sim_tpu_torch
    from mujoco_sim_tpu_torch.ops import chol, cuda_build, mtv_query
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    cuda_build.build_all()
    out = dict(package=os.path.dirname(os.path.dirname(
        os.path.abspath(mujoco_sim_tpu_torch.__file__))), card=card,
        build_s=time.perf_counter() - t0, chol_solve={}, mtv_query={})
    rng = np.random.default_rng(0)
    for N, n in ((1024, 42), (4096, 42), (4096, 6)):
        A = torch.tensor(_spd(rng, N, n), dtype=torch.float32, device="cuda")
        b = torch.randn(N, n, device="cuda")
        m = _measure(lambda: chol.chol_solve_cuda(A, b), "chol_solve_kernel")
        m["library_ms"] = _event_ms(lambda: torch.cholesky_solve(
            b[..., None], torch.linalg.cholesky(A)))
        out["chol_solve"][f"N{N}_n{n}"] = m
    args = _hull_pairs(rng, 8192, 24, 56, 34)
    m = _measure(lambda: mtv_query.mtv_query_cuda(*args), "mtv_query_kernel")
    # instances whose first round found a better axis than the face normals:
    # only those have anything left to find in the second
    d0 = mtv_query.mtv_query_cuda(*args, rounds=0)[0]
    d1 = mtv_query.mtv_query_cuda(*args, rounds=1)[0]
    m["improved_by_round_1"] = int((d1 < d0).sum())
    out["mtv_query"]["N8192_V24_E56_F34_K16_r2"] = m
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
