"""A sharded cell's rate at other shard counts, for its scaling
efficiency: the cell's own entry, law, traffic and window, with
``law_params["shards"]`` set to each count given and the batch to that
many shards of the configuration's ``envs_per_shard`` (shard i on card
i), one window a count, in one process:

    python3 bench_port/tools/shard_scaling.py --workload <cell> \
        --seed <n> --seconds <s> --shards 1 4

Refuses (exit 3) with fewer CUDA devices than the largest count, so no
rate comes from shards wrapped onto one card.  Prints a JSON line a
count: {"shards", "nenv", "env_steps_per_s", "per_shard", "devices",
"kind", "memory_peak_bytes" (each card's peak reserved memory),
"issue_ms"}.  ``issue_ms`` is the host's time in the sharded rollout's
call (``parallel/mesh.make_sharded_rollout``'s callable, from its start
to its return: every shard issued, no card waited on), mean over the
window's calls of ``chunk_steps`` steps, with the program's tracing off:
the untraced counterpart of the ``shard_issue_ms`` metric.  The check
does not run; a run of the cell itself (run.py) decides ``correct``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import run  # noqa: E402


def timed(fn, n_of, out: list):
    """``fn`` with the host seconds of each call appended to ``out`` as
    (steps, seconds); ``n_of(args)`` gives a call's steps."""
    def wrapped(*args):
        t0 = time.perf_counter()
        r = fn(*args)
        out.append((n_of(args), time.perf_counter() - t0))
        return r
    return wrapped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--shards", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    run._cache_dirs()
    import torch
    from harness import spec, stats
    from mujoco_sim_tpu_torch.utils import graph
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < max(args.shards):
        print(f"shard_scaling: {max(args.shards)} shards need as many "
              f"CUDA devices, found {n}", file=sys.stderr)
        return 3
    base = spec.load(args.workload)
    dev = torch.device("cuda", 0)
    per = int(base.config["envs_per_shard"])
    chunk = int(base.traffic["chunk_steps"])
    for k in args.shards:
        cell = copy.deepcopy(base)
        cell.traffic["law_params"]["shards"] = k
        c = run.Cell(cell, dev, per * k)
        c.warm(args.seed)
        issued = []
        c.entry.run = timed(c.entry.run, lambda a: a[2], issued)
        w = c.window(args.seed, args.seconds)
        rate = stats.rate(w.steps, w.seconds)
        cards = list(dict.fromkeys(c.entry.mesh.local_devices))
        peak = [torch.cuda.max_memory_reserved(d) for d in cards]
        issue = [s for steps, s in issued if steps == chunk]
        print(json.dumps({
            "workload": args.workload, "shards": k, "nenv": c.nenv,
            "env_steps_per_s": rate, "per_shard": rate / k,
            "devices": [str(d) for d in c.entry.mesh.local_devices],
            "kind": torch.cuda.get_device_name(dev), "seconds": w.seconds,
            "memory_peak_bytes": peak,
            "issue_ms": 1e3 * statistics.fmean(issue) if issue else None,
            "issue_calls": len(issue)}), flush=True)
        del c, w
        graph.clear_all()
        for d in cards:
            with torch.cuda.device(d):
                torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(d)
    return 0


if __name__ == "__main__":
    sys.exit(main())
