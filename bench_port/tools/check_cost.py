"""What the checks cost the window: the same cell, seed and window
length with its steps checked and with none (no call cut for a check, no
state kept), alternated in one process on the card:

    python3 bench_port/tools/check_cost.py --workload <cell> --seed <n> \
        --seconds <s> --pairs <n>

Prints a JSON line a window: {"checked": bool, "env_steps_per_s": ...}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args(argv)
    run._cache_dirs()
    import torch
    from harness import spec, stats, window
    cell = spec.load(args.workload)
    dev = torch.device("cuda")
    c = run.Cell(cell, dev)
    c.warm(args.seed)
    for i in range(args.pairs):
        order = (True, False) if i % 2 == 0 else (False, True)
        for checked in order:
            plan = window.Plan.make(cell.traffic, c.nenv, args.seed)
            rows = torch.as_tensor(plan.rows, device=dev)
            w = window.run(c.entry, c.law, plan, c.carry0, c.fill,
                           args.seconds, c.nenv, rows, dev, checked=checked)
            print(json.dumps({"workload": args.workload, "pair": i,
                              "checked": checked, "calls_checked":
                              len(w.checks), "env_steps_per_s":
                              stats.rate(w.steps, w.seconds)}), flush=True)


if __name__ == "__main__":
    main()
