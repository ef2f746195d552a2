"""Spreads and bounds from two sets of runs of the same seeds:

    python3 bench_port/tools/spreads.py <runs.jsonl>...

Each line of a file is {"set": "A" | "B", "seed": n, "result": <the
run's last line>}.  For each cell and end-to-end metric: each set's
median and spread (quartile distance over the median, with
``statistics.quantiles``), and five times the wider spread, the bound
it suggests (not under 1%).  A set's first run of ``setup_s`` is left
out where it is a checkout's first run (it compiles); pass
--first-compiles to say so.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from harness import stats  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("files", nargs="+")
    ap.add_argument("--first-compiles", action="store_true")
    args = ap.parse_args(argv)
    for path in args.files:
        rows = [json.loads(ln) for ln in open(path) if ln.strip()]
        sets = {}
        for r in rows:
            if r["set"] in ("A", "B") and r["result"]:
                sets.setdefault(r["set"], []).append(r["result"])
        names = list(sets["A"][0]["metrics"])
        for name in names:
            out, widest = [], 0.0
            for s, res in sorted(sets.items()):
                v = [x["metrics"][name]["value"] for x in res]
                if name == "setup_s" and args.first_compiles and s == "A":
                    v = v[1:]
                sp = stats.spread(v)
                widest = max(widest, sp)
                out.append(f"{s}: median {statistics.median(v):.6g} "
                           f"spread {100 * sp:.3f}%")
            print(f"{os.path.basename(path)} {name}: {'; '.join(out)}; "
                  f"5 x widest {max(0.01, 5 * widest):.4f}")


if __name__ == "__main__":
    main()
