"""Summed pytest durations of the port's CPU test files, file by file.

    python3 scripts/torch_test_durations.py [checkout] [workers]

Runs the checkout's tests/test_torch_*.py (default: this checkout) as the
tier-1 command runs the tests: JAX on the CPU, ``-m 'not slow'``, six
pytest-xdist workers (or ``workers``) with ``--dist loadfile``, plus
``--durations=0``.  Prints one JSON object: the wall seconds, the pass and
failure counts, the summed seconds of every test phase (setup, call,
teardown) by file, and their total.  Under ``--dist loadfile`` a worker
runs whole files, so the summed seconds are the work, the wall seconds
what the longest files leave.  To compare two commits, run it for each
checkout one after the other on one machine, each from a fresh checkout
(the JAX compile cache starts cold, as in a new clone).

Needs jax (the parity tests import it), pytest and pytest-xdist; no card.
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LINE = re.compile(r"\s*([\d.]+)s (call|setup|teardown)\s+(tests/[^:\s]+)::")
_SUMMARY = re.compile(r"(\d+) (passed|failed|skipped|errors?)")


def main(argv):
    checkout = os.path.abspath(argv[0]) if argv else ROOT
    workers = argv[1] if len(argv) > 1 else "6"
    files = sorted(f"tests/{f}" for f in os.listdir(
        os.path.join(checkout, "tests"))
        if f.startswith("test_torch_") and f.endswith(".py"))
    cmd = [sys.executable, "-m", "pytest", *files, "-q", "-m", "not slow",
           "-p", "no:cacheprovider", "-p", "xdist", "-n", workers,
           "--dist", "loadfile", "-p", "no:randomly", "--durations=0"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=checkout, env=env, capture_output=True,
                         text=True).stdout
    wall = time.perf_counter() - t0
    by_file = collections.Counter()
    for line in out.splitlines():
        m = _LINE.match(line)
        if m:
            by_file[m.group(3)] += float(m.group(1))
    last = [ln for ln in out.splitlines() if ln.strip()][-1]
    counts = {k: int(n) for n, k in _SUMMARY.findall(last)}
    print(json.dumps({
        "checkout": checkout, "workers": int(workers), "wall_s": wall,
        "counts": counts, "summed_s": sum(by_file.values()),
        "by_file_s": dict(by_file.most_common())}))


if __name__ == "__main__":
    main(sys.argv[1:])
