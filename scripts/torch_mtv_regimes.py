"""The two layouts of the mtv_query kernel at the manip step's table sizes,
on one NVIDIA GPU.

    PYTHONPATH=. python3 scripts/torch_mtv_regimes.py

csrc/mtv_query.cu stages every table of an instance in shared memory when
they fit the 47 KB a block gets without an opt-in (the staged layout, with
the edge ranking), and otherwise reads the edge and face tables from device
memory (Big, with K warp-wide minima for the edges).  This script builds a
copy of the source whose launcher always picks Big and times it beside the
shipped kernel on the same inputs at the manip step's tables (V = 24,
E = 56, F = 34, K = 16, 2 rounds): every lane live at N = 8192 and 1024,
and 15% of 8192 lanes live, the rest empty deep slots.  It checks that the
two return the same bits and prints one JSON object of device times (a
launch's share of a replayed CUDA graph of 50).  Imports no jax.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch_kernel_bench as bench  # noqa: E402
from mujoco_sim_tpu_torch.ops import cuda_build, mtv_query  # noqa: E402

CASES = (("all_live_N8192", 8192, 1.0), ("15pct_live_N8192", 8192, 0.15),
         ("all_live_N1024", 1024, 1.0))
V, E, F = 24, 56, 34
_ALWAYS_BIG = (("const bool big = warp_floats(V, E, F, K) * sizeof(float) "
                "> kSmemBudget;", "const bool big = true;"),)


def _runner(cfn, args):
    """A call of the C entry cfn on args, and its output tensors."""
    N = args[0].shape[0]
    depth = torch.empty(N, device="cuda")
    n = torch.empty(N, 3, device="cuda")
    ptrs = [t.data_ptr() for t in args]

    def run():
        rc = cuda_build.launch(args[0].device, cfn, *ptrs, depth.data_ptr(),
                               n.data_ptr(), N, V, E, F, mtv_query.K_EDGE,
                               mtv_query.REFINE_ROUNDS)
        if rc != 0:
            raise RuntimeError(f"mtv_query launch failed: cudaError {rc}")
    return run, depth, n


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_mtv_regimes: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    shipped = mtv_query._load().mtv_query_f32
    big = cuda_build.build_variant("mtv_query", "always_big",
                                   _ALWAYS_BIG).mtv_query_f32
    big.restype = ctypes.c_int
    big.argtypes = shipped.argtypes
    out = dict(card=card, tables=dict(V=V, E=E, F=F, K=mtv_query.K_EDGE,
                                      rounds=mtv_query.REFINE_ROUNDS))
    for name, N, live in CASES:
        rng = np.random.default_rng(0)
        args = bench._hull_pairs(rng, N, V, E, F)
        if live < 1.0:
            dead = torch.tensor(rng.uniform(size=N) > live, device="cuda")
            for a in args:
                a[dead] = 0.0
        got = {}
        for kind, cfn in (("staged", shipped), ("big", big)):
            run, depth, n = _runner(cfn, args)
            run()
            torch.cuda.synchronize()
            got[kind] = (depth.clone(), n.clone(), bench._graph_ms(run))
        same = all(torch.equal(a, b) for a, b in zip(got["staged"][:2],
                                                     got["big"][:2]))
        if not same:
            raise AssertionError(f"{name}: the two layouts differ")
        out[name] = dict(live_lanes=int(torch.isfinite(got["staged"][0])
                                        .sum()),
                         staged_ms=got["staged"][2], big_ms=got["big"][2],
                         big_over_staged=got["big"][2] / got["staged"][2],
                         same_bits=same)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
