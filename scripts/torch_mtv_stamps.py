"""Where the time of mtv_query's block layout (the large tables) goes, on
one NVIDIA GPU.

    PYTHONPATH=. python3 scripts/torch_mtv_stamps.py

At the bighull step's pattern (the two pebbles of
tests/fixtures/manip_bin6_bighull.xml posed in deep interpenetration in 7
lanes of 8192, the rest empty slots: the kernel bench's
``N8192_bighull_7_live``) and with every lane live, it builds a stamped
copy of csrc/mtv_query.cu at run time from the checkout's source into the
build directory (thread 0 of a block reads the globaltimer when the block
starts and when its last turn's empty-slot checks start and end, and for
each live instance it solves: at its start, when its
tables have landed, after the coarse pass, and after each round's edge
selection and cross-axis pass; and clock64 at its start and end, for the
SM clock), checks its result against the shipped
kernel bit for bit, and prints one JSON object with, per case, the device
time of the shipped kernel (a launch's share of a replayed CUDA graph of
50) and percentiles over the live instances of each phase's microseconds
and of when they started and ended (microseconds after the first block
started).

The shipped kernel carries no stamps; the copy differs from it only in
the stamp writes.  Needs a CUDA device and nvcc; imports no jax.
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

SLOTS = 10    # start, staged, coarse, (select, pass) x 2 rounds, end;
              # clock64 at the start and the end
MAX_BLOCKS = 16384   # a block's start, its last turn's checks' start, end

# the stamp writes, as (text of the shipped source, text with the stamps)
_STAMPS = (
    ("namespace {\n\nusing namespace hullk;\n",
     "namespace {\n\nusing namespace hullk;\n\n"
     "__device__ long long* g_stamps = nullptr;\n"
     "#define STAMP(at) { unsigned long long now;"
     ' asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));'
     " if (threadIdx.x == 0 && g_stamps != nullptr) g_stamps[at] = now; }\n"),
    ("  const int tid = threadIdx.x;\n  // every copy in flight before the one"
     " wait\n",
     f"  const int tid = threadIdx.x;\n  STAMP(inst * {SLOTS});\n"
     f"  if (tid == 0 && g_stamps) g_stamps[inst * {SLOTS} + 8] = clock64();\n"
     "  // every copy in flight before the one wait\n"),
    ("  A.nv = last[0];\n  B.nv = last[1];\n",
     "  A.nv = last[0];\n  B.nv = last[1];\n"
     f"  STAMP(inst * {SLOTS} + 1);\n"),
    ("  const float4 u = coarse(best.c);\n",
     f"  STAMP(inst * {SLOTS} + 2);\n  const float4 u = coarse(best.c);\n"),
    ("    block_select(A, B, E, K, cur_x, cur_y, cur_z, sc);\n"
     "    best = block_pass(A, B, K * K, sc, cross);\n",
     "    block_select(A, B, E, K, cur_x, cur_y, cur_z, sc);\n"
     f"    if (r < 2) STAMP(inst * {SLOTS} + 3 + 2 * r);\n"
     "    best = block_pass(A, B, K * K, sc, cross);\n"
     f"    if (r < 2) STAMP(inst * {SLOTS} + 4 + 2 * r);\n"),
    ("  if (tid == 0) depth_out[inst] = cur_d;\n",
     f"  STAMP(inst * {SLOTS} + 7);\n"
     f"  if (tid == 0 && g_stamps) g_stamps[inst * {SLOTS} + 9] = clock64();\n"
     "  if (tid == 0) depth_out[inst] = cur_d;\n"),
    ("  __shared__ int live[kBlockWarps];\n",
     "  __shared__ int live[kBlockWarps];\n"
     f"  STAMP(N * {SLOTS} + blockIdx.x);\n"),
    ("    const long long inst = t * perm % N;\n",
     "    const long long inst = t * perm % N;\n"
     f"    STAMP(N * {SLOTS} + {MAX_BLOCKS} + blockIdx.x);\n"),
    ("    __syncthreads();  // the masks are read and live is set\n",
     "    __syncthreads();  // the masks are read and live is set\n"
     f"    STAMP(N * {SLOTS} + 2 * {MAX_BLOCKS} + blockIdx.x);\n"),
    ('extern "C" int mtv_query_f32(',
     'extern "C" int mtv_set_stamps(long long* p) {\n'
     "  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &p, "
     "sizeof(p)));\n}\n\n"
     'extern "C" int mtv_query_f32('),
)


def _pct(x):
    return [float(v) for v in np.percentile(x, [0, 10, 50, 90, 100])] \
        if len(x) else None


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_mtv_stamps: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    lib = cuda_build.build_variant("mtv_query", "stamped", _STAMPS)
    shipped = mtv_query._load().mtv_query_f32
    lib.mtv_query_f32.restype = ctypes.c_int
    lib.mtv_query_f32.argtypes = shipped.argtypes
    lib.mtv_set_stamps.restype = ctypes.c_int
    lib.mtv_set_stamps.argtypes = [ctypes.c_void_p]
    rng = np.random.default_rng(0)
    pebbles = bench._fixture_pairs(rng, 8192)
    few = [a.clone() for a in pebbles]
    dead = torch.ones(8192, dtype=torch.bool, device="cuda")
    dead[list(bench.FEW_LIVE)] = False
    for a in few:
        a[dead] = 0.0
    out = dict(card=card, percentiles="0/10/50/90/100", device_ms={},
               phases_us={})
    for key, args in (("N8192_bighull_7_live", few),
                      ("N8192_bighull_all_live", pebbles)):
        N, V = args[0].shape[0], args[0].shape[1]
        E, F = args[2].shape[1], args[6].shape[1]
        out["device_ms"][key] = bench._graph_ms(
            lambda: mtv_query.mtv_query_cuda(*args))
        ref_d, ref_n = mtv_query.mtv_query_cuda(*args)
        st = torch.zeros(N * SLOTS + 3 * MAX_BLOCKS, dtype=torch.int64,
                         device="cuda")
        if lib.mtv_set_stamps(st.data_ptr()) != 0:
            raise RuntimeError("mtv_set_stamps failed")
        depth = torch.empty(N, device="cuda")
        n = torch.empty(N, 3, device="cuda")
        turns = torch.zeros(2, dtype=torch.int64, device="cuda")
        cuda_build.launch(
            args[0].device, lib.mtv_query_f32, *[t.data_ptr() for t in args],
            depth.data_ptr(), n.data_ptr(), turns.data_ptr(), N, V, E, F,
            mtv_query.K_EDGE, mtv_query.REFINE_ROUNDS)
        torch.cuda.synchronize()
        if not (torch.equal(depth, ref_d) and torch.equal(n, ref_n)):
            raise AssertionError(f"{key}: the stamped copy differs")
        t = st.cpu().numpy().astype(np.float64)
        bl = t[N * SLOTS:].reshape(3, MAX_BLOCKS)
        started = bl[0] > 0
        blocks = bl[0][started]
        t0 = blocks.min()
        s = t[: N * SLOTS].reshape(N, SLOTS)
        s = s[s[:, 0] > 0]
        us = lambda a: (a / 1e3).tolist()
        ph = dict(live_instances=int(len(s)),
                  start=_pct(us(s[:, 0] - t0)), staging=_pct(us(s[:, 1] - s[:, 0])),
                  coarse=_pct(us(s[:, 2] - s[:, 1])))
        prev = s[:, 2]
        for r in range(2):
            for i, name in enumerate(("select", "pass")):
                col = s[:, 3 + 2 * r + i]
                ran = col > 0
                ph[f"round{r}_{name}"] = _pct(us((col - prev)[ran]))
                prev = np.where(ran, col, prev)
        ph["end"] = _pct(us(s[:, 7] - t0))
        # the SM clock over each instance: cycles over nanoseconds
        ph["sm_ghz"] = _pct(((s[:, 9] - s[:, 8]) / (s[:, 7] - s[:, 0])).tolist())
        ph["blocks"] = int(len(blocks))
        # a block's last turn: its checks, and when they ended
        b0, b1, b2 = (x[started] for x in bl)
        ph["block_last_checks"] = _pct(us(b2 - b1))
        ph["block_last_checks_end"] = _pct(us(b2 - t0))
        out["phases_us"][key] = ph
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
