"""Where the time of the support_minmax kernel goes, on one NVIDIA GPU.

    PYTHONPATH=. python3 scripts/torch_support_stamps.py

At the timed shapes (N = 8192, V = 24, C = 68 and 256) it builds a stamped
copy of the kernel (globaltimer and clock64 read by lane 0 of every warp:
at its start, when an item's data has landed, when the item's scan and
stores are done) at run time from the checkout's source into the build
directory, checks its result against the twin, and prints one JSON object
with, per shape, the device time of the shipped kernel (a launch's share
of a replayed CUDA graph of 50) and the stamped copy's timeline:
percentiles over the warps of when their data landed and when they
finished (microseconds after the first warp started), and of the clocks a
scan took, for the first items a warp walks.

The shipped kernel carries no stamps; the copy differs from it only in
the stamp writes.  Needs a CUDA device and nvcc; imports no jax.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mujoco_sim_tpu_torch.ops import cuda_build  # noqa: E402
from mujoco_sim_tpu_torch.ops import support_minmax as smm  # noqa: E402

SHAPES = ((8192, 68, 24), (8192, 256, 24))
ITEMS = 4            # items a warp stamps
SLOTS = 2 + 4 * ITEMS

# the stamp writes, as (text of the shipped source, text with the stamps)
_STAMPS = (
    ("float* __restrict__ mx, long long N, int C, int V) {",
     "float* __restrict__ mx, long long N, int C, int V,\n"
     "                          long long* __restrict__ stamps) {"),
    ("  int cur = 0;\n",
     "  int cur = 0;\n"
     f"  long long* st = stamps + w0 * {SLOTS};\n"
     "  int it = 0;\n"
     "  unsigned long long gt;\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt));\n'
     "  if (lane == 0) { st[0] = gt; st[1] = clock64(); }\n"),
    ("    asynccopy::wait_pending<1>();\n    __syncwarp();\n",
     "    asynccopy::wait_pending<1>();\n    __syncwarp();\n"
     f"    if (it < {ITEMS} && lane == 0) {{\n"
     '      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt));\n'
     "      st[2 + 4 * it] = gt; st[3 + 4 * it] = clock64();\n    }\n"),
    ("    at = nx;\n",
     f"    if (it < {ITEMS} && lane == 0) {{\n"
     '      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt));\n'
     "      st[4 + 4 * it] = gt; st[5 + 4 * it] = clock64();\n    }\n"
     "    ++it;\n    at = nx;\n"),
    ("      axes, w, mn, mx, N, C, V);",
     "      axes, w, mn, mx, N, C, V, stamps);\n  *nwarps = blocks * kWarps;"),
    ("           long long N, int C, int V, cudaStream_t stream) {",
     "           long long N, int C, int V, cudaStream_t stream,\n"
     "           long long* stamps, long long* nwarps) {"),
    ('extern "C" int support_minmax_f32(', 'extern "C" int support_minmax_stamped('),
    ("                                  void* stream) {",
     "                                  void* stream,\n"
     "                                  long long* stamps, long long* nwarps) {"),
    ("(axes, w, mn, mx, N, C, V, s);",
     "(axes, w, mn, mx, N, C, V, s, stamps, nwarps);"),
)


def _stamped_library():
    lib = cuda_build.build_variant("support_minmax", "stamped", _STAMPS)
    lib.support_minmax_stamped.restype = ctypes.c_int
    lib.support_minmax_stamped.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 2
        + [ctypes.c_void_p] * 3)
    return lib


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


def _pct(x):
    return [float(v) for v in np.percentile(x, [0, 10, 50, 90, 100])]


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_support_stamps: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    stamped = _stamped_library()
    rng = np.random.default_rng(0)
    out = dict(card=card, percentiles="0/10/50/90/100", device_ms={},
               timeline={})
    for N, C, V in SHAPES:
        key = f"N{N}_C{C}_V{V}"
        axes = torch.tensor(rng.normal(size=(N, C, 3)), dtype=torch.float32,
                            device="cuda")
        w = torch.tensor(rng.normal(size=(N, V, 3)), dtype=torch.float32,
                         device="cuda")
        mn = torch.empty(N, C, device="cuda")
        mx = torch.empty(N, C, device="cuda")
        rn, rx = smm.support_minmax_plain(axes, w)
        layout = "8x9" if C <= 72 else "32x8"   # the C entry's pick
        out["device_ms"][key] = _graph_ms(
            lambda: smm.support_minmax_cuda(axes, w))

        st = torch.zeros(40000 * SLOTS, dtype=torch.int64, device="cuda")
        nw = ctypes.c_longlong(0)
        for _ in range(3):                      # the last run is read
            st.zero_()
            rc = stamped.support_minmax_stamped(
                axes.data_ptr(), w.data_ptr(), mn.data_ptr(), mx.data_ptr(),
                N, C, V, torch.cuda.current_stream().cuda_stream,
                st.data_ptr(), ctypes.byref(nw))
            torch.cuda.synchronize()
        if rc != 0 or not (torch.equal(mn, rn) and torch.equal(mx, rx)):
            raise AssertionError("the stamped kernel differs from the twin")
        s = st[:nw.value * SLOTS].view(-1, SLOTS).cpu().numpy().astype(
            np.float64)
        s = s[s[:, 0] > 0]
        t0 = s[:, 0].min()
        items = []
        for i in range(ITEMS):
            landed, done = s[:, 2 + 4 * i], s[:, 4 + 4 * i]
            m = landed > 0
            if not m.any():
                break
            items.append(dict(
                warps=int(m.sum()),
                data_landed_us=_pct((landed[m] - t0) / 1e3),
                done_us=_pct((done[m] - t0) / 1e3),
                scan_and_store_clocks=_pct(s[m, 5 + 4 * i] - s[m, 3 + 4 * i])))
        last = max(float(s[:, 4 + 4 * i].max()) for i in range(len(items)))
        out["timeline"][key] = dict(
            layout=layout, warps=int(len(s)),
            span_us=(last - t0) / 1e3, items=items)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
