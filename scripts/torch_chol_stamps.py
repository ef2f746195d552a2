"""Where the time of chol_solve's panel kernel (n > 64) goes, on one NVIDIA
GPU.

    PYTHONPATH=. python3 scripts/torch_chol_stamps.py

At the timed shapes ((N, n) = (1024, 66), the pile scene's solves, and
(256, 128)) it builds a stamped copy of csrc/chol_solve.cu at run time
from the checkout's source into the build directory (thread 0 of every
block reads the globaltimer: at its start, when the matrix has landed,
after each panel's diagonal block, rows and trailing update, and after the
backward substitution), checks its result against the twin, and prints
one JSON object with, per shape, the device time of the shipped kernel (a
launch's share of a replayed CUDA graph of 50) and the stamped copy's
phases: percentiles over the blocks of each phase's microseconds, and of
when the blocks started and ended (microseconds after the first block
started).

The shipped kernel carries no stamps; the copy differs from it only in
the stamp writes (the factor's panel loop is written out in the copy so
that its phases can be stamped).  Needs a CUDA device and nvcc; imports
no jax.
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
from mujoco_sim_tpu_torch.ops import chol, cuda_build  # noqa: E402

SHAPES = ((1024, 66), (256, 128))
PANELS = 8                          # panels a block stamps (n <= 256)
SLOTS = 3 + 3 * PANELS              # start, staged, 3 a panel, backward

_NOW = ('  unsigned long long now;\n'
        '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));\n')

# the stamp writes, as (text of the shipped source, text with the stamps)
_STAMPS = (
    ("                            float* __restrict__ x, int n, int ld) {",
     "                            float* __restrict__ x, int n, int ld,\n"
     "                            long long* __restrict__ stamps) {"),
    ("  const Panels p(smem, n, ld);\n  stage_panels(p, A + sys * n * n);\n",
     "  const Panels p(smem, n, ld);\n"
     f"  long long* st = stamps + sys * {SLOTS};\n"
     "  int slot = 0;\n"
     "#define STAMP() { " + _NOW.replace("\n", " ")
     + " if (threadIdx.x == 0) st[slot] = now; ++slot; }\n"
     "  STAMP();\n"
     "  stage_panels(p, A + sys * n * n);\n"),
    ("  factor_panels<true>(p);\n  backward_panels(p);\n",
     "  STAMP();\n"
     "  for (int j0 = 0; j0 < p.n; j0 += kPanel) {\n"
     "    const int w = min(kPanel, p.n - j0), j1 = j0 + w;\n"
     "    if (threadIdx.x < kWarp) diag_block<true>(p, j0, w, threadIdx.x);\n"
     "    __syncthreads();\n"
     "    STAMP();\n"
     "    if (j1 < p.n) {\n"
     "      panel_rows<true>(p, j0, j1);\n"
     "      __syncthreads();\n"
     "      STAMP();\n"
     "      trailing_update(p, j0, j1);\n"
     "      __syncthreads();\n"
     "      STAMP();\n"
     "    } else {\n"
     "      slot += 2;\n"
     "    }\n"
     "  }\n"
     f"  slot = {SLOTS - 1};\n"
     "  backward_panels(p);\n"
     "  STAMP();\n"),
    ("int launch_big(const float* A, const float* b, float* x, float* work, "
     "int N,",
     "long long* g_stamps = nullptr;\n\n"
     "int launch_big(const float* A, const float* b, float* x, float* work, "
     "int N,"),
    ("(A, b, x,\n                                                          "
     "         n, ld);",
     "(A, b, x,\n                                                          "
     "         n, ld, g_stamps);"),
    ('extern "C" int chol_solve_f32(',
     'extern "C" void chol_set_stamps(long long* p) { g_stamps = p; }\n\n'
     'extern "C" int chol_solve_f32('),
)


def _stamped_library():
    lib = cuda_build.build_variant("chol_solve", "stamped", _STAMPS)
    lib.chol_solve_f32.restype = ctypes.c_int
    lib.chol_solve_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    lib.chol_set_stamps.restype = None
    lib.chol_set_stamps.argtypes = [ctypes.c_void_p]
    return lib


def _pct(x):
    return [float(v) for v in np.percentile(x, [0, 10, 50, 90, 100])]


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_chol_stamps: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    lib = _stamped_library()
    rng = np.random.default_rng(0)
    out = dict(card=card, percentiles="0/10/50/90/100", device_ms={},
               phases_us={})
    for N, n in SHAPES:
        key = f"N{N}_n{n}"
        A = torch.tensor(bench._spd(rng, N, n), dtype=torch.float32,
                         device="cuda")
        b = torch.randn(N, n, device="cuda")
        out["device_ms"][key] = bench._graph_ms(
            lambda: chol.chol_solve_cuda(A, b))
        st = torch.zeros(N * SLOTS, dtype=torch.int64, device="cuda")
        x = torch.empty_like(b)
        lib.chol_set_stamps(st.data_ptr())
        cuda_build.launch(A.device, lib.chol_solve_f32, A.data_ptr(),
                          b.data_ptr(), x.data_ptr(), None, N, n)
        torch.cuda.synchronize()
        err = float((x - chol.chol_solve_plain(A, b)).abs().max())
        if err > 1e-3:
            raise AssertionError(f"stamped chol_solve disagrees: {err}")
        t = st.view(N, SLOTS).cpu().numpy().astype(np.float64) / 1e3
        t0 = t[:, 0].min()
        panels = (n + 31) // 32
        ph = dict(start=_pct(t[:, 0] - t0), staging=_pct(t[:, 1] - t[:, 0]))
        prev = t[:, 1]
        for q in range(panels):
            for i, name in enumerate(("diag", "rows", "trailing")):
                s = t[:, 2 + 3 * q + i]
                if q == panels - 1 and i > 0:
                    continue
                ph[f"panel{q}_{name}"] = _pct(s - prev)
                prev = s
        ph["backward"] = _pct(t[:, SLOTS - 1] - prev)
        ph["end"] = _pct(t[:, SLOTS - 1] - t0)
        out["phases_us"][key] = ph
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
