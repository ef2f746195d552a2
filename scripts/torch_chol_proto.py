"""The batched Cholesky-factor kernel against its plain twin, on the card.

    PYTHONPATH=. python3 scripts/torch_chol_proto.py [nv] [nenv]

Counterpart of benchmarks/pallas_chol_proto.py (same arguments and
defaults: nv 49, nenv 256; the same seeded SPD batch): factors the batch
with the hand-written CUDA kernel (ops/chol_factor.py) and with the plain
twin (ops/linalg.cholesky), prints the largest difference, then the time
per call of kernel, twin and torch.linalg.cholesky from CUDA events.
Needs a CUDA device; imports no jax.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mujoco_sim_tpu_torch.ops import chol_factor  # noqa: E402


def event_ms(fn, reps=20):
    """Median time of one call in ms, from CUDA events."""
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


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("torch_chol_proto: needs a CUDA device")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 49
    B = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    rng = np.random.default_rng(0)
    M = rng.standard_normal((B, n, n)).astype(np.float32)
    A = torch.tensor(M @ np.transpose(M, (0, 2, 1))
                     + 3 * n * np.eye(n, dtype=np.float32), device="cuda")
    Lr = chol_factor.chol_factor_plain(A)
    Lk = chol_factor.chol_factor(A)
    torch.cuda.synchronize()
    print(card_line())
    print(f"n={n} B={B} max |L_plain - L_kernel| = "
          f"{float((Lr - Lk).abs().max()):.3e}")
    for name, f in (("plain  ", chol_factor.chol_factor_plain),
                    ("kernel ", chol_factor.chol_factor),
                    ("library", torch.linalg.cholesky)):
        print(f"{name}: {event_ms(lambda: f(A)) * 1e3:.1f} us/call")


if __name__ == "__main__":
    main()
