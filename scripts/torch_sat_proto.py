"""The face-SAT depth kernel against its plain twin, on the card.

    PYTHONPATH=. python3 scripts/torch_sat_proto.py [E] [P]

Counterpart of benchmarks/pallas_sat_proto.py (same arguments and
defaults: E 256 envs x P 32 pairs = N instances, V 32 points, F 60 faces,
K 2; the same seeded inputs): runs the hand-written CUDA kernel
(ops/face_sat.py) and its plain twin, prints the error line (depth, sep,
index mismatches, plane), then the time per call of each from CUDA events.
Needs a CUDA device; imports no jax.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mujoco_sim_tpu_torch.ops import face_sat  # noqa: E402
from scripts.torch_chol_proto import card_line, event_ms  # noqa: E402

V, F, K = 32, 60, 2


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("torch_sat_proto: needs a CUDA device")
    E = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    P = int(sys.argv[2]) if len(sys.argv) > 2 else 32
    N = E * P
    rng = np.random.default_rng(0)
    pts = torch.tensor(rng.standard_normal((N, V, 3)).astype(np.float32),
                       device="cuda")
    n = rng.standard_normal((N, F, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    planes = torch.tensor(np.concatenate(
        [n, rng.uniform(0.5, 1.5, (N, F, 1)).astype(np.float32)], axis=-1),
        device="cuda")
    vmask = torch.tensor((rng.uniform(size=(N, V)) > 0.1).astype(np.float32),
                         device="cuda")

    dep_k, idx_k, plane_k, sep_k = face_sat.face_sat_depth(pts, planes,
                                                           vmask, K)
    dep_p, idx_p, plane_p, sep_p = face_sat.face_sat_depth_plain(
        pts, planes, vmask, K)
    torch.cuda.synchronize()
    print(card_line())
    print("depth err:", float((dep_k - dep_p).abs().max()),
          "sep err:", float((sep_k - sep_p).abs().max()),
          "idx mismatch:", int((idx_k != idx_p).sum()),
          "plane err:", float((plane_k - plane_p).abs().max()))
    for name, f in (("kernel", face_sat.face_sat_depth),
                    ("plain ", face_sat.face_sat_depth_plain)):
        ms = event_ms(lambda: f(pts, planes, vmask, K))
        print(f"{name}: {ms * 1e3:.1f} us/call (N={N})")


if __name__ == "__main__":
    main()
