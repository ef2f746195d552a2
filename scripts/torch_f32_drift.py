"""How far float32 drifts from float64 on the CPU over chip_smoke.py's
cross-check rollout, with no card: the plain twins in float32 against the
same scene in float64.

    PYTHONPATH=. python3 scripts/torch_f32_drift.py [bighull] [manip] [terrain]

For each scene named (default: all three) it runs chip_smoke.cross_drift
(16 envs, 50 stirred steps from the fixture's initial state) with a
float32 model on the CPU -- for terrain, chip_smoke.terrain_cross_drift
from the float32 model's own state after 220 stirred steps (the length of
the card's terrain main path), with every object on the ground -- and
prints one JSON object: the fraction of qpos entries
inside the 2.5e-3 band, overall and body by body, and the largest
deviations.  chip_smoke.py's card cross checks read the same numbers with
the float32 model on the card; the two readings side by side tell drift
that float32 alone causes from drift that the kernels add.  Imports no jax.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import mujoco_sim_tpu_torch as mst  # noqa: E402

SCENES = dict(bighull=chip_smoke.BIGHULL, manip=chip_smoke.MANIP,
              terrain=chip_smoke.TERRAIN)
TERRAIN_WARM = 220


def main(argv):
    torch.set_num_threads(min(8, torch.get_num_threads()))
    out = {}
    for name in argv or list(SCENES):
        t0 = time.perf_counter()
        m32 = mst.put_model(mst.load_model(SCENES[name]), torch.float32, "cpu")
        if name == "terrain":
            start = mst.rollout(m32, mst.make_data(m32, 16), TERRAIN_WARM,
                                ctrl_fn=chip_smoke._stir_ranged(m32, 16))
            r = chip_smoke.terrain_cross_drift(m32, start)
        else:
            r = chip_smoke.cross_drift(m32, SCENES[name])
        out[name] = dict(r, seconds=time.perf_counter() - t0)
    print(json.dumps(dict(run="float32 CPU vs float64 CPU",
                          band=chip_smoke.MANIP_CROSS_TOL, scenes=out)),
          flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
