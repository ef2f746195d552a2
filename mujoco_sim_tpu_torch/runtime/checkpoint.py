"""Checkpoint / resume + scene snapshot ("screenshot") service.

Torch port of mujoco_sim_tpu/runtime/checkpoint.py.  The reference's
closest analogue is the /mujoco/screenshot service
(src/mujoco_sim/mj_ros.cpp:670-777): live model saved as relocatable MJCF
with meshes, plus mj_printModel/mj_printData dumps; warm-resume exists via
add_old_state's full state transplant incl. qacc_warmstart
(mj_sim.cpp:465-558).  Here: exact-state checkpoints of Data (npz) + the
same relocatable MJCF snapshot.

The npz keys are the JAX package's (``data/qpos``, ``data/contact/dist``,
...), so a checkpoint of the same state written by either package reads
back equal in the other.  The port's leaves carry the env axis; a
checkpoint of one unbatched JAX env loads as one env.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.model import Model, Data
from mujoco_sim_tpu_torch.utils.struct import (host_env, leaf_names,
                                              leaves_with_keys)


def save_state(data: Data, path: str, extra: dict | None = None):
    """Exact Data checkpoint (state + warmstart + masks) -> one .npz."""
    arrays = {k: v.detach().cpu().numpy()
              for k, v in leaves_with_keys(data)}
    meta = json.dumps(extra or {})
    np.savez_compressed(path, __meta__=np.frombuffer(
        meta.encode(), dtype=np.uint8), **arrays)


def _restore(obj, arrays, unbatched, prefix="data"):
    updates = {}
    for name in leaf_names(obj):
        v = getattr(obj, name)
        key = f"{prefix}/{name}"
        if dataclasses.is_dataclass(v):
            updates[name] = _restore(v, arrays, unbatched, key)
        elif key in arrays:
            a = arrays[key][None] if unbatched else arrays[key]
            updates[name] = torch.as_tensor(a, dtype=v.dtype, device=v.device)
    return obj.replace(**updates)


def load_state(m: Model, path: str, dtype=None) -> tuple[Data, dict]:
    """Restore a Data checkpoint into a fresh make_data skeleton on the
    model's device, with as many envs as the checkpoint holds."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k.startswith("data/")}
        meta = (json.loads(bytes(z["__meta__"]).decode())
                if "__meta__" in z.files else {})
    unbatched = arrays["data/qpos"].ndim == 1
    nenv = 1 if unbatched else arrays["data/qpos"].shape[0]
    d = engine.make_data(m, nenv, dtype)
    return _restore(d, arrays, unbatched), meta


def screenshot(spec, m: Model, d: Data, out_dir: str,
               name: str = "snapshot") -> dict:
    """Relocatable scene snapshot of env 0: MJCF + meshes + model/data
    dumps + state.

    Returns the file map (the reference returns the xml path in the Trigger
    response message, mj_ros.cpp:770-775).  The exporters read numpy
    arrays, so they get host copies: the model's leaves and env 0 of
    Data, one copy each.
    """
    from mujoco_sim_tpu_torch.models.export_mjcf import (
        export_mjcf, print_model_txt, print_data_txt)

    hm, hd = host_env(m, d)
    os.makedirs(out_dir, exist_ok=True)
    files = {}
    xml = os.path.join(out_dir, f"{name}.xml")
    export_mjcf(spec, xml, model=hm, data=hd)
    files["xml"] = xml
    mtxt = os.path.join(out_dir, f"{name}.txt")
    print_model_txt(hm, mtxt)
    files["model_txt"] = mtxt
    dtxt = os.path.join(out_dir, f"{name}_data.txt")
    print_data_txt(hm, hd, dtxt)
    files["data_txt"] = dtxt
    st = os.path.join(out_dir, f"{name}_state.npz")
    save_state(d, st, extra={"time": float(hd.time)})
    files["state"] = st
    return files
