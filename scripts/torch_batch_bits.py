"""Which op of the step gives a shard of a batch other bits than the same
rows of the whole batch?

    PYTHONPATH=. python3 scripts/torch_batch_bits.py [nenv] [shards] [steps]

Steps box @nenv (default 4096, chip_smoke's parallel workload: a seeded
lift in z) and its ``shards`` (default 4) env blocks side by side, each
from the state the other reached, until a block's recurrent state
differs from the same rows of the whole batch (at most ``steps``, default
300).  It then replays that step for both under a dispatch logger and
prints the first ops whose output rows differ, with their argument
shapes.  Prints one JSON object.  On the card by default; without one it
runs in f32 on the CPU.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mujoco_sim_tpu_torch as mst
from mujoco_sim_tpu_torch.parallel.rollout import RECURRENT
from mujoco_sim_tpu_torch.utils.struct import map_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Log(TorchDispatchMode):
    """Every aten op with copies of its tensor outputs."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else [out]
        self.ops.append((str(func), [
            o.detach().clone() if isinstance(o, torch.Tensor) else None
            for o in outs], [tuple(a.shape) if isinstance(a, torch.Tensor)
                             else a for a in args][:4]))
        return out


def _carry(d):
    return {k: getattr(d, k) for k in RECURRENT}


def _first_differing_ops(full_ops, part_ops, i, shards, limit=4):
    found = []
    for j, ((name, outs_f, args_f), (name_s, outs_s, args_s)) in enumerate(
            zip(full_ops, part_ops)):
        if name != name_s:
            found.append(dict(op=j, parted=[name, name_s]))
            break
        if name.startswith(("aten.empty", "aten.new_empty")):
            continue                      # uninitialised memory
        for a, b in zip(outs_f, outs_s):
            if (a is None or b is None or a.dim() == 0
                    or a.shape[1:] != b.shape[1:]):
                continue
            if a.shape[0] == shards * b.shape[0]:
                a = a[i * b.shape[0]:(i + 1) * b.shape[0]]
            elif a.shape[0] != b.shape[0]:
                continue
            if not torch.equal(a, b):
                found.append(dict(
                    op=j, name=name, args=str(args_f),
                    args_shard=str(args_s), out=list(a.shape),
                    max_diff=float((a.double() - b.double()).abs().max())
                    if a.is_floating_point() else None))
                break
        if len(found) >= limit:
            break
    return found


def main(argv):
    nenv = int(argv[0]) if argv else 4096
    shards = int(argv[1]) if len(argv) > 1 else 4
    nsteps = int(argv[2]) if len(argv) > 2 else 300
    device = "cuda" if torch.cuda.is_available() else "cpu"
    m = mst.put_model(mst.load_model(os.path.join(
        ROOT, "tests", "fixtures", "floor_box.xml")), torch.float32, device)
    d = mst.make_data(m, nenv)
    lift = np.random.default_rng(9).uniform(0.0, 0.3, nenv)
    qpos = d.qpos.clone()
    qpos[:, 2] += torch.tensor(lift, dtype=qpos.dtype, device=qpos.device)
    d = d.replace(qpos=qpos)
    per = nenv // shards
    blocks = [map_leaves(lambda x: x[i * per:(i + 1) * per].clone(), d)
              for i in range(shards)]
    full, parts, first = d, blocks, None
    for t in range(nsteps):
        f2 = mst.step(m, d.replace(**_carry(full)))
        p2 = [mst.step(m, b.replace(**_carry(p)))
              for b, p in zip(blocks, parts)]
        for i in range(shards):
            for k in RECURRENT:
                a = getattr(f2, k)[i * per:(i + 1) * per]
                b = getattr(p2[i], k)
                if first is None and not torch.equal(a, b):
                    first = dict(step=t, shard=i, leaf=k, max_diff=float(
                        (a.double() - b.double()).abs().max()))
        if first is not None:
            break
        full, parts = f2, p2
    out = dict(device=(torch.cuda.get_device_name(0) if device == "cuda"
                       else "cpu"), nenv=nenv, shards=shards,
               first_difference=first)
    if first is not None:
        i = first["shard"]
        for _ in range(2):        # warm: plans are built on a first call
            mst.step(m, d.replace(**_carry(full)))
            mst.step(m, blocks[i].replace(**_carry(parts[i])))
        with _Log() as lf:
            mst.step(m, d.replace(**_carry(full)))
        with _Log() as ls:
            mst.step(m, blocks[i].replace(**_carry(parts[i])))
        out["ops_in_step"] = [len(lf.ops), len(ls.ops)]
        out["first_differing_ops"] = _first_differing_ops(
            lf.ops, ls.ops, i, shards)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
