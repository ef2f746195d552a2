"""laws/sine.py's stir, ctrl = amp sin(freq time + phase), over a batch
sharded by entries/sharded_rollout.py: one phase per env and actuator,
drawn from the seed each episode, kept whole on the first card (the
draws, and the checks' inputs) and copied into each shard's own slice
on its card at each episode's reset by the entry.

The harness hands the law either carry: the plain batch (the initial
state, and the reference's states) or the program's sharded one (a
``Sharded`` of mujoco_sim_tpu_torch.parallel.mesh, recognised by its
``shards``).  ``snap`` gathers the checked rows from their cards;
``data`` and the eager ``step`` take the first shard, on the first card,
with its rows of the phases.
"""

from __future__ import annotations

import torch

from harness import sims
from laws import sine

buffers = sine.buffers
fill = sine.fill
ctrl = sine.ctrl
ctrl_fn = sine.ctrl_fn
carry0 = sine.carry0
rebuild = sine.rebuild


def _sharded(carry) -> bool:
    return hasattr(carry, "shards")


def data(carry):
    """The plain batch, or the first shard of a sharded one."""
    return carry.shards[0] if _sharded(carry) else carry


def step(ns, m, bufs: dict, p: dict):
    """One controlled step, eager, with ns's engine, of ``data(carry)``
    with its rows of the phases (a shard's are the batch's first rows)."""
    def f(carry):
        d = data(carry)
        phase = bufs["phase"][:d.qpos.shape[0]]
        return ns.engine.step(m, d.replace(ctrl=ctrl(d.time, phase, p)))
    return f


def snap(carry, rows) -> dict:
    """sims.snap_data of the rows (indices of the whole batch), taken from
    the shards that hold them, on rows' device, in rows' order."""
    if not _sharded(carry):
        return sims.snap_data(carry, rows)
    per = carry.shards[0].qpos.shape[0]
    want = rows.cpu()
    parts, where = [], []
    for i, d in enumerate(carry.shards):
        pos = torch.nonzero(want // per == i).flatten()
        if pos.numel():
            local = (want[pos] - i * per).to(d.qpos.device)
            parts.append(sims.snap_data(d, local))
            where.append(pos)
    order = torch.argsort(torch.cat(where)).to(rows.device)
    return {k: torch.cat([p[k].to(rows.device) for p in parts])[order]
            for k in parts[0]}
