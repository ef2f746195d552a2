"""The program's sharded rollout, ``parallel/mesh.make_sharded_rollout``:
the batch split into ``law_params["shards"]`` equal shards in env order,
shard i on card i (``make_env_mesh``, ``replicate_model``), each stepped
by its own CUDA graph with the law's control inside it, reading its own
shard's phases on its card.  One host thread issues every shard's steps
before it waits on any card; each call then waits on every card
(harness/window.py's sync waits on the first card alone).

An episode's first call gets the plain initial state (the whole batch on
the first card): the reset, ``mesh.scatter``, writes it and the episode's
phases into the shards' existing tensors, so no shard is allocated after
the first episode.  Where fewer cards are visible than shards (a
rehearsal through run.main(device=...): run.py refuses the cell below
its ``chips``), the shards wrap onto the cards there are; on the CPU all
are on the CPU.  The devices are printed on standard error.
"""

from __future__ import annotations

import sys

import torch


def devices(m, shards: int) -> list:
    """Shard i's device: the model's card plus i, wrapped onto the cards
    there are; the CPU for a CPU model."""
    dev = m.device
    if dev.type != "cuda":
        return [dev] * shards
    n = torch.cuda.device_count()
    return [torch.device("cuda", (dev.index + i) % n) for i in range(shards)]


class Entry:
    sync_each_segment = True

    def __init__(self, P, m, law, bufs, p):
        self.P, self.bufs = P, bufs
        devs = devices(m, int(p["shards"]))
        print(f"sharded_rollout: {len(devs)} shards on "
              f"{', '.join(map(str, devs))}", file=sys.stderr)
        self.mesh = P.mesh.make_env_mesh(devs)
        self.cards = list(dict.fromkeys(self.mesh.local_devices))
        self.mR = P.mesh.replicate_model(m, self.mesh)
        self.phase = P.mesh.shard_batch(bufs["phase"], self.mesh)
        self.run = P.mesh.make_sharded_rollout(
            self.mR, self.mesh, ctrl_fn=[law.ctrl_fn({"phase": ph}, p)
                                         for ph in self.phase.shards])
        self.dS = None

    def segment(self, carry, n: int):
        M = self.P.mesh
        if not isinstance(carry, M.Sharded):      # an episode's reset
            if self.dS is None:
                self.dS = M.shard_batch(carry, self.mesh)
            else:
                M.scatter(carry, self.dS)
            M.scatter(self.bufs["phase"], self.phase)
            carry = self.dS
        out = self.run(self.mR, carry, n)
        for dev in self.cards:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return out
