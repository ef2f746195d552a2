"""ctrl = amp sin(freq time + phase): bench.py's stir of the manip arm,
one phase per env and actuator, drawn from the seed each episode.

The same code makes the program's controls (inside its step graph, or on
the card before each call) and the reference's, each with its own engine.
"""

from __future__ import annotations

import torch

from harness import sims


def buffers(m, nenv: int, p: dict) -> dict:
    return {"phase": torch.zeros((nenv, m.nu), dtype=m.dtype,
                                 device=m.device)}


def fill(bufs: dict, draws: dict, m, p: dict):
    bufs["phase"].copy_(draws["phase"])


def ctrl(time, phase, p: dict):
    return p["amp"] * torch.sin(p["freq"] * time[:, None] + phase)


def ctrl_fn(bufs: dict, p: dict):
    """The control as a function of the Data a step starts from."""
    phase = bufs["phase"]
    return lambda d: ctrl(d.time, phase, p)


def carry0(ns, m, nenv: int):
    return ns.engine.make_data(m, nenv)


def data(carry):
    return carry


def step(ns, m, bufs: dict, p: dict):
    """One controlled step, eager, with ns's engine."""
    fn = ctrl_fn(bufs, p)
    return lambda d: ns.engine.step(m, d.replace(ctrl=fn(d)))


def snap(carry, rows) -> dict:
    return sims.snap_data(carry, rows)


def rebuild(ns, m, snap: dict):
    """A carry of ns's at the snapped state (cast to m's dtype)."""
    d = ns.engine.make_data(m, snap["qpos"].shape[0])
    return d.replace(**{k: v.to(m.dtype) if v.is_floating_point() else v
                        for k, v in snap.items()})
