"""The general generator and the measured window.

A traffic mix is data (traffic/<mix>.json); this module turns it and the
seed into work:

* ``draws``: each named draw is uniform in [low, high) with the shape its
  ``dims`` give (``nenv``, a model size such as ``nu``, or a number),
  made on the card anew at each episode's start.  An episode's set of
  values is the same for every seed (a generator seeded by the episode's
  index); the seed deals them out to the envs (a permutation of the env
  axis from a generator seeded with the seed).  A batched step runs as
  long as its slowest env needs (the Newton loop runs until every env has
  converged), so values drawn afresh by each seed changed the work: 65k
  against 71k env-steps/s between seeds of manip @1024 on an H100;
* ``Plan``: the steps at which the checks take the program's state
  before and after a step (one drawn from the seed in each half of an
  episode, and its last step; not the first, whose state before is the
  initial state, which the check compares by itself), the envs they take
  (drawn from the seed), and the
  episode cut into the calls the entry makes (at most ``chunk_steps``
  steps each, a call of one step at each checked step);
* ``run``: episodes back to back, each from the initial state (the reset
  is the entry's copy of that state into its inputs), until the window's
  seconds have passed at the end of a call.  The window's time and its
  steps are all the work, resets included.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


def _dim(x, m, nenv: int) -> int:
    if x == "nenv":
        return nenv
    if isinstance(x, str):
        return int(getattr(m, x))
    return int(x)


EPISODE_SEED = 0x5EED0000


def draws(spec: dict, m, nenv: int, gen: torch.Generator,
          episode: int) -> dict:
    """Episode ``episode``'s draws, in the order the mix lists them: the
    episode's values, dealt to the envs by ``gen`` (the run's seed)."""
    base = torch.Generator(device=gen.device)
    base.manual_seed(EPISODE_SEED + episode + 1)
    deal = torch.randperm(nenv, generator=gen, device=gen.device)
    out = {}
    for name, d in spec.items():
        shape = tuple(_dim(x, m, nenv) for x in d["dims"])
        u = torch.rand(shape, generator=base, dtype=torch.float64,
                       device=gen.device)
        out[name] = (d["low"] + (d["high"] - d["low"]) * u)[deal].to(m.dtype)
    return out


@dataclasses.dataclass
class Plan:
    episode_steps: int
    chunk_steps: int
    rows: np.ndarray            # the envs the checks take
    rng: np.random.Generator    # draws each episode's checked step

    @classmethod
    def make(cls, traffic: dict, nenv: int, seed: int) -> "Plan":
        rng = np.random.default_rng(seed)
        k = min(traffic["check"]["envs"], nenv)
        rows = np.sort(rng.choice(nenv, size=k, replace=False))
        return cls(int(traffic["episode_steps"]),
                   int(traffic["chunk_steps"]), rows, rng)

    def episode(self) -> tuple[list, set]:
        """(calls as (first step, steps), the checked steps) of the next
        episode."""
        T = self.episode_steps
        checks = {int(self.rng.integers(1, T // 2)),
                  int(self.rng.integers(T // 2, T - 1)), T - 1}
        return calls(T, self.chunk_steps, checks), checks


def calls(T: int, chunk: int, checks: set) -> list:
    """An episode of T steps as (first step, steps) calls of at most chunk
    steps, each checked step a call of its own."""
    cuts = set(range(0, T, chunk)) | {T}
    for k in checks:
        cuts |= {k, k + 1}
    cuts = sorted(cuts)
    return [(a, b - a) for a, b in zip(cuts, cuts[1:])]


@dataclasses.dataclass
class Window:
    steps: int = 0              # env-steps completed (batch x steps)
    seconds: float = 0.0
    episodes: int = 0
    checks: list = dataclasses.field(default_factory=list)
    carry: object = None        # the state when the window closed


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(entry, law, plan: Plan, carry0, fill, seconds: float, nenv: int,
        rows: torch.Tensor, dev, checked: bool = True) -> Window:
    """Episodes through ``entry`` until ``seconds`` have passed at the end
    of a call and a step has been checked (the first check falls in an
    episode's first half, well inside every cell's window on the card);
    ``fill(episode)`` writes an episode's draws into the law's buffers.
    Each checked step leaves (episode, step, state before, state after,
    the law's inputs) in ``checks``, still on the card.  ``checked``
    False (tools/check_cost.py) runs the same episodes with no step
    checked, so no call is cut for a check."""
    w = Window()
    _sync(dev)
    t0 = time.perf_counter()
    done = False
    while not done:
        inputs = fill(w.episodes)
        episode, checks = plan.episode()
        if not checked:
            episode, checks = calls(plan.episode_steps, plan.chunk_steps,
                                    set()), set()
        carry = carry0
        for first, n in episode:
            pre = law.snap(carry, rows) if first in checks and n == 1 \
                else None
            carry = entry.segment(carry, n)
            w.steps += n * nenv
            if pre is not None:
                w.checks.append((w.episodes, first, pre,
                                 law.snap(carry, rows),
                                 {k: v.index_select(0, rows)
                                  for k, v in inputs.items()}))
            if entry.sync_each_segment:
                _sync(dev)
            if (time.perf_counter() - t0 >= seconds
                    and (w.checks or not checked)):
                done = True
                break
        w.episodes += 1
    _sync(dev)
    w.seconds = time.perf_counter() - t0
    w.carry = carry
    return w
