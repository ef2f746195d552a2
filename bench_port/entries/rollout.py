"""The program's graph rollout, ``parallel/rollout.rollout(m, d, n,
ctrl_fn=...)``: one CUDA graph a step, replayed n times in place, the
law's control computed inside the graph from the state each step starts
from."""

from __future__ import annotations


class Entry:
    sync_each_segment = True

    def __init__(self, P, m, law, bufs, p):
        self.P, self.m = P, m
        self.ctrl_fn = law.ctrl_fn(bufs, p)

    def segment(self, carry, n: int):
        return self.P.rollout.rollout(self.m, carry, n, ctrl_fn=self.ctrl_fn)
