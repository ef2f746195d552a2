"""The gym-style loop: each step the harness computes the law's control
from the observation (``d.time``) on the card and calls the program's
``parallel/rollout.batched_step(m, d)`` once (copy-in of the state,
replay of the step graph, clone of the result).  Each call's time on the
stream is taken by CUDA events recorded around it; nothing in the loop
waits for the card.  (On the CPU, where the tests rehearse a run, the
host clock times each call: the CPU's work is done when the call
returns.)"""

from __future__ import annotations

import time

import torch


class Entry:
    sync_each_segment = False

    def __init__(self, P, m, law, bufs, p):
        self.P, self.m = P, m
        self.ctrl_fn = law.ctrl_fn(bufs, p)
        self.events = []
        self.timing = False

    def segment(self, carry, n: int):
        d = carry
        for _ in range(n):
            d = d.replace(ctrl=self.ctrl_fn(d))
            if not self.timing:
                d = self.P.rollout.batched_step(self.m, d)
            elif self.m.device.type == "cuda":
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                d = self.P.rollout.batched_step(self.m, d)
                b.record()
                self.events.append((a, b))
            else:
                t0 = time.perf_counter()
                d = self.P.rollout.batched_step(self.m, d)
                self.events.append((t0, time.perf_counter()))
        return d

    def call_ms(self) -> list:
        """Each timed call's milliseconds (after the card has finished)."""
        if self.m.device.type == "cuda":
            return [a.elapsed_time(b) for a, b in self.events]
        return [(b - a) * 1e3 for a, b in self.events]
