"""The program's ``parallel/mesh.scan_reduced(step, carry, n)``: the
law's whole controlled step (controllers included) captured as one CUDA
graph over the carry, replayed n times in place."""

from __future__ import annotations


class Entry:
    sync_each_segment = True

    def __init__(self, P, m, law, bufs, p):
        self.P = P
        self.step = law.step(P, m, bufs, p)

    def segment(self, carry, n: int):
        return self.P.mesh.scan_reduced(self.step, carry, n)
