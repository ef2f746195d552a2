"""Frozen copy of mujoco_sim_tpu_torch's CPU path for the benchmark's
plain reference (bench_port/refsim): imports rewritten, CUDA wrappers
and graph capture removed.  Do not import the program from here.

Data-dependent loops of the step: ``lax.while_loop`` under ``vmap``.

Port of the JAX package's batched while loops (ops/solver.py's Newton,
line-search and bracket loops, ops/gjk.py's GJK loop).  Under ``vmap`` a
``lax.while_loop`` runs its body for every env while ANY env's predicate
holds and keeps the carry of envs whose predicate is false; XLA reduces
the predicate on the device and branches there.  ``while_loop`` does the
same on one carry of tensors with a leading env axis:

* on a CPU tensor, and on the card outside a capture, a Python loop whose
  exit test reads ``mask.any()`` (one host sync an iteration on the card);
* inside a CUDA-graph capture (utils/graph.StepGraph) one conditional
  WHILE node of the graph, whose predicate the hand-written kernel of
  csrc/graph_loop.cu reduces on the card: no host sync, and a replay runs
  as many iterations as the data needs.  Loops nest (the line search
  inside a Newton iteration): each depth captures its body on a stream of
  its own.

Either way the body writes the new carry into the carry's own tensors
(``copy_`` of ``where(active, new, old)``), because a node's body replays
at fixed addresses; the CPU path runs the same in-place body, so the CPU
tests exercise it.  Finished envs may compute garbage (even NaN) in the
discarded branch: ``torch.where`` selects and never multiplies by a mask.

A capture must route the allocations of the loop bodies, which run on
the body streams, into the graph's memory pool: ``capture`` (used by
StepGraph) does that, and ``while_loop`` refuses a capture it did not
open.  ``LAUNCHES`` counts the predicate kernel's launches (two a node:
one before it, one at the end of its body), and nothing else; the counts
kept on the card (cuda_build.count_launch) add one a replay for the
first and one an iteration for the second.
"""

from __future__ import annotations

import threading

import torch


MAX_DEPTH = 3          # nesting depth of loops inside one capture



def any_plain(mask: torch.Tensor) -> torch.Tensor:
    """The predicate's reduction as plain PyTorch: any env still running."""
    return mask.any()



def _select(active: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    a = active.reshape(active.shape + (1,) * (old.dim() - active.dim()))
    return torch.where(a, new, old)


def _iterate(cond_fn, body_fn, carry, active):
    """One masked iteration, in place: carry = where(active, body(carry),
    carry); active = cond(carry)."""
    new = body_fn(carry)
    for c, n in zip(carry, new):
        c.copy_(_select(active, n, c))
    active.copy_(cond_fn(carry))


def while_loop(cond_fn, body_fn, carry):
    """``jax.vmap(lambda c: lax.while_loop(cond_fn, body_fn, c))`` on a
    batched carry.

    carry: tuple of tensors whose leading axes are the env axes (every
    carry tensor starts with the shape of cond_fn's mask).  cond_fn(carry)
    -> bool mask over the env axes; body_fn(carry) -> the new carry (same
    shapes and dtypes).  Returns the final carry, a tuple of tensors the
    loop owns (the caller's tensors are not written)."""
    carry = tuple(c.clone() for c in carry)
    active = cond_fn(carry).clone()
    while bool(active.any()):
        _iterate(cond_fn, body_fn, carry, active)
    return carry


