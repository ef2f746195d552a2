"""StepGraph: the port's counterpart of ``jax.jit`` for a step function.

The JAX package jits its step at every entry point and runs the step's
data-dependent loops as ``lax.while_loop``s on the device.  Eager PyTorch
pays the host's launch cost for each of a step's thousands of kernels, and
a host sync for each loop iteration.  ``StepGraph(fn)`` captures
``fn(m, *xs)`` (``engine.step``, ``engine.forward``, a controlled step, a
rollout's step with its ``ctrl_fn``) once as a CUDA graph and replays it:

* warm-up: one eager call on the graph's own input buffers first, so the
  kernels are built (ops/cuda_build.load) and the plan caches filled
  before the capture; then the caching allocator's free blocks are given
  back to the card (``empty_cache``), since the capture's private pool
  cannot reuse them;
* capture: on a side stream in thread-local mode (the server captures on
  its sim thread while asyncio runs), through ops/loops.capture, which
  puts the allocations of the loop bodies (conditional WHILE nodes, no
  host sync) in the graph's pool;
* inputs: each xs is copied into static buffers on every call (``copy_``).
  Of a Data, only the leaves a step reads are copied (parallel/rollout.
  RECURRENT: the state, the controls, the masks and the spawn-time
  overrides); its other leaves keep the first call's values, which the
  step never reads.  ``all_leaves=True`` copies every leaf (the
  profiler's stages read derived leaves);
* outputs: ``__call__`` returns fn's result with every tensor the graph
  wrote cloned, so the next replay overwrites nothing a caller holds (the
  immutability JAX gives); a leaf fn passed through untouched is the
  caller's own tensor, as with the eager function.  The graph ends by
  copying its outputs back into its inputs (the result matched to xs), so
  ``run(m, *xs, n=n)`` replays n steps in place and clones once at the
  end; with ``record``, each replay also writes ``record(result)`` into
  its row of a trajectory buffer (a device counter picks the row);
* a model is read by the addresses of its tensors, so a capture is keyed
  on the model object (and the inputs' shapes, dtypes and devices): a new
  model (``SimLoop._set_dt``'s new timestep, a hot swap) gets a capture of
  its own and never reads a stale one.  It is also keyed on what the
  recorder (runtime/profiler) records on the inputs' device, since a
  capture made while it counts or traces holds its count and stamp
  nodes and one made while it is off holds none.  The last ``keep``
  captures are kept;
* spans (runtime/profiler, while tracing): ``graph.load`` (the copy-in,
  with its ``bytes``), ``graph.replay`` (one a replay: the graph launch)
  and ``graph.result`` (the clones, with their ``bytes``); and, whether
  or not tracing is on, ``graph.capture`` (its children ``warm`` and
  ``capture``, with the ``pool_bytes`` the capture's pool reserved).

On a CPU model the same static-buffer code runs with no capture, so the
CPU tests exercise everything but the graph itself.  On a CUDA model a
failed capture raises; there is no eager fallback.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref

import torch

from mujoco_sim_tpu_torch.ops import loops
from mujoco_sim_tpu_torch.runtime import profiler
from mujoco_sim_tpu_torch.utils.struct import leaf_names

_ALL = weakref.WeakSet()
# the StepGraphs of the module-level entry points (rollout, rollout_traj,
# step_with_control...), one per (kind, function), the last _KEEP kept
_CACHE: collections.OrderedDict = collections.OrderedDict()
_KEEP = 8


def clear_all():
    """Drop every StepGraph's captures (and with them their pools)."""
    _CACHE.clear()
    for g in list(_ALL):
        g.clear()


def cached(kind: str, fn, make) -> "StepGraph":
    """The StepGraph ``make()`` of entry point ``kind`` for ``fn`` (a
    ctrl_fn, an extract, a step function; None included), made once and
    kept while it is among the last few used, as a jit cache keeps the
    programs of the functions it has seen."""
    key = (kind, id(fn))
    hit = _CACHE.get(key)
    if hit is None or hit[0] is not fn:
        hit = _CACHE[key] = (fn, make())
        while len(_CACHE) > _KEEP:
            _CACHE.popitem(last=False)
    else:
        _CACHE.move_to_end(key)
    return hit[1]


def _flatten(x, path=()):
    """(leaves as (path, tensor) pairs, rebuild(iterator of tensors)) of a
    tensor, a frozen container (Data, Contact, PDState...) or a tuple,
    list or dict of those; anything else is a constant with no leaves."""
    if isinstance(x, torch.Tensor):
        return [(path, x)], lambda it: next(it)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = list(leaf_names(x))
        subs = [_flatten(getattr(x, n), path + (n,)) for n in names]

        def rebuild(it):
            return dataclasses.replace(
                x, **{n: s[1](it) for n, s in zip(names, subs)})
        return [lf for s in subs for lf in s[0]], rebuild
    if isinstance(x, (tuple, list)):
        subs = [_flatten(v, path + (i,)) for i, v in enumerate(x)]
        return ([lf for s in subs for lf in s[0]],
                lambda it: type(x)(s[1](it) for s in subs))
    if isinstance(x, dict):
        keys = list(x)
        subs = [_flatten(x[k], path + (k,)) for k in keys]
        return ([lf for s in subs for lf in s[0]],
                lambda it: {k: s[1](it) for k, s in zip(keys, subs)})
    return [], lambda it: x


def _recurrent():
    from mujoco_sim_tpu_torch.parallel.rollout import RECURRENT
    return frozenset(RECURRENT)


class _Capture:
    """One capture of a StepGraph: its model, static inputs, graph and
    outputs."""

    def __init__(self, g: "StepGraph", m, xs: tuple, rows: int):
        from mujoco_sim_tpu_torch.models.model import Data
        self.g, self.m, self.rows = g, m, rows
        leaves, rebuild = _flatten(xs)
        self.static = [t.detach().clone() for _, t in leaves]
        self.xs = rebuild(iter(self.static))
        self.index = {id(t): i for i, t in enumerate(self.static)}
        rec = None if g.all_leaves else _recurrent()
        self.inputs = [
            i for i, (path, _) in enumerate(leaves)
            if rec is None or not isinstance(xs[path[0]], Data)
            or path[1] in rec]
        self.input_set = frozenset(self.inputs)
        self.paths = {path: i for i, (path, _) in enumerate(leaves)}
        self.row = None
        self.bufs = None
        dev = self.static[0].device
        self.device = dev
        self.graph = None
        if rows:
            self.row = torch.zeros(1, dtype=torch.long, device=dev)
        if dev.type != "cuda":
            return
        with profiler.span("graph.capture", always=True) as sp:
            self._warm_and_capture(dev, sp)

    def _warm_and_capture(self, dev, sp=None):
        """The warm-up call, then the capture, on a CUDA device; ``sp``
        the capture's span, given the pool's bytes."""
        with torch.cuda.device(dev):
            with profiler.span("warm", always=True):
                warm = self.g.fn(self.m, *self.xs)   # builds, caches
                if self.rows:
                    # the trajectory buffers outlive a replay, so they are
                    # made outside the capture: a block the capture hands
                    # out may be one it freed earlier in the step, which
                    # the next replay writes again
                    self._make_bufs(warm)
                del warm
                torch.cuda.synchronize(dev)
                # the warm-up's freed blocks go back to the card: the
                # capture's private pool cannot reuse them, so, kept in the
                # cache, they would double the step's footprint (manip_bin6
                # at 65 536 envs: ~30 GB more, 76.8 of the card's 80 GB
                # reserved)
                torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            with profiler.span("capture", always=True):
                self.graph = torch.cuda.CUDAGraph()
                with loops.capture(self.graph, dev):
                    self.out = self._body()
                self.out_flat = _flatten(self.out)
                torch.cuda.synchronize(dev)
            if sp is not None:
                sp.attrs["pool_bytes"] = (torch.cuda.memory_reserved(dev)
                                          - reserved)

    def _body(self):
        """fn on the static inputs, its results copied back into them, and
        the trajectory row written: what the graph holds."""
        out = self.g.fn(self.m, *self.xs)
        mine = out if len(self.xs) > 1 else (out,)
        for path, o in _flatten(mine)[0]:
            i = self.paths.get(path)
            if i in self.input_set and o is not self.static[i]:
                self.static[i].copy_(o)
        if self.rows:
            if self.bufs is None:
                self._make_bufs(out)
            rl, _ = _flatten(self.g.record(out))
            for b, (_, x) in zip(self.bufs, rl):
                b.index_copy_(0, self.row, x.unsqueeze(0))
            self.row.add_(1)
        return out

    def _make_bufs(self, out):
        rl, self.rec_rebuild = _flatten(self.g.record(out))
        self.bufs = [torch.empty((self.rows,) + tuple(x.shape),
                                 dtype=x.dtype, device=x.device)
                     for _, x in rl]

    def load(self, xs):
        with profiler.span("graph.load") as sp:
            leaves, _ = _flatten(xs)
            copied = [i for i in self.inputs
                      if leaves[i][1] is not self.static[i]]
            for i in copied:
                self.static[i].copy_(leaves[i][1])
            if sp is not None:
                sp.attrs["bytes"] = sum(leaves[i][1].nbytes for i in copied)

    def replay(self):
        with profiler.span("graph.replay"):
            if self.graph is not None:
                self.graph.replay()
            else:
                self.out = self._body()
                self.out_flat = _flatten(self.out)
        self.g.replays += 1

    def result(self, xs):
        """fn's result: a tensor the graph wrote is cloned (once, if it
        appears twice); an input buffer stands for the caller's tensor."""
        with profiler.span("graph.result") as sp:
            caller = [t for _, t in _flatten(xs)[0]]
            leaves, rebuild = self.out_flat
            made = {}
            new = []
            for _, o in leaves:
                k = id(o)
                if k not in made:
                    i = self.index.get(k)
                    made[k] = caller[i] if i is not None else o.clone()
                new.append(made[k])
            if sp is not None:
                sp.attrs["bytes"] = sum(t.nbytes for k, t in made.items()
                                        if k not in self.index)
            return rebuild(iter(new))

    def records(self):
        """The trajectory buffers' record of the run, cloned."""
        with profiler.span("graph.result") as sp:
            if sp is not None:
                sp.attrs["bytes"] = sum(b.nbytes for b in self.bufs)
            return self.rec_rebuild(iter([b.clone() for b in self.bufs]))


class StepGraph:
    """``jax.jit(fn)`` for a step function ``fn(m, *xs)``: see the module
    docstring.  ``record(result)`` (optional) names the tensors ``run``
    stacks over its steps.  ``replays`` counts replays (a CPU model's
    static-buffer runs included) and ``captures`` the captures made."""

    def __init__(self, fn, *, all_leaves: bool = False, record=None,
                 keep: int = 1):
        self.fn = fn
        self.all_leaves = all_leaves
        self.record = record
        self.keep = keep
        self.replays = 0
        self.captures = 0
        self._caps: collections.OrderedDict = collections.OrderedDict()
        _ALL.add(self)

    def clear(self):
        self._caps.clear()

    @property
    def last(self) -> _Capture | None:
        """The capture used last."""
        return next(reversed(self._caps.values()), None)

    def _capture(self, m, xs: tuple, rows: int) -> _Capture:
        leaves, _ = _flatten(xs)
        key = (id(m), rows, profiler.mode(leaves[0][1].device),
               tuple(type(x) for x in xs),
               tuple((p, tuple(t.shape), t.dtype, t.device)
                     for p, t in leaves))
        cap = self._caps.get(key)
        if cap is None or cap.m is not m:
            cap = _Capture(self, m, xs, rows)
            self.captures += 1
            self._caps[key] = cap
            while len(self._caps) > self.keep:
                self._caps.popitem(last=False)
        else:
            self._caps.move_to_end(key)
        return cap

    def __call__(self, m, *xs):
        """One replay of fn(m, *xs); returns its result."""
        cap = self._capture(m, xs, 0)
        cap.load(xs)
        cap.replay()
        return cap.result(xs)

    def run(self, m, *xs, n: int):
        """n replays, each starting from the last one's result (fn's
        result must match xs); returns the final result, and with
        ``record`` also the record of every step, stacked on a leading
        [n] axis."""
        if n < 1:
            raise ValueError(f"StepGraph.run: n={n} must be at least 1")
        cap = self._capture(m, xs, n if self.record else 0)
        cap.load(xs)
        if cap.row is not None:
            cap.row.zero_()
        for _ in range(n):
            cap.replay()
        out = cap.result(xs)
        if not self.record:
            return out
        return out, cap.records()
