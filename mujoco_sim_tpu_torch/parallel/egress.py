"""Trajectory egress with device-to-host overlap (port of
mujoco_sim_tpu/parallel/egress.py).

A rollout runs in chunks.  A chunk is ``chunk`` replays of one shard's
step graph (parallel/mesh.traj_graph: each replay writes its step's row
of the chunk's trajectory buffer on the card, with no host sync).  After
each chunk the compute stream records an event; a copy stream of the same
device waits on it and copies the chunk into one of two pinned host
buffers, without blocking.  The host goes on to dispatch chunk k+1 and
waits on chunk k's copy only before it reads it out, so the copies
overlap the next chunk's compute.  The JAX package gets the same overlap
from async dispatch and ``copy_to_host_async``.

A process holds only its own shards (parallel/mesh.py), so it egresses
only them, shard by shard into the env columns they hold.
"""

from __future__ import annotations

import numpy as np
import torch

from mujoco_sim_tpu_torch.models.model import Model, Data
from mujoco_sim_tpu_torch.parallel import mesh as pmesh
from mujoco_sim_tpu_torch.runtime import profiler


class _Egress:
    """Device-to-host copies of shard ``shard``'s chunks: a copy stream of
    its device (shared by the shards on that device) and two pinned
    buffers per leaf of its own, on a CUDA device; plain copies on the
    CPU."""

    def __init__(self, shard, dev, cache):
        self.shard = shard
        self.dev = dev
        self.cuda = dev.type == "cuda"
        self.cache = cache
        self.pending = {}
        if self.cuda:
            key = ("copy_stream", dev)
            if key not in cache:
                cache[key] = torch.cuda.Stream(dev)
            self.stream = cache[key]

    def start(self, k, leaves):
        if not self.cuda:
            self.pending[k] = [x.numpy() for x in leaves]
            return
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.dev))
        self.stream.wait_event(done)
        bufs = []
        with torch.cuda.stream(self.stream):
            for j, x in enumerate(leaves):
                key = ("pinned", self.shard, j, k % 2, tuple(x.shape),
                       x.dtype)
                buf = self.cache.get(key)
                if buf is None:
                    buf = torch.empty(x.shape, dtype=x.dtype,
                                      pin_memory=True)
                    self.cache[key] = buf
                buf.copy_(x, non_blocking=True)
                # the compute stream's allocator must not hand x's memory
                # to a new tensor before this copy has read it
                x.record_stream(self.stream)
                bufs.append(buf)
        copied = torch.cuda.Event()
        copied.record(self.stream)
        self.pending[k] = (copied, bufs)

    def finish(self, k, out, rows, cols):
        """Wait for chunk k's copy and write it into ``out`` (one host
        array per leaf) at [rows, cols]."""
        got = self.pending.pop(k)
        if self.cuda:
            copied, bufs = got
            copied.synchronize()
            got = [b.numpy() for b in bufs]
        for o, g in zip(out, got):
            o[rows, cols] = g


def rollout_collect(m: Model, dB: Data, nsteps: int, chunk: int = 64,
                    extract=None, jit_cache: dict | None = None):
    """Rollout ``nsteps`` collecting extract(d) per step (default qpos),
    overlapping the device-to-host trajectory copies with the next chunk's
    compute.

    dB is a Data (m a Model on its device) or a Sharded batch (m from
    replicate_model).  Returns (final Data or Sharded, host trajectory:
    a numpy array, or a tuple/list/dict of them, stacked over steps, with
    this process's envs in env order).  jit_cache, when given, keeps the
    shards' step graphs, the copy streams and the pinned buffers for the
    next call.  While tracing (runtime/profiler), each chunk's read-out
    (the wait on its copies and the copy out of the pinned buffers) is a
    span ``egress.read``."""
    extract = extract or pmesh._qpos
    nchunks, rem = divmod(nsteps, chunk)
    if rem:
        raise ValueError(f"nsteps={nsteps} not a multiple of chunk={chunk}")
    cache = {} if jit_cache is None else jit_cache
    sharded = isinstance(dB, pmesh.Sharded)
    shards = list(dB.shards) if sharded else [dB]
    devs = dB.mesh.local_devices if sharded else (dB.qpos.device,)
    models = [pmesh._model_for(m, dev) for dev in devs]
    egress = [_Egress(i, dev, cache) for i, dev in enumerate(devs)]
    graphs = []
    for i in range(len(devs)):
        key = ("graph", i, extract)
        if key not in cache:
            cache[key] = pmesh.traj_graph(extract)
        graphs.append(cache[key])
    out, rebuild, cols = None, None, []

    def read(k):
        with profiler.span("egress.read"):
            for e, c in zip(egress, cols):
                e.finish(k, out, slice(k * chunk, (k + 1) * chunk), c)

    for k in range(nchunks):
        for i, (dev, mi) in enumerate(zip(devs, models)):
            with pmesh._on(dev):
                shards[i], traj = pmesh.rollout_traj(
                    mi, shards[i], chunk, extract, graphs[i])
            leaves, rebuild = pmesh._flatten(traj)
            if k == 0:
                start = cols[-1].stop if cols else 0
                cols.append(slice(start, start + leaves[0].shape[1]))
                if i == len(devs) - 1:
                    out = [np.empty((nsteps, cols[-1].stop) + x.shape[2:],
                                    dtype=_np_dtype(x.dtype))
                           for x in leaves]
            egress[i].start(k, leaves)
        if k:
            read(k - 1)        # chunk k is dispatched: now read chunk k-1
    read(nchunks - 1)
    final = pmesh.Sharded(shards, dB.mesh) if sharded else shards[0]
    return final, rebuild(out)


def _np_dtype(t: torch.dtype):
    return torch.empty((), dtype=t).numpy().dtype
