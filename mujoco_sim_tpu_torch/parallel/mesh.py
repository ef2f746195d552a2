"""Env-axis parallelism over a list of devices (port of
mujoco_sim_tpu/parallel/mesh.py).

The JAX package shards the env axis of one global array over a
``jax.sharding.Mesh`` and runs one jitted program over it.  PyTorch has no
single-controller global array (``DTensor`` needs a process per device),
so here a mesh is an ordered list of devices (``EnvMesh``), a sharded
batch is one ``Data`` per shard, in env order, each on its shard's device
(``Sharded``), and a sharded step or rollout steps each shard on its own
device.  Every loop of the step is masked per env and every solve is per
system, so a shard steps as its envs do inside the whole batch.

A device may repeat: ``make_env_mesh(["cuda:0"] * 4)`` splits a batch in
four on one card, as the JAX package's tests split one over eight virtual
CPU devices.  Under parallel/distributed.py the mesh spans the devices of
every process, a process holds only its own shards, and the ring exchange
crosses processes with point-to-point sends.

``batched_step`` and ``rollout``, the single-device part, live in
parallel/rollout.py and are re-exported here.  Every step here runs
through utils/graph.StepGraph, as the JAX package jits its sharded step
and rollout: one graph per shard (each shard has its own input buffers and
pool), and ``rollout_traj`` writes each step's observation into its row
of a trajectory buffer inside the graph.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.model import Model, Data
from mujoco_sim_tpu_torch.parallel.rollout import (  # noqa: F401
    _carry, batched_step, rollout,
)
from mujoco_sim_tpu_torch.runtime import profiler
from mujoco_sim_tpu_torch.utils import graph
from mujoco_sim_tpu_torch.utils.struct import map_leaves


@dataclasses.dataclass(frozen=True)
class EnvMesh:
    """The port's counterpart of a one-axis ``jax.sharding.Mesh``.

    ``devices`` holds one device per shard, in env order, over every
    process; this process holds shards ``local`` (all of them unless the
    mesh came from distributed.global_env_mesh).  ``group`` is the
    torch.distributed process group joining the processes, or None."""

    devices: tuple
    axis: str = "env"
    group: object = None
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> range:
        per = self.size // self.world
        return range(self.rank * per, (self.rank + 1) * per)

    @property
    def local_devices(self) -> tuple:
        return tuple(self.devices[i] for i in self.local)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", 0)
    return d


def make_env_mesh(devices=None, axis: str = "env") -> EnvMesh:
    """Mesh over ``devices`` (every CUDA device when None; without one it
    raises, it never falls back to the CPU).  A device may repeat."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_env_mesh: no CUDA device; name the devices to run "
                "elsewhere (e.g. [\"cpu\"] * 8)")
        devices = range(torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in devices]
    devices = tuple(_device(d) for d in devices)
    if not devices:
        raise ValueError("make_env_mesh: no devices")
    return EnvMesh(devices, axis)


class Replicas:
    """One copy of a model on each distinct device of a mesh:
    ``on(dev)``."""

    def __init__(self, by_device: dict):
        self.by_device = by_device

    def on(self, device) -> Model:
        return self.by_device[_device(device)]


def replicate_model(m: Model, mesh: EnvMesh) -> Replicas:
    """The model on each of this process's mesh devices.  Each copy goes
    through engine.put_model, so its layout's index tensors and memoised
    plans live on its own device (moving leaves alone would leave the
    plans on the first).  m is a model on some device (put_model's)."""
    by_device = {}
    for dev in mesh.local_devices:
        if dev not in by_device:
            by_device[dev] = (m if m.device == dev
                              else engine.put_model(m, m.dtype, dev))
    return Replicas(by_device)


def _model_for(m, dev) -> Model:
    if isinstance(m, Replicas):
        return m.on(dev)
    if m.device != dev:
        raise ValueError(f"the model is on {m.device} and a shard on {dev}: "
                         "pass replicate_model(m, mesh)")
    return m


def _on(dev):
    """Make a CUDA shard's device current while it steps."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _cat(values, device):
    if dataclasses.is_dataclass(values[0]):
        return map_leaves(lambda *xs: _cat(xs, device), *values)
    return torch.cat([v.to(device) for v in values])


class Sharded:
    """A batch split over a mesh: ``shards[i]`` (a Data, or a tensor with
    the env axis first) lives on ``mesh.local_devices[i]``, in env order.
    A process holds only its own shards.

    ``gather()`` concatenates them into one Data (or tensor) on one
    device, as a sharded jax.Array reads whole."""

    def __init__(self, shards, mesh: EnvMesh):
        if len(shards) != len(mesh.local):
            raise ValueError(f"{len(shards)} shards for the "
                             f"{len(mesh.local)} of this process")
        self.shards = tuple(shards)
        self.mesh = mesh

    def gather(self, device=None):
        device = self.mesh.local_devices[0] if device is None else device
        return _cat(self.shards, device)


def shard_batch(dB: Data, mesh: EnvMesh) -> Sharded:
    """Split a batch (this process's envs) into equal shards in env order,
    each copied to its device."""
    n = dB.qpos.shape[0]
    per, rem = divmod(n, len(mesh.local))
    if rem:
        raise ValueError(f"{n} envs do not split over "
                         f"{len(mesh.local)} shards")
    return Sharded([
        map_leaves(lambda x: x[i * per:(i + 1) * per].to(dev, copy=True), dB)
        for i, dev in enumerate(mesh.local_devices)], mesh)


def make_batch(m: Model, nenv: int, mesh: EnvMesh | None = None,
               dtype=None):
    """Fresh batched Data of ``nenv`` envs; with a mesh, a Sharded batch of
    this process's shards, every leaf split along the env axis (all leaves
    of the port's Data carry it)."""
    if mesh is None:
        return engine.make_data(m, nenv, dtype)
    if nenv % mesh.size:
        raise ValueError(f"{nenv} envs do not split over {mesh.size} shards")
    per = nenv // mesh.size
    shards = []
    for dev in mesh.local_devices:
        base = m.on(dev) if isinstance(m, Replicas) else m
        shards.append(map_leaves(lambda x: x.to(dev),
                                 engine.make_data(base, per, dtype)))
    return Sharded(shards, mesh)


def _flatten(tree):
    """Leaves of a tensor, or of a tuple/list/dict of tensors, and the
    function that rebuilds the tree from new leaves."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda xs: xs[0]
    if isinstance(tree, dict):
        keys = list(tree)
        return [tree[k] for k in keys], lambda xs: dict(zip(keys, xs))
    if isinstance(tree, (tuple, list)):
        return list(tree), lambda xs: type(tree)(xs)
    raise TypeError(f"extract must return tensors, got {type(tree)}")


def _qpos(d):
    return d.qpos


def traj_graph(extract=None) -> graph.StepGraph:
    """A StepGraph of the batched step that records extract(d) (default
    qpos) after every step; rollout_traj takes one per shard."""
    return graph.StepGraph(engine.step, record=extract or _qpos, keep=2)


def rollout_traj(m: Model, dB: Data, nsteps: int, extract=None,
                 step_graph: graph.StepGraph | None = None):
    """Rollout that also stacks per-step observations on the device.

    extract(d) -> a tensor (or a tuple/list/dict of tensors) of the state
    after a step; default qpos.  Returns (final Data, trajectory with a
    leading [nsteps] axis).  As in the JAX package, the last entry is the
    final full step's, and nsteps <= 1 takes one step.  step_graph: the
    traj_graph(extract) to replay (a cached one when None)."""
    g = step_graph or graph.cached("traj", extract,
                                   lambda: traj_graph(extract))
    return g.run(m, dB, n=max(1, nsteps))


def scan_reduced(step_fn, init, nsteps: int):
    """``nsteps`` applications of ``step_fn`` to a carry, through one
    StepGraph of step_fn (its result must have the carry's structure).

    The JAX version prunes the carry to the leaves step_fn reads and
    returns the others stale; here every leaf of the result is fresh (a
    Data carry passes its RECURRENT leaves from step to step)."""
    if nsteps <= 0:
        return init
    g = graph.cached("scan", step_fn,
                     lambda: graph.StepGraph(lambda _, c: step_fn(c)))
    with profiler.span("mesh.scan_reduced", init):
        return g.run(None, init, n=nsteps)


def _check(dS: Sharded, mesh: EnvMesh):
    if not isinstance(dS, Sharded) or dS.mesh.local_devices != \
            mesh.local_devices:
        raise ValueError("the batch is not sharded over this mesh: "
                         "make_batch(m, nenv, mesh) or shard_batch(d, mesh)")


def _per_shard(mesh: EnvMesh, fn):
    """Callable (m, dS) -> dS applying fn(graph, model, shard) to each
    shard on its device, in turn, with a StepGraph of the step for each
    shard (m from replicate_model, or a Model on the shards' one
    device)."""
    graphs = [graph.StepGraph(engine.step) for _ in mesh.local]

    def run(m_, dS: Sharded) -> Sharded:
        _check(dS, mesh)
        out = []
        for g, dev, d in zip(graphs, mesh.local_devices, dS.shards):
            with _on(dev):
                out.append(fn(g, _model_for(m_, dev), d))
        return Sharded(out, mesh)

    run.graphs = graphs
    return run


def make_sharded_step(m: Model, mesh: EnvMesh):
    """Callable (m, dS) -> dS: one batched step of each shard."""
    return _per_shard(mesh, lambda g, m_, d: g(m_, d))


def make_sharded_rollout(m: Model, mesh: EnvMesh, nsteps: int):
    """Callable (m, dS) -> dS: ``nsteps`` steps of each shard, carrying the
    recurrent leaves as parallel/rollout.rollout does."""
    if nsteps <= 0:
        return _per_shard(mesh, lambda g, m_, d: d)
    return _per_shard(mesh, lambda g, m_, d: g.run(m_, d, n=nsteps))


def _ring_p2p(pos, quat, mesh: EnvMesh, device):
    """Send this process's last block to the next process and receive the
    previous process's (NCCL for CUDA tensors, gloo for CPU ones)."""
    import torch.distributed as dist

    nxt = (mesh.rank + 1) % mesh.world
    prv = (mesh.rank - 1) % mesh.world
    send = [x.to(device).contiguous() for x in (pos, quat)]
    recv = [torch.empty_like(x) for x in send]
    ops = ([dist.P2POp(dist.isend, x, nxt, mesh.group) for x in send]
           + [dist.P2POp(dist.irecv, x, prv, mesh.group) for x in recv])
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return recv


def exchange_body_state(dS: Sharded, mesh: EnvMesh, body_id: int):
    """Multi-instance send/receive coupling: each shard receives the pose
    of ``body_id`` of the previous shard's envs, around the ring (the
    reference's '_ref' mocap-weld sync over sockets, mj_sim.cpp:847-960).

    The JAX version permutes whole device blocks (ppermute of shard i to
    shard i + 1), so with nenv envs over n shards env e receives env
    (e - nenv / n) mod nenv; this does the same.  Returns (pos, quat) as
    Sharded tensors aligned with the batch."""
    _check(dS, mesh)
    devs = mesh.local_devices
    pos = [d.xpos[:, body_id] for d in dS.shards]
    quat = [d.xquat[:, body_id] for d in dS.shards]
    got_pos = [None] + [pos[i - 1].to(devs[i], copy=True)
                        for i in range(1, len(devs))]
    got_quat = [None] + [quat[i - 1].to(devs[i], copy=True)
                         for i in range(1, len(devs))]
    # one process: its own last block comes back to it, through NCCL on
    # the card (gloo sends to no rank of its own)
    if mesh.group is None or (mesh.world == 1 and devs[0].type != "cuda"):
        got_pos[0] = pos[-1].to(devs[0], copy=True)
        got_quat[0] = quat[-1].to(devs[0], copy=True)
    else:
        got_pos[0], got_quat[0] = _ring_p2p(pos[-1], quat[-1], mesh,
                                            devs[0])
    return Sharded(got_pos, mesh), Sharded(got_quat, mesh)
