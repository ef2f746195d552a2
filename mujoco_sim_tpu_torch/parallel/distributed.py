"""Multi-process scaffolding: torch.distributed and the global env mesh
(port of mujoco_sim_tpu/parallel/distributed.py).

The reference's only distribution story is N sim processes talking ROS
(SURVEY §2.5).  Here the processes form one env mesh: each process drives
its own devices and holds only its own shards of the batch, and the ring
exchange (parallel/mesh.exchange_body_state) crosses processes by
point-to-point sends.  The backend follows the device, with no fallback
from one to the other: NCCL for CUDA, gloo for the CPU.  NCCL forms no
communicator with two processes on one device, so one card runs one
NCCL process; the multi-process path is proven with gloo on the CPU
(tests/test_torch_distributed.py), as the JAX package proves its own
with CPU processes.
"""

from __future__ import annotations

import datetime
import os

import torch

from mujoco_sim_tpu_torch.parallel import mesh as pmesh
from mujoco_sim_tpu_torch.utils.struct import map_leaves


def _dist():
    import torch.distributed as dist

    return dist


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda",
               timeout: float = 600.0):
    """Join the process group (nothing to do for one process without a
    coordinator).

    coordinator is "host:port" of rank 0's TCP store.  Without arguments,
    torchrun's RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT are read when
    set, as the JAX function auto-detects its cluster.  device "cuda"
    (NCCL; each process takes card rank % device_count) or "cpu" (gloo);
    "cuda" raises without a CUDA device.  timeout (s) bounds every
    collective, so a lost peer fails instead of hanging."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: no CUDA device; pass "
                               "device=\"cpu\" for gloo on the CPU")
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"initialize: unsupported device {device}")
    dist = _dist()
    if dist.is_initialized():
        return
    env = os.environ
    if (coordinator is None and num_processes is None
            and "RANK" in env and "WORLD_SIZE" in env):
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
        coordinator = (f"{env.get('MASTER_ADDR', 'localhost')}:"
                       f"{env['MASTER_PORT']}")
    if coordinator is None:
        if num_processes not in (None, 1):
            raise ValueError("initialize: several processes need a "
                             "coordinator")
        return
    num_processes = 1 if num_processes is None else num_processes
    process_id = 0 if process_id is None else process_id
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method="tcp://" + coordinator,
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))


def global_env_mesh(axis: str = "env", local_devices=None) -> pmesh.EnvMesh:
    """Mesh over the devices of every process, in rank order; this
    process holds the shards of its own devices.  local_devices defaults
    to [cuda:(rank % device_count)] under NCCL and ["cpu"] under gloo;
    every process must name as many.  Without a process group: the mesh
    of make_env_mesh(local_devices)."""
    dist = _dist()
    if not dist.is_initialized():
        return pmesh.make_env_mesh(local_devices, axis)
    rank, world = dist.get_rank(), dist.get_world_size()
    if local_devices is None:
        local_devices = (
            [torch.device("cuda", rank % torch.cuda.device_count())]
            if dist.get_backend() == "nccl" else ["cpu"])
    local = [str(pmesh._device(d)) for d in local_devices]
    every = [None] * world
    dist.all_gather_object(every, local)
    if any(len(x) != len(local) for x in every):
        raise ValueError(f"processes hold unequal device counts: {every}")
    devices = tuple(torch.device(d) for x in every for d in x)
    return pmesh.EnvMesh(devices, axis, group=dist.group.WORLD, rank=rank,
                         world=world)


def host_local_batch(make_env_state, nenv_global: int,
                     mesh: pmesh.EnvMesh) -> pmesh.Sharded:
    """This process's shards of a global batch, built from its own envs
    only: make_env_state(global env index) -> one env's Data (leaves with
    a leading env axis of 1); envs [rank * local, (rank + 1) * local) are
    stacked and split over this process's shards."""
    if nenv_global % mesh.size:
        raise ValueError("env count must divide the mesh")
    local = nenv_global // mesh.world
    start = mesh.rank * local
    states = [make_env_state(start + i) for i in range(local)]
    stacked = map_leaves(lambda *xs: torch.cat(xs), *states)
    return pmesh.shard_batch(stacked, mesh)
