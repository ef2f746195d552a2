"""The recorder's stage stamp (runtime/profiler.py): hand-written CUDA
kernel + twin.

Replaces no TPU kernel: csrc/trace_stamp.cu writes the card's
``%globaltimer`` into a slot of the ring row that the recorder's table
names (its step count, read on the card, so each replay of a captured
step writes its own row) and adds one to its own launch count there.  On
a CPU ring the plain twin ``stamp_plain`` writes the host time it is
given.  ``LAUNCHES`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mujoco_sim_tpu_torch.ops import cuda_build

LAUNCHES = 0

SOURCE = cuda_build.source_path("trace_stamp")


def stamp_plain(ring: torch.Tensor, table: torch.Tensor, slot: int,
                step_slot: int, now_ns: int, count_slot: int | None = None):
    """ring[table[step_slot] % rows, slot] = now_ns, on CPU tensors, and,
    as the kernel does, one added to table[count_slot] where it is
    given."""
    ring[int(table[step_slot]) % ring.shape[0], slot] = now_ns
    if count_slot is not None:
        table[count_slot] += 1


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = cuda_build.load("trace_stamp")
    lib.trace_stamp.restype = ctypes.c_int
    lib.trace_stamp.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def stamp_cuda(ring: torch.Tensor, table: torch.Tensor, slot: int,
               step_slot: int, count_slot: int):
    """Launch the kernel: ring (rows, slots) and table (n,), int64,
    contiguous, on one CUDA device."""
    global LAUNCHES
    for name, t in (("ring", ring), ("table", table)):
        if (not t.is_cuda or t.dtype != torch.int64
                or not t.is_contiguous() or t.device != ring.device):
            raise ValueError(f"stamp_cuda: {name} must be int64, "
                             f"contiguous, on ring's CUDA device")
    rows, slots = ring.shape
    if not (0 <= slot < slots and 0 <= step_slot < table.numel()
            and 0 <= count_slot < table.numel()):
        raise ValueError(f"stamp_cuda: slot {slot}, step {step_slot} or "
                         f"count {count_slot} out of range")
    rc = cuda_build.launch(ring.device, _load().trace_stamp, ring.data_ptr(),
                           table.data_ptr(), rows, slots, slot, step_slot,
                           count_slot)
    if rc != 0:
        raise RuntimeError(f"trace_stamp kernel launch failed: cudaError "
                           f"{rc}")
    LAUNCHES += 1
