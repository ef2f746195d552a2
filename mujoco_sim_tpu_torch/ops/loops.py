"""Data-dependent loops of the step: ``lax.while_loop`` under ``vmap``.

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

import contextlib
import ctypes
import functools
import gc
import threading

import torch

from mujoco_sim_tpu_torch.ops import cuda_build

LAUNCHES = 0
SOURCE = cuda_build.source_path("graph_loop")
MAX_DEPTH = 3          # nesting depth of loops inside one capture

_STATE = threading.local()


def any_plain(mask: torch.Tensor) -> torch.Tensor:
    """The predicate's reduction as plain PyTorch: any env still running."""
    return mask.any()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = cuda_build.load("graph_loop")
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (
            ("graph_loop_stream", [ctypes.POINTER(vp)]),
            ("graph_loop_begin", [vp, i, vp, vp,
                                  ctypes.POINTER(ctypes.c_ulonglong)]),
            ("graph_loop_end", [vp, i, ctypes.c_ulonglong, vp]),
            ("graph_loop_any", [vp, i, vp, vp]),
            ("graph_loop_driver_version", [ctypes.POINTER(i)])):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = args
    return lib


def _check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"graph_loop: {what} failed: cudaError {rc}")


def driver_version() -> int:
    """The CUDA driver's version as an integer (12080 is 12.8)."""
    v = ctypes.c_int()
    _check(_load().graph_loop_driver_version(ctypes.byref(v)), "version")
    return v.value


def any_cuda(mask: torch.Tensor) -> torch.Tensor:
    """The predicate kernel with its flag written to memory: an int32 0-d
    tensor, 1 where any byte of the bool ``mask`` is set (the check of the
    kernel against ``any_plain``)."""
    global LAUNCHES
    if not mask.is_cuda or mask.dtype != torch.bool:
        raise ValueError("any_cuda: a bool CUDA tensor")
    mask = mask.contiguous()
    out = torch.empty((), dtype=torch.int32, device=mask.device)
    _check(cuda_build.launch(mask.device, _load().graph_loop_any,
                             mask.data_ptr(), mask.numel(), out.data_ptr()),
           "any")
    LAUNCHES += 1
    cuda_build.count_launch("graph_loop", mask.device)
    return out


@functools.lru_cache(maxsize=None)
def _body_stream(device_index: int, depth: int) -> torch.cuda.ExternalStream:
    """The stream that captures loop bodies at ``depth`` on a device, made
    once and kept: cuBLAS keeps a workspace per stream, so its workspace is
    made here, outside any capture, by one small product of each kind."""
    ptr = ctypes.c_void_p()
    with torch.cuda.device(device_index):
        _check(_load().graph_loop_stream(ctypes.byref(ptr)), "stream")
        s = torch.cuda.ExternalStream(ptr.value, device=device_index)
        s.wait_stream(torch.cuda.current_stream(device_index))
        with torch.cuda.stream(s):
            a = torch.ones(2, 4, 4, device=f"cuda:{device_index}")
            (a @ a, a[0] @ a[0], a @ a[..., :1], torch.einsum("bij,bj->bi",
                                                              a, a[..., 0]))
        s.synchronize()
    return s


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
    if active.is_cuda and torch.cuda.is_current_stream_capturing():
        _while_node(cond_fn, body_fn, carry, active)
    else:
        while bool(active.any()):
            _iterate(cond_fn, body_fn, carry, active)
    return carry


def _while_node(cond_fn, body_fn, carry, active):
    global LAUNCHES
    if not getattr(_STATE, "routed", False):
        raise RuntimeError(
            "while_loop under a CUDA-graph capture needs the capture of "
            "ops/loops.capture (utils/graph.StepGraph): the loop body's "
            "allocations must go to the graph's memory pool")
    depth = _STATE.depth
    if depth >= MAX_DEPTH:
        raise RuntimeError(f"while_loop: more than {MAX_DEPTH} nested loops")
    lib = _load()
    dev = active.device
    body = _body_stream(dev.index, depth)
    parent = torch.cuda.current_stream(dev)
    handle = ctypes.c_ulonglong()
    _check(lib.graph_loop_begin(active.data_ptr(), active.numel(),
                                parent.cuda_stream, body.cuda_stream,
                                ctypes.byref(handle)), "begin")
    LAUNCHES += 1
    # counted after the node: once a replay (cuda_build.count_launch)
    cuda_build.count_launch("graph_loop", dev)
    _STATE.depth = depth + 1
    try:
        with torch.cuda.stream(body):
            _iterate(cond_fn, body_fn, carry, active)
            # in the body: once an iteration
            cuda_build.count_launch("graph_loop", dev)
        _check(lib.graph_loop_end(active.data_ptr(), active.numel(),
                                  handle.value, body.cuda_stream), "end")
        LAUNCHES += 1
    finally:
        _STATE.depth = depth


@contextlib.contextmanager
def capture(graph: torch.cuda.CUDAGraph, device: torch.device):
    """Capture ``graph`` on a side stream of ``device`` (thread-local mode:
    another thread may use the card meanwhile), with every allocation this
    thread makes during the capture, on any stream, in the graph's pool:
    the loop bodies' streams included.  Yields the pool's id.

    The garbage collector is run before and kept off during the capture:
    an old graph it destroyed mid-capture would end the capture (a graph
    is freed with calls the capture does not permit)."""
    idx = device.index
    for depth in range(MAX_DEPTH):
        _body_stream(idx, depth)
    gc.collect()
    gc_was_on = gc.isenabled()
    gc.disable()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    pool = torch.cuda.graph_pool_handle()
    routed = False
    try:
        with torch.cuda.device(device), torch.cuda.stream(side):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                # capture_begin routes the capture stream's allocations
                # only; route this thread's instead (the second begin takes
                # a second reference on the pool, which the release gives
                # back)
                torch._C._cuda_endAllocateToPool(idx, pool)
                torch._C._cuda_beginAllocateCurrentThreadToPool(idx, pool)
                torch._C._cuda_releasePool(idx, pool)
                routed = _STATE.routed = True
                _STATE.depth = 0
                yield pool
            except BaseException:
                _STATE.routed = False
                try:
                    graph.capture_end()
                except Exception:
                    if routed:
                        with contextlib.suppress(Exception):
                            torch._C._cuda_endAllocateToPool(idx, pool)
                raise
            _STATE.routed = False
            graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(side)
    finally:
        if gc_was_on:
            gc.enable()
