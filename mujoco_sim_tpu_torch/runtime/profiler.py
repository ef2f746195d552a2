"""Tracing / profiling subsystem: the port's one recorder.

Torch port of mujoco_sim_tpu/runtime/profiler.py.  The reference's only
instrumentation is the RTF tracker + XML-I/O timing warnings (SURVEY §5).
Here the recorder works where the work happens, inside the step graph
that the entry points replay (utils/graph.StepGraph):

* a table of named counts on each device (``SLOTS``): the hand-written
  kernels' launches (``LAUNCH_COUNTS``), for each named loop of the
  step (ops/loops.while_loop) the iterations its WHILE node ran and the
  iterations its envs needed (the active mask summed over each
  iteration; for a loop a kernel runs each env through to its own stop,
  ``count_loop``: the slowest env's iterations and the sum), the steps
  run, the contacts collision found and the live lanes of the deep-pair
  exact manifold (``deep.lanes``: the enabled
  slots of each mesh-mesh group's compaction, of its envs x 8).  The adds
  run where the work runs: inside a capture they are nodes of the graph
  (in WHILE bodies too), so every replay counts its own work;
* stage stamps (``STAMPS``) at the boundaries of the step's stage
  functions (engine.py), into a ring of (steps x stamps) int64 on the
  device whose row is the table's step count: on the card the kernel of
  csrc/trace_stamp.cu (ops/trace_stamp.py) writes ``%globaltimer``, on
  the CPU the plain twin writes the host clock;
* host spans at the layer boundaries (the entry points, StepGraph's copy-
  in, replay, clones and capture, set-up, egress): name, start, end,
  parent and the id of the entry call they belong to, on the clock of
  torch.profiler's host events (Unix time in ns, ``time.time_ns``), and
  under an active torch.profiler session also a ``record_function`` range
  of the same name, so a profiler trace names its gaps by them.

Recording is off by default.  ``counting(device)`` keeps the table on a
device, ``tracing(device)`` the table, the stamps and the spans (with no
device: the spans alone).  Off, a span, stamp or count site costs one
check of a module flag, and nothing is captured into a graph; StepGraph
keys its captures on ``mode(device)``, so a graph captured with recording
on is never replayed with it off, nor the reverse.  One site records
whether or not tracing is on: a graph's capture (``graph.capture`` and
its children, ``span(..., always=True)``), which is set-up, seconds
long, and happens once a shape, so that the capture a program's set-up
made can be read afterwards.

Also here: per-stage wall timings of the step (``stage_timings``) and a
one-call torch.profiler trace (Chrome trace format) of the card's
schedule (``device_trace``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import os
import statistics
import threading
import time

import torch

from mujoco_sim_tpu_torch.ops import cuda_build

# the hand-written kernels' launch counts first, by their slots in
# ops/cuda_build.KERNELS (each wrapper adds one where it launches the
# kernel: ``count``)
LAUNCH_COUNTS = tuple(k.slot for k in cuda_build.KERNELS.values())
# the named loops of the step (ops/loops.while_loop's ``name``)
LOOPS = ("newton", "linesearch", "bracket", "gjk")
SLOTS = LAUNCH_COUNTS + tuple(
    f"loop.{n}.{k}" for n in LOOPS for k in ("iters", "env_iters")) + (
    "step.count", "contacts", "deep.lanes")
_SLOT = {n: i for i, n in enumerate(SLOTS)}
_LOOP = {n: (_SLOT[f"loop.{n}.iters"], _SLOT[f"loop.{n}.env_iters"])
         for n in LOOPS}
STEP = _SLOT["step.count"]

# the stage stamps of a step, in the order the step writes them
# (engine.py): a stage's start and end, and inside the position stage the
# ends of the smooth kinematics and of collision
STAMPS = ("position.start", "position.kinematics", "position.collision",
          "position.end", "velocity.start", "velocity.end",
          "actuation.start", "actuation.end", "acceleration.start",
          "acceleration.end", "constraint.start", "constraint.end",
          "sensors.start", "sensors.end", "integrate.start",
          "integrate.end")
_STAMP = {n: i for i, n in enumerate(STAMPS)}
RING_ROWS = 4096        # steps the ring holds; the oldest are overwritten

OFF, COUNT, TRACE = 0, 1, 2

# device -> its mode; the devices that record now
_MODE: dict = {}
# device -> its table / ring, made once and never freed: a graph captured
# while recording writes them on every replay
_TABLES: dict = {}
_RINGS: dict = {}
# the module flags the sites check: some device counts / stamps; open
# tracing blocks (spans)
_COUNTING = False
_STAMPING = False
_SPANS = 0

_RECORDED: list = []
_LOCAL = threading.local()
_IDS = itertools.count()
_CALLS = itertools.count()


def _norm(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _device_of(x) -> torch.device:
    """The device of a tensor, a Data (its qpos), a device, or the first
    of a tuple or list of those."""
    if isinstance(x, torch.device):
        return x
    if isinstance(x, torch.Tensor):
        return x.device
    if isinstance(x, (tuple, list)):
        return _device_of(x[0])
    return x.qpos.device


def _flags():
    global _COUNTING, _STAMPING
    _COUNTING = bool(_MODE)
    _STAMPING = TRACE in _MODE.values()


def mode(device) -> int:
    """OFF, COUNT or TRACE: what ``device`` records now."""
    return _MODE.get(device, OFF) if _MODE else OFF


@contextlib.contextmanager
def _recording(device, level: int):
    device = _norm(device)
    if device not in _TABLES:
        _TABLES[device] = torch.zeros(len(SLOTS), dtype=torch.int64,
                                      device=device)
    if level == TRACE and device not in _RINGS:
        _RINGS[device] = torch.zeros((RING_ROWS, len(STAMPS)),
                                     dtype=torch.int64, device=device)
    was = _MODE.get(device, OFF)
    _MODE[device] = max(was, level)
    _flags()
    try:
        yield
    finally:
        if was == OFF:
            _MODE.pop(device, None)
        else:
            _MODE[device] = was
        _flags()


@contextlib.contextmanager
def counting(device):
    """Keep the table of counts on ``device`` inside the block (graphs
    captured in it count their replays' work wherever they replay); on
    exit the state before it is restored."""
    with _recording(device, COUNT):
        yield


@contextlib.contextmanager
def tracing(device=None):
    """Record spans inside the block, and on ``device`` (if given) the
    table of counts and the stage stamps; on exit the state before it is
    restored."""
    global _SPANS
    with (_recording(device, TRACE) if device is not None
          else contextlib.nullcontext()):
        _SPANS += 1
        try:
            yield
        finally:
            _SPANS -= 1


# ------------------------------------------------------------------ counts

def count(name: str, on) -> None:
    """Add one to count ``name`` on the device of ``on`` (a device, a
    tensor or a Data) where it counts now, on the current stream, so a
    capture records it."""
    if not _COUNTING:
        return
    dev = _device_of(on)
    if dev in _MODE:
        _TABLES[dev][_SLOT[name]].add_(1)


def count_sum(name: str, values: torch.Tensor) -> None:
    """Add ``values.sum()`` to count ``name`` on their device where it
    counts now."""
    if not _COUNTING or values.device not in _MODE:
        return
    _TABLES[values.device][_SLOT[name]].add_(values.sum())


def count_iteration(loop: str | None, active: torch.Tensor) -> None:
    """One iteration of loop ``loop`` (None: a loop with no name, not
    counted) over the envs of the bool mask ``active`` (those that needed
    it): its two counts."""
    if not _COUNTING or loop is None or active.device not in _MODE:
        return
    i, j = _LOOP[loop]
    t = _TABLES[active.device]
    t[i].add_(1)
    t[j].add_(active.sum())


def count_loop(loop: str, per_env: torch.Tensor) -> None:
    """A loop that ran each env to its own stop in one kernel (no WHILE
    node): ``per_env`` holds each env's iterations.  Its two counts get
    what a lockstep loop over the same envs would count: the iterations
    of the slowest env (``.iters``: the max) and the envs' own
    (``.env_iters``: the sum)."""
    if not _COUNTING or per_env.device not in _MODE:
        return
    i, j = _LOOP[loop]
    t = _TABLES[per_env.device]
    t[i].add_(per_env.max())
    t[j].add_(per_env.sum())


def counts(device) -> dict:
    """Every count kept on ``device`` so far, by slot name (read back: a
    host sync); all 0 where it never counted."""
    t = _TABLES.get(_norm(device))
    return dict(zip(SLOTS, [0] * len(SLOTS) if t is None else t.tolist()))


def reset(device):
    """Zero ``device``'s table and ring in place (graphs captured while
    recording keep writing them)."""
    device = _norm(device)
    for store in (_TABLES, _RINGS):
        if device in store:
            store[device].zero_()


# ------------------------------------------------------------------ stamps

def stamp(name: str, on) -> None:
    """Stage stamp ``name`` of the current step on the device of ``on``,
    where it is traced."""
    if not _STAMPING:
        return
    dev = _device_of(on)
    if _MODE.get(dev) != TRACE:
        return
    from mujoco_sim_tpu_torch.ops import trace_stamp
    ring, table = _RINGS[dev], _TABLES[dev]
    if dev.type == "cuda":
        trace_stamp.stamp_cuda(ring, table, _STAMP[name], STEP,
                               _SLOT["trace_stamp"])
    else:
        # the CPU launches no kernel: its launch counts stay 0
        trace_stamp.stamp_plain(ring, table, _STAMP[name], STEP, _now())


def ring(device) -> list:
    """The stamps of the last steps ``device`` ran (at most RING_ROWS; a
    host sync), oldest first, each a dict by stamp name.  A step run while
    the device only counted has no stamps of its own in its row."""
    device = _norm(device)
    r = _RINGS.get(device)
    if r is None:
        return []
    n = counts(device)["step.count"]
    rows = r.cpu().tolist()
    return [dict(zip(STAMPS, rows[s % RING_ROWS]))
            for s in range(max(0, n - RING_ROWS), n)]


def stamp_offsets(records, device) -> list:
    """(kernel start, offset) in ns for each ``trace_stamp`` kernel of a
    profiler trace: its stamp's ``%globaltimer`` value minus its start.
    ``records``: a finished torch.profiler.profile, or its device records
    as (name, start_ns, end_ns); the trace must end with the last steps
    the device ran (its trace_stamp kernels are paired, in order, with
    the last stamps of ``ring(device)``)."""
    if hasattr(records, "profiler"):
        records = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in records.profiler.kineto_results.events()
                   if str(e.device_type()).endswith("CUDA")]
    starts = sorted(s for n, s, _ in records if "trace_stamp" in n)
    stamps = [v for row in ring(device) for v in row.values()]
    k = min(len(starts), len(stamps))
    if k == 0:
        raise ValueError("stamp_offsets: no trace_stamp kernel in the "
                         "trace, or no stamp on the device")
    return [(t, s - t) for s, t in zip(stamps[-k:], starts[-k:])]


def device_offset_ns(records, device) -> tuple:
    """(mean, spread) in ns of ``stamp_offsets``: the offset that maps the
    card's stamps onto the profiler trace's timeline, averaged over the
    trace's stretch, and its largest minus its smallest value."""
    off = [o for _, o in stamp_offsets(records, device)]
    return statistics.fmean(off), max(off) - min(off)


# ------------------------------------------------------------------- spans

def _now() -> int:
    """The host clock of the spans: torch.profiler's host events are in
    Unix time (its approximate clock converted to it), ns."""
    return time.time_ns()


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    start_ns: int
    end_ns: int = 0
    id: int = 0
    parent: int | None = None     # the id of the span open around it
    call: int = 0                 # the id of the entry call it belongs to
    attrs: dict = dataclasses.field(default_factory=dict)


def _stack() -> list:
    s = getattr(_LOCAL, "stack", None)
    if s is None:
        s = _LOCAL.stack = []
    return s


class _Open:
    """An open span (``span``'s context manager while tracing)."""

    __slots__ = ("span", "rf", "dev", "seg0")

    def __init__(self, name: str, like):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.span = Span(name, 0, id=next(_IDS),
                         parent=None if parent is None else parent.id,
                         call=next(_CALLS) if parent is None else parent.call)
        self.rf = None
        self.dev = None if like is None else _device_of(like)
        if self.dev is not None and self.dev.type != "cuda":
            self.dev = None

    def __enter__(self) -> Span:
        if self.dev is not None:
            # cudaMallocs of the caching allocator: its segments made
            self.seg0 = _segments(self.dev)
        _stack().append(self.span)
        _RECORDED.append(self.span)
        self.span.start_ns = _now()
        if torch._C._autograd._profiler_enabled():
            self.rf = _record_function(self.span.name)
            self.rf.__enter__()
        return self.span

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.span.end_ns = _now()
        _stack().pop()
        if self.dev is not None:
            self.span.attrs["mallocs"] = _segments(self.dev) - self.seg0
        return False


def _record_function(name: str):
    """A record_function range: PyTorch's C++ one where it has it (~2 us
    to enter, against ~20 us for the Python one)."""
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    return (fast or torch.autograd.profiler.record_function)(name)


def _segments(dev) -> int:
    return torch.cuda.memory_stats(dev).get("segment.all.allocated", 0)


def span(name: str, like=None, always: bool = False):
    """A context manager recording span ``name`` while tracing, or
    ``always`` (yielding its Span, whose ``attrs`` the site may fill), and
    nothing otherwise (yielding None).  ``like`` (a tensor or Data on a
    CUDA device) adds the caching allocator's segments made inside it as
    ``mallocs``."""
    if not (_SPANS or always):
        return contextlib.nullcontext()
    return _Open(name, like)


def spanned(name: str):
    """Decorator: each call of the function is span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _SPANS:
                return fn(*args, **kwargs)
            with _Open(name, None):
                return fn(*args, **kwargs)
        return inner
    return wrap


def spans() -> list:
    """The spans recorded so far (a span still open has end_ns 0)."""
    return list(_RECORDED)


def clear_spans():
    _RECORDED.clear()


def self_ns(recorded) -> dict:
    """{span id: its duration minus the part of it its child spans
    cover} over a list of spans."""
    kids: dict = {}
    for s in recorded:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    out = {}
    for s in recorded:
        covered, at = 0, s.start_ns
        for a, b in sorted(kids.get(s.id, ())):
            a, b = max(a, at), min(b, s.end_ns)
            if b > a:
                covered += b - a
                at = b
        out[s.id] = s.end_ns - s.start_ns - covered
    return out


def write_spans(path: str, recorded=None):
    """The spans (all recorded so far unless given), one JSON object a
    line."""
    with open(path, "w") as f:
        for s in _RECORDED if recorded is None else recorded:
            f.write(json.dumps(dataclasses.asdict(s)) + "\n")


# ------------------------------------------------------ traces and stages

@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of the host and, where there is a
    card, its kernels; written to ``log_dir/trace.json`` (open with
    chrome://tracing or Perfetto).  Yields the profiler, whose
    ``key_averages()`` sums the time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(d):
    if d.qpos.is_cuda:
        torch.cuda.synchronize(d.qpos.device)


def stage_timings(m, d, repeats: int = 20) -> dict:
    """Wall-time each pipeline stage of the step (diagnostics), in
    seconds per call.  Each stage is a StepGraph of its own (one CUDA
    graph on the card, as the JAX profiler jits each stage), copying in
    every leaf of its input, and runs on the previous fwd stage's output;
    the first call (warm-up and capture) is not timed.  On the card each
    timing ends with a synchronize, so it holds the device time, not only
    the launches."""
    from mujoco_sim_tpu_torch import engine
    from mujoco_sim_tpu_torch.ops import solver as solver_mod
    from mujoco_sim_tpu_torch.utils.graph import StepGraph

    stages = {
        "fwd_position": engine.fwd_position,
        "fwd_velocity": engine.fwd_velocity,
        "fwd_acceleration": engine.fwd_acceleration,
        "solver": solver_mod.solve,
        "full_step": engine.step,
    }
    out = {}
    cur = d
    for name, fn in stages.items():
        g = StepGraph(fn, all_leaves=True)
        res = g(m, cur)
        _sync(cur)
        t0 = time.perf_counter()
        for _ in range(repeats):
            g(m, cur)
        _sync(cur)
        out[name] = (time.perf_counter() - t0) / repeats
        if name.startswith("fwd"):
            cur = res
    return out
