"""What the benchmark reads from a torch.profiler trace.

A trace is reduced to plain intervals first (``events``), so the
arithmetic below runs on any list of (name, start_ns, end_ns) and is
tested on the CPU:

* the device's busy time is the UNION of its operations' intervals, not
  their sum: under a CUDA graph the profiler's kernel records overlap and
  are lengthened by the tracing itself, so a sum reads above the window;
* an idle gap is a stretch of the window that no device operation covers,
  named by what the host was doing when it began (the innermost host span
  open at that instant);
* a kernel's time is the mean duration of the device records whose name
  holds the kernel's name, read from a trace of eager steps, where every
  launch carries its own name;
* the profiler records no kernel inside the body of a CUDA graph's
  conditional WHILE node (the program's on-device loops: the Newton
  solve, the line search, GJK), only the predicate kernel launched before
  the node (``LOOP_KERNEL``).  A node runs on the device from the end of
  that predicate to the next operation the trace holds, with no host
  work between, so that interval counts as the node's device time
  (``WHILE_NODE``); without it a replayed manip step reads half idle.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import re

WINDOW = "bench_port.window"
LOOP_KERNEL = "set_any"       # csrc/graph_loop.cu's predicate kernel
WHILE_NODE = "WHILE node (body kernels untraced)"


@dataclasses.dataclass
class Trace:
    device: list        # (name, start_ns, end_ns) of device operations
    host: list          # (name, start_ns, end_ns) of host spans and ops
    window: tuple       # (start_ns, end_ns) of the WINDOW span


def events(prof, spanned: bool = True) -> Trace:
    """The device operations (kernels, copies, fills) and host events of a
    finished torch.profiler.profile, and the span named WINDOW; a trace of
    the device alone (``spanned=False``) spans its operations."""
    dev, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        iv = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if str(e.device_type()).endswith("CUDA"):
            # a host span is also drawn on the device's timeline; it is no
            # device work
            if e.name() == WINDOW or getattr(e, "is_user_annotation",
                                             lambda: False)():
                continue
            dev.append(iv)
        else:
            host.append(iv)
            if e.name() == WINDOW:
                window = iv[1:]
    if window is None and not spanned and dev:
        window = (min(iv[1] for iv in dev), max(iv[2] for iv in dev))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    return Trace(dev + while_nodes(dev), host, window)


def while_nodes(dev: list) -> list:
    """(WHILE_NODE, start, end) from the end of each LOOP_KERNEL record to
    the start of the next device record."""
    starts = sorted(s for _, s, _ in dev)
    out = []
    for name, s, e in dev:
        if LOOP_KERNEL in name:
            i = bisect.bisect_left(starts, e)
            if i < len(starts):
                out.append((WHILE_NODE, e, starts[i]))
    return out


def union(intervals, lo: int, hi: int) -> list:
    """The disjoint, sorted union of (start, end) intervals clipped to
    [lo, hi]."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def busy_s(tr: Trace) -> float:
    """Seconds of the window in which some device operation ran."""
    lo, hi = tr.window
    return sum(e - s for s, e in union([iv[1:] for iv in tr.device], lo,
                                       hi)) / 1e9


def window_s(tr: Trace) -> float:
    return (tr.window[1] - tr.window[0]) / 1e9


def gaps(tr: Trace) -> list:
    """The idle stretches of the window as (start_ns, end_ns)."""
    lo, hi = tr.window
    out, at = [], lo
    for s, e in union([iv[1:] for iv in tr.device], lo, hi):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def host_at(tr: Trace, t: int) -> str:
    """The innermost host span open at t (the one that began last), or
    "host" where none is."""
    best = None
    for name, s, e in tr.host:
        if s <= t < e and name != WINDOW and (best is None or s > best[1]):
            best = (name, s)
    return best[0] if best else "host"


def short(name: str) -> str:
    """A device operation's name without its C++ argument lists: the
    kernel's own name, then the functors and ops its template names."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^std::enable_if<.*?>::type ", "", name)
    head = re.match(r"(?:void )?([\w:]+)", name)
    head = head.group(1) if head else name
    parts = []
    for f in re.findall(r"(\w*(?:Functor|Ops?|_impl|_kernel)\w*)", name):
        if f not in parts and f != head.split("::")[-1]:
            parts.append(f)
    out = head + (f"[{','.join(parts)}]" if parts else "")
    return out[:160]


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time (summed by name, clipped
    to the window) and the longest idle gaps by what the host was doing."""
    lo, hi = tr.window
    by_name = collections.Counter()
    for name, s, e in tr.device:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            by_name[name if name == WHILE_NODE else short(name)] += \
                (e - s) / 1e9
    ops = [[n, v] for n, v in by_name.most_common(top)]
    longest = sorted(gaps(tr), key=lambda g: g[0] - g[1])[:top]
    idle = [[host_at(tr, s), (e - s) / 1e9] for s, e in longest]
    return {"device_ops": ops, "idle_gaps": idle}


def kernel_times_s(device: list, name: str) -> list:
    """Durations in seconds of the device records whose name holds
    ``name``."""
    return [(e - s) / 1e9 for n, s, e in device if name in n]
