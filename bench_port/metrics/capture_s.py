"""Seconds of the step graph's capture (its warm-up call and the CUDA
graph capture) in the cell's set-up: the program's ``graph.capture``
spans, which it records whether or not tracing is on, summed over those
that ended before the traced readings began (the set-up's captures, and
any the window made: more than the entry's graphs means it recaptured;
harness/program.py).  Part of ``setup_s``; the rest is the process's and
CUDA's start, the model's build and the kernels' load."""

from harness import program

UNIT = "s"


def read(ctx):
    r = program.reading(ctx)
    return None if r is None else program.seconds_of(r.captures,
                                                      "graph.capture")
