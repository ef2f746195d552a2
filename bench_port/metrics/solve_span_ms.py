"""Device ms a step of the constraint stage (engine.fwd_constraint: the
Newton solve) in the step graph the cell replays: the mean over a
stretch's steps of its end stamp minus its start stamp, written on the
card by the program's recorder (harness/program.py)."""

from harness import program

UNIT = "ms"


def read(ctx):
    r = program.reading(ctx)
    return None if r is None else program.span_ms(
        r.rows, "constraint.start", "constraint.end")
