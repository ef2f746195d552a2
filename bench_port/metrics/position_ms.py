"""Device ms a call of the position stage (engine.fwd_position: smooth,
collision, constraint rows) as a graph of its own, on the state the
window ended at (harness/stages.py)."""

UNIT = "ms"
STAGE = "fwd_position"


def prepare(probe):
    probe.stage(STAGE)


def read(ctx):
    return ctx.stages.get(STAGE)
