"""Device ms a call of the constraint solve (ops/solver.solve) as a graph
of its own, on the state the window ended at, after the forward stages
(harness/stages.py)."""

UNIT = "ms"
STAGE = "solve"


def prepare(probe):
    probe.stage(STAGE)


def read(ctx):
    return ctx.stages.get(STAGE)
