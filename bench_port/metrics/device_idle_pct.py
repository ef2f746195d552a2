"""Share of a traced stretch of the timed path in which no operation ran
on the card: the stretch's host-timed window minus the union of the
device's operation intervals and WHILE nodes, over the window
(torch.profiler of the device over calls of the cell's own entry for
layers.BUSY_S seconds, after the measured window; harness/layers.py)."""

UNIT = "%"


def read(ctx):
    if ctx.busy_s is None:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
