"""Newton iterations a step: the iterations the solve's WHILE node ran
(lockstep over the batch, while any env is active) over the steps of a
stretch, both counted on the card by the program's recorder
(harness/program.py)."""

from harness import program

UNIT = "iterations"


def read(ctx):
    r = program.reading(ctx)
    return None if r is None else program.per_step(r.table,
                                                   "loop.newton.iters")
