"""Share of the Newton loop's lockstep iterations that an env needed: the
envs active in each iteration, summed over a stretch, over its iterations
times the envs, counted on the card by the program's recorder
(harness/program.py).  100 means every env needed every iteration the
slowest env set."""

from harness import program

UNIT = "%"


def read(ctx):
    r = program.reading(ctx)
    return None if r is None else program.active_pct(r.table, "newton",
                                                     r.nenv)
