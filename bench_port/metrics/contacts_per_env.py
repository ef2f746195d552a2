"""Contacts a step and env: collision's contact count (d.ncon summed over
the envs at its end) over the steps and envs of a stretch, counted on the
card by the program's recorder (harness/program.py)."""

from harness import program

UNIT = "contacts"


def read(ctx):
    r = program.reading(ctx)
    return None if r is None else program.per_env_step(r.table, "contacts",
                                                       r.nenv)
