"""MB an entry call copies: the ``bytes`` the program's ``graph.load``
(copy-in of the state into the graph's buffers) and ``graph.result``
(clones of what the graph wrote, and of its trajectory buffers) spans
carry, summed over a traced stretch of the cell's entry, over its entry
calls (harness/program.py).  A count of the program's, not a clock: it
does not move with the card's pace."""

from harness import program

UNIT = "MB"


def read(ctx):
    r = program.reading(ctx)
    if r is None:
        return None
    got = program.attr_sum_per_call(r.spans, ("graph.load", "graph.result"),
                                    "bytes")
    return None if got is None else got / 2 ** 20
