"""Host ms an entry call spends copying: the program's ``graph.load``
(copy-in of the state into the graph's buffers) and ``graph.result``
(clones of what the graph wrote) spans, summed over a traced stretch of
the cell's entry, over its entry calls (harness/program.py).  Read in the
cell whose host sets the pace (mobile-1024.cmd): where the card sets it
(manip-1024.policy), these async copies wait on a full launch queue, and
the span times the card's pace; copy_mb reads the bytes there."""

from harness import program

UNIT = "ms"


def read(ctx):
    r = program.reading(ctx)
    return None if r is None else program.ms_per_call(
        r.spans, ("graph.load", "graph.result"))
