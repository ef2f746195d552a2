"""Host ms of a step graph's launch: the mean of the program's
``graph.replay`` spans (StepGraph's replay: the cudaGraphLaunch) over a
traced stretch of the cell's entry (harness/program.py).  Read in the
cell whose host sets the pace (mobile-1024.cmd): where the card sets it,
a launch waits on a full launch queue and the span times the card's
pace."""

from harness import program

UNIT = "ms"


def read(ctx):
    r = program.reading(ctx)
    return None if r is None else program.mean_span_ms(r.spans,
                                                       "graph.replay")
