"""Segments the caching allocator asked the card for (cudaMalloc) an entry
call: the ``mallocs`` the program's entry spans carry (a delta of
torch.cuda.memory_stats' segment.all.allocated, read only while tracing),
over a traced stretch of the cell's entry (harness/program.py)."""

from harness import program

UNIT = "count"


def read(ctx):
    r = program.reading(ctx)
    return None if r is None else program.attr_per_call(r.spans, "mallocs")
