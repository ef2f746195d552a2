"""Share of a traced stretch in which the least busy card of a sharded
cell was stepping: 100 x its summed step spans (each step from its first
stage stamp to its last, on its own ring) over the stretch's host
seconds (harness/cards.py).  A card that waits on the host's issue, or
finishes before the slowest, reads lower."""

from harness import cards

UNIT = "%"


def read(ctx):
    r = cards.reading(ctx)
    return None if r is None else cards.busy_min_pct(r.rings, r.seconds)
