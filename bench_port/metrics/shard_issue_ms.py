"""Host ms a sharded call takes to issue every shard's steps: the mean
over a traced stretch's ``mesh.sharded_rollout`` spans of the time from
the span's start to the end of its last ``mesh.shard`` child
(harness/cards.py).  The last card starts that much after the first."""

from harness import cards

UNIT = "ms"


def read(ctx):
    r = cards.reading(ctx)
    return None if r is None else cards.issue_ms(r.spans)
