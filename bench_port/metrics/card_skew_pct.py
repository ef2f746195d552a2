"""How far the slowest card of a sharded cell lags: 100 x (its mean
device ms a step - the cards' mean of it) / the cards' mean, each card's
from its own stage stamps (its clock is used only against itself;
harness/cards.py).  Each call waits on the slowest card."""

from harness import cards

UNIT = "%"


def read(ctx):
    r = cards.reading(ctx)
    return None if r is None else cards.skew_pct(r.rings)
