"""Share of the deep-pair exact manifold's slots that held a live pair: the
slots collision's compaction enabled (``deep.lanes``), summed over a
stretch, over the slots it offered, 8 an env for each mesh-mesh group call
(one launch of the feature-clip kernel a call), both counted on the card
by the program's recorder (harness/program.py).  It says how much of the
clip's work is real: the kernel's cost follows the live lanes.  None
where the program does not count them (a commit before the counter), or
where no launch was counted (the CPU, or a scene with no mesh-mesh
group)."""

from harness import program

UNIT = "%"
# the compaction's slots an env and group call (ops/collision._DEEP_SLOTS
# of the program; a group of fewer pairs offers fewer)
SLOTS = 8


def read(ctx):
    r = program.reading(ctx)
    if r is None or "deep.lanes" not in r.table:
        return None
    calls = r.table.get("feature_clip", 0)
    if not calls:
        return None
    return 100.0 * r.table["deep.lanes"] / (calls * r.nenv * SLOTS)
