"""Frozen copy of mujoco_sim_tpu_torch's CPU path for the benchmark's
plain reference (bench_port/refsim): imports rewritten, CUDA wrappers
and graph capture removed.  Do not import the program from here.

Shared collision group/candidate layout (compile-time + kernel-time).

Pairs are grouped by (type1, type2).  Primitive groups narrowphase ALL their
pairs every step.  Mesh-involving groups (expensive hull math) use two-level
selection: a cheap bound-distance prefilter picks the top-P closest pairs at
runtime, and only those are narrowphased into the group's P*cap candidate
slots.  Both models/compile.py (capacity planning) and ops/collision.py
(kernels) derive the same static layout from this module.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from refsim.models.model import GeomType

def collision_class(t: GeomType, vs_plane: bool = False) -> GeomType:
    """Narrowphase class of a geom type.

    Cylinders keep an exact path against planes but are represented by a
    synthetic 16-gon prism hull against everything else — one hull code
    path instead of N cylinder special cases."""
    if t == GeomType.CYLINDER and not vs_plane:
        return GeomType.MESH
    return t


# candidate contacts per pair by CLASS combo (geom1-class listed first;
# MESH here means "hull": real mesh or synthetic cylinder prism)
PAIR_NCON = {
    (GeomType.HFIELD, GeomType.SPHERE): 1,
    (GeomType.HFIELD, GeomType.CAPSULE): 3,
    (GeomType.HFIELD, GeomType.BOX): 4,
    (GeomType.HFIELD, GeomType.ELLIPSOID): 1,
    (GeomType.HFIELD, GeomType.MESH): 4,
    (GeomType.PLANE, GeomType.SPHERE): 1,
    (GeomType.PLANE, GeomType.CAPSULE): 2,
    (GeomType.PLANE, GeomType.CYLINDER): 4,
    (GeomType.PLANE, GeomType.BOX): 4,
    (GeomType.PLANE, GeomType.ELLIPSOID): 1,
    (GeomType.PLANE, GeomType.MESH): 3,
    (GeomType.SPHERE, GeomType.SPHERE): 1,
    (GeomType.SPHERE, GeomType.CAPSULE): 1,
    (GeomType.SPHERE, GeomType.BOX): 1,
    (GeomType.CAPSULE, GeomType.CAPSULE): 2,
    (GeomType.CAPSULE, GeomType.BOX): 3,
    (GeomType.BOX, GeomType.BOX): 8,
    (GeomType.SPHERE, GeomType.MESH): 1,
    (GeomType.CAPSULE, GeomType.MESH): 3,
    (GeomType.BOX, GeomType.MESH): 4,
    (GeomType.MESH, GeomType.MESH): 4,
}

# groups that use the top-P prefilter (hull math is per-vertex x per-face)
EXPENSIVE = {
    (GeomType.SPHERE, GeomType.MESH),
    (GeomType.CAPSULE, GeomType.MESH),
    (GeomType.BOX, GeomType.MESH),
    (GeomType.MESH, GeomType.MESH),
}

# Narrowphased hull pairs per group per step: the bound-distance prefilter
# keeps this many closest pairs.  16 is NOT enough for PR2 — its large
# base/shoulder hulls have >16 permanently-overlapping bounding spheres that
# outrank the small fingertip pairs which actually touch (r2 regression).
DEFAULT_TOP_P = 32


def pair_key(t1: GeomType, t2: GeomType):
    """(class key, swapped) for a geom-type pair, or None if unsupported.

    swapped=True means the pair must be stored with geoms exchanged so that
    geom1's class matches key[0].
    """
    for flat in (GeomType.PLANE, GeomType.HFIELD):
        if t1 == flat or t2 == flat:
            if t1 in (GeomType.PLANE, GeomType.HFIELD) and \
                    t2 in (GeomType.PLANE, GeomType.HFIELD):
                return None
            swapped = t1 != flat
            other = t1 if swapped else t2
            # hfield keeps the cylinder's prism-hull class (unlike plane,
            # which has an exact cylinder path)
            if flat == GeomType.HFIELD:
                other = collision_class(other)
            key = (flat, other)
            return (key, swapped) if key in PAIR_NCON else None
    c1 = collision_class(t1)
    c2 = collision_class(t2)
    if (c1, c2) in PAIR_NCON:
        return (c1, c2), False
    if (c2, c1) in PAIR_NCON:
        return (c2, c1), True
    return None


@dataclasses.dataclass
class Group:
    key: tuple                 # (GeomType, GeomType)
    pair_idx: np.ndarray       # indices into the model pair list (static)
    cap: int                   # candidates per pair
    top_p: int                 # pairs narrowphased per step (== len for prim)
    cand_adr: int              # first candidate slot
    ncand: int                 # total candidate slots = top_p * cap


def build_groups(pair_keys: list[tuple], top_p: int = DEFAULT_TOP_P):
    """pair_keys[i] = (t1, t2) of model pair i -> ordered Group list."""
    groups = []
    adr = 0
    for key in sorted(set(pair_keys), key=lambda k: (int(k[0]), int(k[1]))):
        idx = np.nonzero([k == key for k in pair_keys])[0]
        cap = PAIR_NCON[key]
        p = min(len(idx), top_p) if key in EXPENSIVE else len(idx)
        g = Group(key=key, pair_idx=idx, cap=cap, top_p=p, cand_adr=adr,
                  ncand=p * cap)
        adr += g.ncand
        groups.append(g)
    return groups, adr
