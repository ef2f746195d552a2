"""How ``correct`` is decided: the program's answers against the plain
reference.

An answer is one env's step.  The window leaves, at the steps the plan
drew, the state of a sample of envs before and after a step of the timed
path; the reference (refsim, float64 on the CPU, its own model compiled
from the same MJCF) takes each state before, with the law's inputs for
those envs, steps once, and the program's state after is held to it.
The reference follows the program step by step from the program's own
state because free-running contact rollouts of two implementations part
after tens of steps; the start, which this skips, is checked by itself.

Even over one step the two part where contact picks tie: a body resting
on a face of four corners at equal depth is held by three of them, which
three turns on the last bit, and the two steps then differ by up to
about a unit of velocity.  At a later step of an episode most envs hold
such a tie somewhere.  So collision is held on every answer by what a
tie does not change, the deepest contact of each pair of geoms, and the
numbers that read the dynamics (the collision's output through the solve
and the integration) are taken over the answers whose contacts agree:
the same number of contacts, each of the program's within AGREE_M of one
of the reference's on the same pair of geoms (``agree_share``, read but
not compared, counts them).

The numbers (each compared where limits/<cell>.json gives it a limit):

* ``start_gap``: largest |program - reference| over the state leaves of
  the initial state (the reference cast to the program's dtype); exact;
* ``time_gap_ulp``: largest |program - reference| of ``time`` after a
  step, in float32 units in the last place of the reference's time: the
  configuration states a float32 state and its timestep, and a step adds
  the one to the other with one rounding (half a unit); a step left out,
  or done twice, moves it by tens of thousands of units;
* ``xpos_gap_max``: largest |program - reference| over the bodies' world
  positions the step's position stage computed (no pick is involved);
* ``depth_gap_max``: over every answer and every pair of geoms in contact
  on either side, the largest |program - reference| of the pair's
  deepest contact distance; a pair in contact on one side only counts
  from the contact margin (``includemargin``), where the other side's
  collision cut it off.  Picks among corners at equal depth leave the
  deepest distance as it is; a wrong depth, or a pair's contacts lost,
  moves it;
* ``count_gap_share``: over the same pairs, the summed |program -
  reference| of the pair's number of contacts, as a share of the
  reference's contacts: a pair's count moves only where a contact sits
  at its margin, or where contacts are lost or made up;
* ``qpos_gap_median``, ``qvel_gap_median``: the median over every dof of
  the answers whose contacts agree of |program - reference| after the
  step;
* ``qvel_gap_worst_dof_q50``: each agreeing answer's largest qvel gap
  over its dofs, at the median over those answers: a fault on a few dofs
  of every env shows here and not in the median over all dofs;
* ``qvel_gap_median_dof_q75``: each agreeing answer's median qvel gap
  over its dofs, at the 75th percentile over those answers: a fault on a
  quarter of the envs shows here.  Higher quantiles, and the largest
  dof gap at the 75th percentile, read the few agreeing answers whose
  solve sits near a tie, and swing from seed to seed by as much as the
  control moves them.
  No agreeing answer reads as not a number.
"""

from __future__ import annotations

import contextlib

import torch

from harness import sims

NUMBERS = ("start_gap", "time_gap_ulp", "xpos_gap_max", "depth_gap_max",
           "count_gap_share", "qpos_gap_median", "qvel_gap_median",
           "qvel_gap_worst_dof_q50", "qvel_gap_median_dof_q75")
AGREE_M = 1e-4
READ = ("time", "qpos", "qvel", "xpos")     # and the contacts, after a step


def start_gap(prog0, ref0) -> float:
    """The initial states' largest gap over the float state leaves (the
    reference cast to the program's dtype); booleans must be equal."""
    gap = 0.0
    for k in sims.STATE:
        a, b = prog0[k], ref0[k]
        if a.numel() == 0:
            continue
        if a.is_floating_point():
            gap = max(gap, float((a.cpu() - b.to(a.dtype)).abs().max()))
        elif not torch.equal(a.cpu(), b.cpu()):
            gap = float("inf")
    return gap


def _rows(checks, key: str, part: int):
    return torch.cat([c[part][key] for c in checks]).cpu()


def agree(post: dict, ref) -> torch.Tensor:
    """(answers,) bool: the answer's contacts agree with the reference's."""
    c = ref.contact
    pa, ra = post["contact.active"], c.active
    same = ((post["contact.geom1"][:, :, None] == c.geom1[:, None, :])
            & (post["contact.geom2"][:, :, None] == c.geom2[:, None, :])
            & ra[:, None, :])
    dist = (post["contact.pos"].double()[:, :, None, :]
            - c.pos[:, None, :, :]).norm(dim=-1)
    near = (same & (dist < AGREE_M)).any(-1)
    return (pa.sum(1) == ra.sum(1)) & (near | ~pa).all(1)


PAIR_FIELDS = ("active", "geom1", "geom2", "dist", "includemargin")


def _pairs(active, geom1, geom2, dist, margin) -> list:
    """Each answer's {(geom, geom): (deepest distance, contacts, margin)}
    over its active contacts."""
    out = []
    for row in zip(*(t.cpu().tolist() for t in (active, geom1, geom2,
                                                   dist.double(),
                                                   margin.double()))):
        pairs = {}
        for on, g1, g2, d, mg in zip(*row):
            if on:
                key = (min(g1, g2), max(g1, g2))
                deep, n, _ = pairs.get(key, (float("inf"), 0, mg))
                pairs[key] = (min(deep, d), n + 1, mg)
        out.append(pairs)
    return out


def pair_gaps(post: dict, ref) -> tuple[list, int, int]:
    """Over every answer and every pair of geoms in contact on either side:
    ([|program - reference| of the pair's deepest contact distance, a
    side without the pair read at the pair's contact margin], the summed
    |difference| of the pairs' contact counts, the reference's contacts)."""
    prog = _pairs(*(post["contact." + k] for k in PAIR_FIELDS))
    refs = _pairs(*(getattr(ref.contact, k) for k in PAIR_FIELDS))
    gaps, dcount, nref = [], 0, 0
    for a, b in zip(prog, refs):
        nref += sum(n for _, n, _ in b.values())
        for key in a.keys() | b.keys():
            da, na, ma = a.get(key, (None, 0, None))
            db, nb, mb = b.get(key, (None, 0, None))
            gaps.append(abs((mb if da is None else da)
                            - (ma if db is None else db)))
            dcount += abs(na - nb)
    return gaps, dcount, nref


def reference_step(checks, law, R, mr, p: dict, tf32: bool = False):
    """(the program's states after the checked steps, the reference's
    Data after them), all the checked steps through the reference's step
    at once.  With tf32 the reference runs in float32 with every matmul in
    emulated TF32 (the control)."""
    from harness import tf32 as tf
    pre = {k: _rows(checks, k, 2) for k in checks[0][2]
           if k in sims.STATE or k.startswith("pd.")}
    post = {k: _rows(checks, k, 3) for k in checks[0][3]}
    inputs = {k: _rows(checks, k, 4).to(mr.dtype) for k in checks[0][4]}
    carry = law.rebuild(R, mr, pre)
    with tf.emulated() if tf32 else contextlib.nullcontext():
        ref = law.data(law.step(R, mr, inputs, p)(carry))
    return post, ref


def _ulp32(t: torch.Tensor) -> torch.Tensor:
    """float32's unit in the last place at |t| (float64)."""
    t32 = t.float().abs()
    return (torch.nextafter(t32, torch.full_like(t32, float("inf")))
            - t32).double()


def numbers(post: dict, ref) -> tuple[dict, list, dict]:
    """The numbers of one side's posts against the reference's; each
    answer's (time gap in ulps, agrees); more readings for the limits."""
    gap = {k: (post[k].double() - getattr(ref, k).double()).abs()
           for k in READ}
    t_ulp = gap["time"] / _ulp32(ref.time)
    ok = agree(post, ref)
    depth, dcount, nref = pair_gaps(post, ref)
    q = lambda x, f: (float(x.flatten().quantile(f)) if x.numel()
                      else float("nan"))
    agreeing = gap["qvel"][ok]                  # (agreeing answers, nv)
    worst = agreeing.amax(1)
    typical = agreeing.quantile(0.5, dim=1) if ok.any() else worst
    out = {
        "time_gap_ulp": float(t_ulp.max()),
        "xpos_gap_max": float(gap["xpos"].max()),
        "depth_gap_max": max(depth, default=0.0),
        "count_gap_share": dcount / max(nref, 1),
        "qpos_gap_median": q(gap["qpos"][ok], 0.5),
        "qvel_gap_median": q(gap["qvel"][ok], 0.5),
        "qvel_gap_worst_dof_q50": q(worst, 0.5),
        "qvel_gap_median_dof_q75": q(typical, 0.75),
    }
    more = {"agree_share": float(ok.double().mean()),
            "pairs": len(depth),
            "qvel_gap_median_all": q(gap["qvel"], 0.5),
            "qvel_gap_worst_dof_q75": q(worst, 0.75),
            "qvel_gap_worst_dof_q90": q(worst, 0.9),
            "qvel_gap_max_agree": q(worst, 1.0),
            "qpos_gap_max_agree": q(gap["qpos"][ok], 1.0)}
    return out, list(zip(t_ulp.tolist(), ok.tolist())), more


def failed_answers(per_answer: list, limits: dict) -> int:
    """Answers whose own time gap is over the limit (or is not a
    number)."""
    return sum(1 for t, _ in per_answer if not t <= limits["time_gap_ulp"])


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [[name, number, limit]...]) over the numbers the cell's
    limits name, in NUMBERS' order: each number at most its limit; a
    number that is missing or not a number fails."""
    rows, ok = [], True
    names = [k for k in NUMBERS if k in limits]
    for name in names + [k for k in limits if k not in names]:
        x, lim = numbers.get(name, float("nan")), limits[name]
        good = x == x and x <= lim
        ok = ok and good
        rows.append([name, x, lim])
    return ok, rows
