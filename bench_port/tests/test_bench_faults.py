"""The check catches a broken timed path.  A run is rehearsed on the CPU
at 8 envs (every env sampled) with the program's step broken underneath,
once for each fault a one-card physics cell can have, and ``correct``
must come out false:

* a step that returns its state unchanged;
* half of the batch left out (its envs keep their state);
* an answer altered where it is produced (the velocities a step writes);
* a wrong acceleration on a subset, time intact: the last quarter of the
  batch, or the first quarter of the dofs in every env, a step's worth
  of gravity off (timestep x 9.81 on each of their velocities);
* in a cell with contacts, collision wrong: the depths and separations
  that ops/hull_sat gives scaled by 1.5 (on the card, csrc/hull_sat.cu's
  output); every contact of one pair dropped in each env; or, in each
  env, one contact dropped from a pair that keeps a deeper one (a cap
  on contacts a pair: the deepest distance stays as it was).

A cell on one card has no exchange between cards to leave out.  The
control, the reference in TF32 in the program's place, must fail the
same numbers (on the CPU here, on the card at the cell's own size in
test_bench_control_card.py).
"""

import json
import os

import pytest
import torch

from conftest import CHECKOUT

CELLS = [w["name"] for w in
         json.load(open(os.path.join(CHECKOUT, "BENCHMARK.json")))["workloads"]]
STEPS = {"cmd": "step2"}           # the function a law's step ends in


def _contacts(cell) -> bool:
    """The cell compares collision (its limits hold depth_gap_max)."""
    with open(os.path.join(CHECKOUT, "bench_port", "limits",
                           cell + ".json")) as f:
        return "depth_gap_max" in json.load(f)


def _unchanged(step):
    return lambda m, d: d


def _half(step):
    def f(m, d):
        from harness import sims
        new = step(m, d)
        h = d.qpos.shape[0] // 2
        return new.replace(**{
            k: torch.cat([getattr(new, k)[:h], getattr(d, k)[h:]])
            for k in sims.STATE})
    return f


def _altered(step):
    def f(m, d):
        new = step(m, d)
        return new.replace(qvel=new.qvel + 1e-3)
    return f


def _gravity_off(m, d, new, envs=slice(None), dofs=slice(None)):
    dv = torch.zeros_like(new.qvel)
    dv[envs, dofs] = float(m.opt.timestep) * 9.81
    return new.replace(qvel=new.qvel + dv)


def _quarter_of_envs(step):
    def f(m, d):
        new = step(m, d)
        return _gravity_off(m, d, new, envs=slice(-max(1, d.qpos.shape[0]
                                                      // 4), None))
    return f


def _quarter_of_dofs(step):
    def f(m, d):
        new = step(m, d)
        return _gravity_off(m, d, new,
                            dofs=slice(0, max(1, d.qvel.shape[1] // 4)))
    return f


def _mesh_depths_scaled(monkeypatch):
    from mujoco_sim_tpu_torch.ops import collision
    orig = collision.hull_ref_face_depth

    def scaled(*a, **k):
        depth, top, nref, sep = orig(*a, **k)
        return depth * 1.5, top, nref, sep * 1.5
    monkeypatch.setattr(collision, "hull_ref_face_depth", scaled)


def _dropping(monkeypatch, lose_of):
    """Collision whose contacts ``lose_of(contact)`` marks are lost."""
    from mujoco_sim_tpu_torch.ops import collision
    orig = collision.collision

    def dropped(m, d):
        d = orig(m, d)
        c = d.contact
        return d.replace(contact=c.replace(active=c.active & ~lose_of(c)))
    monkeypatch.setattr(collision, "collision", dropped)


def _same_pair(c):
    """(B, K, K): slots i and j hold active contacts of one pair."""
    act = c.active[:, :, None] & c.active[:, None, :]
    return (act & (c.geom1[:, :, None] == c.geom1[:, None, :])
            & (c.geom2[:, :, None] == c.geom2[:, None, :]))


def _first(mask):
    """(B, K): the first True of each row (none where a row has none)."""
    first = mask.int().argmax(1, keepdim=True)
    return (torch.zeros_like(mask).scatter(1, first, True)
            & mask.any(1, keepdim=True))


def _pair_dropped(monkeypatch):
    def lose_of(c):
        pair = _same_pair(c)
        return (pair & _first(c.active)[:, :, None]).any(1)
    _dropping(monkeypatch, lose_of)


def _contact_dropped(monkeypatch):
    def lose_of(c):
        deeper = _same_pair(c) & (c.dist[:, None, :] < c.dist[:, :, None])
        return _first(deeper.any(2))
    _dropping(monkeypatch, lose_of)


STEP_FAULTS = [_unchanged, _half, _altered, _quarter_of_envs,
               _quarter_of_dofs]
COLLISION_FAULTS = [_mesh_depths_scaled, _pair_dropped, _contact_dropped]
CASES = ([(c, f) for c in CELLS for f in STEP_FAULTS]
         + [(c, f) for c in CELLS if _contacts(c) for f in COLLISION_FAULTS])


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_fault_fails_the_check(cell, fault, capsys, monkeypatch,
                               early_checks):
    import run
    from harness import spec
    from mujoco_sim_tpu_torch import engine
    from mujoco_sim_tpu_torch.utils import graph
    if fault in COLLISION_FAULTS:
        fault(monkeypatch)
    else:
        name = STEPS.get(spec.load(cell).name.split(".")[-1], "step")
        monkeypatch.setattr(engine, name, fault(getattr(engine, name)))
    graph.clear_all()       # no step graph made before the fault survives
    try:
        rc = run.main(["--workload", cell, "--seed", "12345", "--seconds",
                       "0.05", "--trace", "0"], device="cpu", nenv=8)
    finally:
        graph.clear_all()
    res = json.loads(capsys.readouterr()[0].strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(cell, early_checks):
    import run
    from harness import check, spec
    c = spec.load(cell)
    cl = run.Cell(c, torch.device("cpu"), 4)
    cl.warm(777)
    w = cl.window(777, 0.05)
    res = run.check(c, run.chosen(c, w, cl.plan), w.start,
                        len(cl.plan.rows), control=True)
    assert check.judge(res["numbers"], c.limits)[0] is True
    assert check.judge(res["control"], c.limits)[0] is False
