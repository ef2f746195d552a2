"""The general generator: the same seed gives the same inputs, and each
episode is cut into calls that put every checked step in a call of its
own."""

import json

import numpy as np
import pytest
import torch

from conftest import BENCH
from harness import window

MIXES = ("stir", "stir50", "policy", "cmd")


class _M:
    nu, nv, dtype = 6, 9, torch.float32


def _mix(name):
    return json.load(open(f"{BENCH}/traffic/{name}.json"))


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_draws(mix):
    spec = _mix(mix)["draws"]

    def two(seed):
        g = torch.Generator().manual_seed(seed)
        return [window.draws(spec, _M, 16, g, e) for e in range(2)]
    a, b, c = two(2 ** 31 + 5), two(2 ** 31 + 5), two(2 ** 31 + 6)
    for ea, eb, ec in zip(a, b, c):
        for k in spec:
            assert torch.equal(ea[k], eb[k])
            assert not torch.equal(ea[k], ec[k])
            # every seed gets the episode's same values, dealt otherwise
            assert torch.equal(ea[k].flatten().sort().values,
                               ec[k].flatten().sort().values)
            lo, hi = spec[k]["low"], spec[k]["high"]
            assert float(ea[k].min()) >= lo and float(ea[k].max()) <= hi
    # each episode draws anew
    assert not torch.equal(a[0][next(iter(spec))], a[1][next(iter(spec))])


@pytest.mark.parametrize("mix", MIXES)
def test_plan_is_seeded_and_cuts_episodes_at_the_checks(mix):
    t = _mix(mix)
    p1 = window.Plan.make(t, 1024, 2 ** 31 + 9)
    p2 = window.Plan.make(t, 1024, 2 ** 31 + 9)
    assert np.array_equal(p1.rows, p2.rows)
    assert len(set(p1.rows.tolist())) == t["check"]["envs"]
    T, C = t["episode_steps"], t["chunk_steps"]
    for _ in range(4):
        (calls, checks), (calls2, checks2) = p1.episode(), p2.episode()
        assert (calls, checks) == (calls2, checks2)
        assert T - 1 in checks and 0 not in checks and len(checks) == 3
        assert min(checks) < T // 2
        at = 0
        for first, n in calls:
            assert first == at and 1 <= n <= C
            at += n
        assert at == T
        assert all((k, 1) in calls for k in checks)
