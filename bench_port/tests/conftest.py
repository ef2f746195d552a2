"""The benchmark's own tests: run from the checkout's root with
``python3 -m pytest bench_port/tests``; the card's tests carry the
``cuda`` marker and skip without a card."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(BENCH)
for p in (BENCH, CHECKOUT):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def early_checks(monkeypatch):
    """Checks at steps 1, 2 and the last of each episode, so a rehearsal
    on the CPU reaches one in a step or two."""
    from harness import window

    def episode(plan):
        T = plan.episode_steps
        checks = {1, 2, T - 1}
        return window.calls(T, plan.chunk_steps, checks), checks
    monkeypatch.setattr(window.Plan, "episode", episode)
