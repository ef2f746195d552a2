"""Card tests of the port (marked ``cuda``; they skip without a CUDA
device).  This file imports no jax: the machine with the card has none.
There, run it without the jax-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pathlib

import numpy as np
import pytest
import torch

import mujoco_sim_tpu_torch as mst
from mujoco_sim_tpu_torch.ops import chol

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _spd_batch(rng, N, n):
    A = rng.standard_normal((N, n, n))
    return A @ A.transpose(0, 2, 1) + n * np.eye(n)


def _case(name):
    """The cases of tests/test_pallas_chol.py."""
    rng = np.random.default_rng(0)
    if name == "n49_N130":
        return _spd_batch(rng, 130, 49), rng.standard_normal((130, 49))
    if name == "stiff_1e9":
        A = _spd_batch(rng, 4, 12)
        A[:, 0, 0] += 1e9                # stiff Newton-Hessian rows
        return A, rng.standard_normal((4, 12))
    A = _spd_batch(rng, 15, 7).reshape(5, 3, 7, 7)     # batched E x B
    return A, rng.standard_normal((5, 3, 7))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["n49_N130", "stiff_1e9", "batched_ExB"])
def test_kernel_matches_plain_twin(case, cuda_device):
    """f32 kernel vs f32 plain twin on the same CUDA tensors: the two round
    differently (FMA, multiply by the pivot's inverse), hence 2e-5 as in
    tests/test_pallas_chol.py."""
    A, b = _case(case)
    At = torch.tensor(A, dtype=torch.float32, device=cuda_device)
    bt = torch.tensor(b, dtype=torch.float32, device=cuda_device)
    before = chol.LAUNCHES
    x = chol.chol_solve(At, bt)
    torch.cuda.synchronize()
    assert chol.LAUNCHES == before + 1
    assert bool(torch.isfinite(x).all())
    torch.testing.assert_close(x, chol.chol_solve_plain(At, bt),
                               rtol=2e-5, atol=2e-5)
    r = (At @ x[..., None])[..., 0] - bt
    assert float(r.abs().max()) < 1e-2


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_it_cannot_take(cuda_device):
    A = torch.eye(3, device=cuda_device).expand(2, 3, 3)
    b = torch.ones(2, 3, device=cuda_device)
    with pytest.raises(ValueError):                     # not contiguous
        chol.chol_solve(A, b)
    with pytest.raises(TypeError):                      # not float32
        chol.chol_solve(A.double().contiguous(), b.double())
    with pytest.raises(ValueError):                     # n > 64
        chol.chol_solve(torch.eye(65, device=cuda_device)[None],
                        torch.ones(1, 65, device=cuda_device))


@pytest.mark.cuda
def test_step_on_card_runs_the_kernel(cuda_device):
    """f32 on the card: every SPD solve is a kernel launch (two per step
    plus one per Newton iteration) and qLD stays zero."""
    m = mst.put_model(mst.load_model(str(FIXTURES / "floor_box.xml")),
                      torch.float32, cuda_device)
    assert not torch.backends.cuda.matmul.allow_tf32
    d = mst.make_data(m, 64)
    qpos = d.qpos.clone()
    qpos[:, 2] = 0.1                         # start just above the floor
    before = chol.LAUNCHES
    d = mst.rollout(m, d.replace(qpos=qpos), 20)
    torch.cuda.synchronize()
    assert chol.LAUNCHES - before > 2 * 20
    assert bool((d.qLD == 0).all())
    assert bool(torch.isfinite(d.qpos).all() & torch.isfinite(d.qvel).all())
    assert int(d.ncon.min()) > 0
