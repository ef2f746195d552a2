"""The feature clip of the deep-pair exact manifold (ops/manifold.feature_clip):
the plain twin on the CPU, the kernel of csrc/feature_clip.cu against it on a
card (marked ``cuda``; they skip without one), and the recorder's count of
the live deep slots.  This file imports no jax; on the card machine run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_feature_clip.py

On the card the kernel is held to the twin run on the CPU on the same
float32 inputs by chip_smoke.compare_clip, whose note says what it holds
equal and how close the points must come (corners that tie in exact
arithmetic).
"""

import pathlib

import numpy as np
import pytest
import torch

import mujoco_sim_tpu_torch as mst
from mujoco_sim_tpu_torch.ops import manifold, mtv_query
from mujoco_sim_tpu_torch.parallel.rollout import rollout_eager
from mujoco_sim_tpu_torch.runtime import profiler
from mujoco_sim_tpu_torch.utils import kernel_cases
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
ORDER = kernel_cases.CLIP_ORDER


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _tensors(b, device="cpu", dtype=torch.float32):
    return [torch.tensor(b[k], device=device,
                         dtype=dtype if b[k].dtype == np.float64 else None)
            for k in ORDER]


def hold(args, got):
    """The kernel's result ``got`` on ``args`` held to the twin's on the
    CPU (chip_smoke.compare_clip, which raises where they part); returns
    (live lanes, lanes a tie decides)."""
    import chip_smoke
    r = chip_smoke.compare_clip(dict(zip(ORDER, args)), "test", got)
    return r["live"], r["ties"]


# ------------------------------------------------------------------- CPU

@pytest.mark.parametrize("case", kernel_cases.CLIP_CASES)
def test_wrapper_takes_the_twin_on_the_cpu(case):
    """On CPU tensors feature_clip is the plain twin, bit for bit, and
    launches nothing; each hand-built lane gives its feature's rows: a
    face pair four, an edge on a face two, crossing edges one, a vertex
    one, a cylinder's side three (its two ends and the midpoint), its cap
    four, its rim one, the closest-boundary fallback one; a separated pair
    none and a positive certificate; a lane not enabled the miss tuple."""
    b, rows = kernel_cases.clip_case((case,))
    args = _tensors(b)
    before = manifold.LAUNCHES
    got = manifold.feature_clip(*args)
    ref = manifold.feature_clip_plain(*args)
    assert manifold.LAUNCHES == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    dist, pos, n, ok, sepd = got
    assert int((dist[0] < 1e8).sum()) == rows[0]
    assert bool(ok[0]) == (rows[0] > 0)
    assert bool(sepd[0] > 0) == (case == "separated")
    if not b["enabled"][0]:
        assert torch.equal(dist[0], torch.full((4,), 1e9))
        assert torch.equal(pos[0], torch.zeros(4, 3))
        assert torch.equal(n[0], torch.tensor([0.0, 0.0, 1.0]))


def test_exact_pair_contacts_is_the_query_then_the_clip():
    """exact_pair_contacts on the CPU is clip_inputs (gathers, transforms,
    the query) followed by the twin, bit for bit."""
    tables, cyl, _ = kernel_cases.clip_tables()
    t = lambda x: torch.tensor(x)
    b, _ = kernel_cases.clip_case()
    L = len(kernel_cases.CLIP_CASES)
    rng = np.random.default_rng(3)
    pB = t(rng.normal(size=(L, 3)) * 0.05 + [0.0, 0.0, 0.19])
    RA = t(np.tile(np.eye(3), (L, 1, 1)))
    q = np.linalg.qr(rng.normal(size=(L, 3, 3)))[0]
    RB = t(q * np.sign(np.linalg.det(q))[:, None, None])
    hidA = t(b["hidA"])
    hidB = t(b["hidB"])
    cy = lambda h: manifold.gather_hull(h, t(cyl))
    tab = {k: t(v) for k, v in tables.items()}
    en = t(b["enabled"])
    got = manifold.exact_pair_contacts(t(np.zeros((L, 3))), RA, hidA,
                                       cy(hidA), pB, RB, hidB, cy(hidB),
                                       en, tab)
    ref = manifold.feature_clip_plain(*manifold.clip_inputs(
        t(np.zeros((L, 3))), RA, hidA, cy(hidA), pB, RB, hidB, cy(hidB),
        tab, mtv=mtv_query.mtv_query_plain), en)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("case", kernel_cases.MTV_BIG_CASES)
def test_twin_on_the_large_tables(case):
    """The pebbles' full-hull tables (V = 256 and 1200), laid out as the
    compaction hands them over: finite contacts on every live lane that
    the query found penetrating, the miss tuple on the empty slots."""
    b = kernel_cases.clip_big_case(case, 10)
    args = _tensors(b)
    dist, pos, n, ok, sepd = manifold.feature_clip(*args)
    live = torch.tensor(b["enabled"])
    assert bool(ok[live].all())
    assert bool(((dist[live] < 1e8).sum(-1) >= 1).all())
    assert bool(torch.isfinite(pos[live]).all())
    assert bool((dist[~live] == 1e9).all() & (pos[~live] == 0).all())


def test_wrapper_rejects_another_device():
    b, _ = kernel_cases.clip_case(("face_face",))
    with pytest.raises(ValueError, match="unsupported device"):
        manifold.feature_clip(*_tensors(b, device="meta"))


def test_deep_lanes_count_the_enabled_slots():
    """profiler's deep.lanes: the slots the compaction enabled, summed
    over the mesh-mesh group calls of the steps it counted (manip_bin6 at
    4 envs, every contacting mesh pair exact), equal to the enabled lanes
    the clip was handed; the CPU launches no kernel, so its launch count
    stays 0."""
    m = mst.put_model(mst.load_model(str(FIXTURES / "manip_bin6.xml")),
                      torch.float64, "cpu")
    m = m.replace(opt=m.opt.replace(exact_meshcollide=1))
    d = rollout_eager(m, mst.make_data(m, 4), 20)
    seen = []
    real = manifold.feature_clip

    def clip(*a):
        seen.append(int(a[-1].sum()))
        return real(*a)

    manifold.feature_clip = clip
    try:
        before = profiler.counts("cpu")
        with profiler.counting("cpu"):
            rollout_eager(m, d, 3)
        got = profiler.counts("cpu")
    finally:
        manifold.feature_clip = real
    assert len(seen) == 3 and sum(seen) > 0
    assert got["deep.lanes"] - before["deep.lanes"] == sum(seen)
    assert got["feature_clip"] == before["feature_clip"] == 0


# ------------------------------------------------------------------ card

@pytest.mark.cuda
def test_kernel_on_the_hand_built_lanes(cuda_device):
    b, _ = kernel_cases.clip_case()
    args = _tensors(b, cuda_device)
    before = manifold.LAUNCHES
    got = manifold.feature_clip(*args)
    torch.cuda.synchronize()
    assert manifold.LAUNCHES == before + 1
    live, ties = hold(args, got)
    assert live == 9 and ties == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", kernel_cases.MTV_BIG_CASES)
@pytest.mark.parametrize("N,live", [(5, None), (130, None), (8192, "few")])
def test_kernel_on_the_large_tables(case, N, live, cuda_device):
    """The pebbles (V = 256, 1200; F = 508, 2396), their empty slots and
    cylinder-flagged lanes; at 8192 lanes with the bighull step's pattern
    (a few live among empty slots, every input of an empty one zero)."""
    if live is None:
        b = kernel_cases.clip_big_case(case, N)
    else:
        base = kernel_cases.clip_big_case(case, 10)
        lanes = np.array([0, 17, 1000, 4095, 5001, 7777, 8191])
        b = {}
        for k, v in base.items():
            if k == "fpoly":
                b[k] = v
                continue
            x = np.zeros((N,) + v.shape[1:], v.dtype)
            if k in ("hidA", "hidB"):
                x[:] = -1
            x[lanes] = v[[0, 1, 3, 4, 5, 6, 8]]
            b[k] = x
    args = _tensors(b, cuda_device)
    got = manifold.feature_clip_cuda(*args)
    torch.cuda.synchronize()
    n_live, ties = hold(args, got)
    assert n_live == int(b["enabled"].sum()) > 0


@pytest.mark.cuda
def test_kernel_on_the_manip_lanes(cuda_device):
    """The lanes _mesh_mesh hands the clip in 40 stirred steps of manip_bin6
    at 64 envs on the card, every contacting mesh pair exact (every fifth
    step's call kept), and the count of live slots the recorder keeps
    there."""
    m = mst.put_model(mst.load_model(str(FIXTURES / "manip_bin6.xml")))
    m = m.replace(opt=m.opt.replace(exact_meshcollide=1))
    phase = torch.tensor(np.random.default_rng(1).uniform(0, 6.28, (64, m.nu)),
                         dtype=torch.float32, device=cuda_device)
    kept, calls = [], [0]
    real = manifold.feature_clip

    def clip(*a):
        calls[0] += 1
        if calls[0] % 5 == 0:
            kept.append([x.clone() for x in a])
        return real(*a)

    manifold.feature_clip = clip
    before = manifold.LAUNCHES
    try:
        rollout_eager(m, mst.make_data(m, 64), 40,
                      ctrl_fn=lambda d_: torch.sin(4.0 * d_.time[:, None]
                                                   + phase))
    finally:
        manifold.feature_clip = real
    torch.cuda.synchronize()
    assert manifold.LAUNCHES - before == calls[0] == 40
    live = ties = 0
    for args in kept:
        got = manifold.feature_clip_cuda(*args)
        lv, t = hold(args, got)
        live, ties = live + lv, ties + t
    assert live > 0


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_it_cannot_take(cuda_device):
    b, _ = kernel_cases.clip_case(("face_face", "vertex_face"))
    args = _tensors(b, cuda_device)
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(TypeError):                      # not float32
        manifold.feature_clip_cuda(*bad)
    bad = list(args)
    bad[ORDER.index("enabled")] = args[ORDER.index("enabled")].float()
    with pytest.raises(TypeError):                      # enabled not bool
        manifold.feature_clip_cuda(*bad)
    bad = list(args)
    bad[ORDER.index("fpoly")] = args[ORDER.index("fpoly")][..., :8, :]
    with pytest.raises(ValueError):                     # 16-row polygons
        manifold.feature_clip_cuda(*bad)
    bad = list(args)
    bad[0] = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):                     # not contiguous
        manifold.feature_clip_cuda(*bad)
