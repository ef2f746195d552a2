"""Which Newton loop a model's constraint solve takes, and the recorder's
count of a loop run per env (runtime/profiler.count_loop), on the CPU.

The rule (ops/solver.takes_kernel) reads what the model and the
tensors show: a pyramidal or frictionless model with nv <= 64 on a CUDA
device takes the kernel (csrc/newton_solve.cu); elliptic models, nv > 64
and the CPU keep the lockstep loops (ops/solver._newton_lockstep).  The
kernel itself is held to the lockstep loops on the card
(tests/test_torch_cuda.py).
"""

import dataclasses
import pathlib

import pytest
import torch

from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.compile import load_model
from mujoco_sim_tpu_torch.models.model import ConeType
from mujoco_sim_tpu_torch.ops import newton_solve, solver
from mujoco_sim_tpu_torch.runtime import profiler
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
CUDA, CPU = torch.device("cuda", 0), torch.device("cpu")


@dataclasses.dataclass
class _Opt:
    cone: int


@dataclasses.dataclass
class _Shape:
    """What the rule reads of a model: its cone, contact slots and nv."""
    nv: int
    cone: int = int(ConeType.PYRAMIDAL)
    ncon_max: int = 8
    max_condim: int = 3

    @property
    def opt(self):
        return _Opt(self.cone)


@pytest.mark.parametrize("scene, nv, elliptic", [
    ("floor_box.xml", 6, False),          # mobile's nv, the box scenes
    ("manip_bin6.xml", 42, False),        # the manip cells
    ("box_pile11.xml", 66, False),        # the panel Cholesky's pile
    ("elliptic_box.xml", None, True),
    ("manip_bin6_precise.xml", 42, True),
])
def test_newton_path_of_each_scene(scene, nv, elliptic):
    """The fixtures' models: the kernel on the card exactly where the
    model is pyramidal (or frictionless) with nv <= 64; the lockstep loops
    on the CPU always."""
    m = load_model(str(FIXTURES / scene))
    if nv is not None:
        assert m.nv == nv
    assert solver._is_elliptic(m) == elliptic
    assert solver.takes_kernel(m, CUDA) == (not elliptic
                                                  and m.nv <= 64)
    assert not solver.takes_kernel(m, CPU)


@pytest.mark.parametrize("shape, device, kernel", [
    (_Shape(6), "cuda", True),
    (_Shape(42), "cuda", True),
    (_Shape(64), "cuda", True),
    (_Shape(65), "cuda", False),
    (_Shape(42, cone=int(ConeType.ELLIPTIC)), "cuda", False),
    # an elliptic model whose contacts are all frictionless solves as a
    # pyramidal one
    (_Shape(42, cone=int(ConeType.ELLIPTIC), max_condim=1), "cuda", True),
    (_Shape(6), "cpu", False),
    (_Shape(64), "cpu", False),
])
def test_newton_path_at_the_edges(shape, device, kernel):
    """nv 6 / 42 / 64 / 65, elliptic, frictionless and the CPU."""
    assert solver.takes_kernel(shape, device) == kernel


def test_cpu_solve_takes_the_lockstep_loops(monkeypatch):
    """A CPU step of a pyramidal model runs the lockstep loops and launches
    nothing; the model-level entry of the kernel refuses it."""
    m = engine.put_model(load_model(str(FIXTURES / "floor_box.xml")),
                         torch.float64, "cpu")
    d = engine.make_data(m, 2)
    qpos = d.qpos.clone()
    qpos[:, 2] = 0.1
    d = engine.fwd_position(m, d.replace(qpos=qpos))
    d = engine.fwd_acceleration(m, engine.fwd_actuation(
        m, engine.fwd_velocity(m, d)))
    ran = []
    lockstep = solver._newton_lockstep

    def spy(*args, **kw):
        out = lockstep(*args, **kw)
        ran.append(out[2])
        return out

    monkeypatch.setattr(solver, "_newton_lockstep", spy)
    with profiler.counting("cpu"):
        before = profiler.counts("cpu")["newton_solve"]
        out = solver.solve(m, d)
        assert profiler.counts("cpu")["newton_solve"] == before
    assert len(ran) == 1 and int(ran[0].min()) >= 1
    assert bool(torch.isfinite(out.qacc).all())
    with pytest.raises(ValueError, match="CUDA device"):
        solver.newton_kernel(m, d, d.efc_D, d.qacc_smooth, d.efc_aref,
                             d.qacc_smooth[:, 0])


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_shapes():
    """The raw entry checks shapes first, then device and type."""
    B, nefc, nv = 3, 5, 4
    f = lambda *s: torch.zeros(s, dtype=torch.float32)
    args = [f(B, nv, nv), f(B, nv), f(B, nefc, nv), f(B, nefc),
            torch.zeros(B, nefc, dtype=torch.int32), f(B, nefc),
            torch.zeros(B, nefc, dtype=torch.bool), f(B, nv), f(B, nefc),
            f(B)]
    opts = (1e-8, 0.01, 50, 20)
    with pytest.raises(ValueError, match="not a CUDA device"):
        newton_solve.newton_solve_cuda(*args, *opts)
    bad = list(args)
    bad[1] = f(B, nv + 1)
    with pytest.raises(ValueError, match="a_smooth"):
        newton_solve.newton_solve_cuda(*bad, *opts)
    wide = [f(B, 65, 65), f(B, 65), f(B, nefc, 65)] + args[3:7] + [
        f(B, 65), args[8], args[9]]
    with pytest.raises(ValueError, match="nv=65"):
        newton_solve.newton_solve_cuda(*wide, *opts)


def test_count_loop_adds_the_max_and_the_sum():
    """count_loop: the slowest env's iterations to ``.iters`` (what a
    lockstep WHILE node over the same envs would run) and the envs' own
    to ``.env_iters``, on the device's table while it counts, nothing
    outside."""
    newton = torch.tensor([3, 0, 7, 2], dtype=torch.int32)
    ls = torch.tensor([5, 0, 11, 4], dtype=torch.int32)
    before = profiler.counts(CPU)
    profiler.count_loop("newton", newton)           # not counting: no add
    assert profiler.counts(CPU) == before
    with profiler.counting(CPU):
        profiler.count_loop("newton", newton)
        profiler.count_loop("linesearch", ls)
        profiler.count_loop("newton", newton[:2])
    got = profiler.counts(CPU)
    delta = {k: got[k] - before[k] for k in got}
    assert delta["loop.newton.iters"] == 7 + 3
    assert delta["loop.newton.env_iters"] == 12 + 3
    assert delta["loop.linesearch.iters"] == 11
    assert delta["loop.linesearch.env_iters"] == 20
    assert all(v == 0 for k, v in delta.items()
               if not k.startswith(("loop.newton", "loop.linesearch")))


def _captured(N, nv, nefc, seed=0):
    """Newton-kernel inputs as chip_smoke's probe keeps them (by
    chip_smoke.NEWTON_ARGS), random on the CPU in float32: M SPD, D over
    four decades, every row type, friction loss on most friction rows, the
    carry a_smooth plus noise."""
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64)
    A = rn(N, nv, nv)
    M = A @ A.transpose(1, 2) / nv + torch.eye(nv, dtype=torch.float64)
    J, a_s = rn(N, nefc, nv), rn(N, nv)
    D = 10.0 ** (4 * torch.rand(N, nefc, generator=g, dtype=torch.float64))
    typ = torch.randint(0, 4, (N, nefc), generator=g, dtype=torch.int32)
    fon = (typ == 1) & (torch.rand(N, nefc, generator=g) < 0.7)
    floss = torch.where(fon, 0.1 + 5 * torch.rand(N, nefc, generator=g,
                                                  dtype=torch.float64), 0.0)
    a = a_s + 0.5 * rn(N, nv)
    x = (J @ a[..., None])[..., 0] - 3.0 * rn(N, nefc)
    f = lambda t: t.float()
    rows = dataclasses.make_dataclass("Rows", ["efc_type", "efc_frictionloss",
                                               "efc_floss_active"])(
        typ, f(floss), fon)
    da = f(a - a_s)
    cost = (0.5 * (da * (f(M) @ da[..., None])[..., 0]).sum(-1)
            + solver._rowcost_sum(rows, f(x), f(D)))
    return dict(M=f(M), a_smooth=f(a_s), J=f(J), D=f(D), efc_type=typ,
                floss=f(floss), floss_active=fon, a=f(a), x=f(x), cost=cost,
                tolerance=1e-8, ls_tolerance=0.01, iterations=50,
                ls_iterations=20)


def test_chip_smoke_holds_newton_answers_to_the_lockstep_loops():
    """chip_smoke.compare_newton, the card run's check of the kernel on a
    step's captured inputs, takes the lockstep loops' own answer given as
    the kernel's (and reads the float64 witness), and refuses one whose
    qacc is off by 10% or whose iteration counts spread past its limits."""
    import chip_smoke
    caps = [_captured(48, 8, 20, seed) for seed in (0, 1)]
    own = []
    for b in caps:
        a, x, it = chip_smoke._newton_lockstep(b)
        own.append((a, x, it, it.clone()))  # a line-search step each
    held = chip_smoke.compare_newton(caps, "cpu", own)
    assert held["envs"] == 96 and held["obj_gap"] == 0.0
    assert held["iters_off"] == {"0": 96}
    assert held["iters_mean"] >= 1
    w = held["vs_f64_lockstep"]
    assert w["kernel_obj_gap"] == w["lockstep_obj_gap"] < 1e-4
    off = [(1.1 * a, x, it, s) for a, x, it, s in own]
    with pytest.raises(AssertionError, match="objective|qacc"):
        chip_smoke.compare_newton(caps, "cpu", off)
    spread = [(a, x, it + 5, s + 5) for a, x, it, s in own]
    with pytest.raises(AssertionError, match="iterations"):
        chip_smoke.compare_newton(caps, "cpu", spread)


def test_chip_smoke_counts_the_newton_kernels_work():
    """chip_smoke._newton_counts / _newton_work: the bytes of one read of
    each env's inputs and one write of its answer, the flops of the
    iterations and line-search steps the launch reports and of the Hessian
    rows with curvature at its answer."""
    import chip_smoke
    b = _captured(4, 6, 10)
    a, x, it = chip_smoke._newton_lockstep(b)
    c = chip_smoke._newton_counts(b, (a, x, it, it + 1))
    _, curv = solver._row_force_and_curv(chip_smoke._newton_rows(b), x,
                                         b["D"])
    assert c == dict(envs=4, nv=6, nefc=10, iters=int(it.sum()),
                     ls_steps=int(it.sum()) + 4,
                     hess_rows=int((it * (curv != 0).sum(-1)).sum()))
    nbytes, flops = chip_smoke._newton_work(c)
    assert nbytes == 4 * (4 * (36 + 60 + 12 + 30 + 1) + 50 + 4 * 16 + 8)
    assert flops == (c["iters"] * (240 + 216 + 72) + c["hess_rows"] * 42
                     + c["ls_steps"] * 80)
