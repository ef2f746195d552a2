"""The port's compiled step on the CPU: ops/loops.while_loop against
``jax.vmap(jax.lax.while_loop)``, and utils/graph.StepGraph (the static-
buffer code a CUDA graph captures, run here without a capture) against
the eager ``engine.step`` it replays, through every entry point that
uses it.  f64; everything is held bit for bit: the graph runs the same
operations on the same values as the eager step."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.control import controllers as C
from mujoco_sim_tpu_torch.models.compile import load_model
from mujoco_sim_tpu_torch.ops import cuda_build, loops
from mujoco_sim_tpu_torch.parallel import egress, mesh as pmesh
from mujoco_sim_tpu_torch.parallel.rollout import RECURRENT, rollout
from mujoco_sim_tpu_torch.runtime.loop import SimLoop
from mujoco_sim_tpu_torch.runtime.sim import Simulation
from mujoco_sim_tpu_torch.utils.graph import StepGraph
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
STATE = ("time", "qpos", "qvel", "act", "qacc_warmstart")


def _same(a, b, leaves=STATE):
    for k in leaves:
        x, y = getattr(a, k), getattr(b, k)
        assert torch.equal(x, y), (k, float((x - y).abs().max()))


# ------------------------------------------------------------ while_loop

def _toy(nenv=64, seed=0):
    """Carries whose trip counts differ by env: x grows until x0 + x1
    passes 40 or the env's own cap is reached (caps 0..24, so some envs
    never iterate and some stop at their cap)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.1, 3.0, (nenv, 2))
    cap = rng.integers(0, 25, nenv).astype(np.int32)
    cap[:4] = 0
    return x, np.zeros(nenv, np.int32), cap


def _grow(x):
    # one rounding an element: XLA would contract a multiply-add into an
    # FMA, which torch does not
    return x * 1.25


def test_while_loop_matches_vmapped_lax_while_loop():
    x, i, cap = _toy()

    def jcond(c):
        x, i, cap = c
        return (i < cap) & (x[0] + x[1] < 40.0)

    def jbody(c):
        x, i, cap = c
        return _grow(x), i + 1, cap

    ref = jax.vmap(lambda c: jax.lax.while_loop(jcond, jbody, c))(
        (jnp.asarray(x), jnp.asarray(i), jnp.asarray(cap)))

    def cond(c):
        x, i, cap = c
        return (i < cap) & (x[:, 0] + x[:, 1] < 40.0)

    def body(c):
        x, i, cap = c
        return _grow(x), i + 1, cap

    carry = tuple(torch.tensor(v) for v in (x, i, cap))
    out = loops.while_loop(cond, body, carry)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(r), o.numpy())
    trips = out[1].numpy()
    assert len(set(trips.tolist())) > 5
    assert (trips == cap).any() and (trips < cap).any()
    # envs whose predicate is false at the start keep their carry
    np.testing.assert_array_equal(out[0].numpy()[:4], x[:4])
    # the caller's tensors are not written
    np.testing.assert_array_equal(carry[0].numpy(), x)


def test_nested_while_loop_matches_vmapped_lax():
    """A loop inside a loop's body (the line search inside a Newton
    iteration): the inner trip counts differ by env and by outer
    iteration."""
    x, i, cap = _toy(48, seed=3)
    cap = np.minimum(cap, 6)

    def inner_j(x):
        def cond(c):
            return (c[0][0] > 1.0) & (c[1] < 7)

        def body(c):
            return c[0] * 0.5, c[1] + 1
        return jax.lax.while_loop(cond, body, (x, jnp.int32(0)))

    def jbody(c):
        x, i, cap = c
        y, k = inner_j(_grow(x))
        return y + k, i + 1, cap

    ref = jax.vmap(lambda c: jax.lax.while_loop(
        lambda c: c[1] < c[2], jbody, c))(
        (jnp.asarray(x), jnp.asarray(i), jnp.asarray(cap)))

    def body(c):
        x, i, cap = c
        y, k = loops.while_loop(
            lambda c: (c[0][:, 0] > 1.0) & (c[1] < 7),
            lambda c: (c[0] * 0.5, c[1] + 1),
            (_grow(x), torch.zeros_like(i)))
        return y + k[:, None], i + 1, cap

    out = loops.while_loop(lambda c: c[1] < c[2], body,
                           tuple(torch.tensor(v) for v in (x, i, cap)))
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(r), o.numpy())


def test_while_loop_lanes_over_several_axes():
    """GJK's lanes carry several leading axes: the mask is (N, K) and a
    carry tensor (N, K, 3)."""
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.uniform(0.1, 2.0, (4, 5, 3)))
    cap = torch.tensor(rng.integers(0, 9, (4, 5)), dtype=torch.int32)
    out, it, _ = loops.while_loop(
        lambda c: c[1] < c[2], lambda c: (c[0] * 1.5, c[1] + 1, c[2]),
        (x, torch.zeros_like(cap), cap))
    assert torch.equal(it, cap)
    ref = x
    for k in range(9):
        ref = torch.where((k < cap)[..., None], ref * 1.5, ref)
    assert torch.equal(out, ref)


def test_plain_any_matches_the_predicate():
    m = torch.zeros(300, dtype=torch.bool)
    assert not bool(loops.any_plain(m))
    m[257] = True
    assert bool(loops.any_plain(m))


# ------------------------------------------------------------- StepGraph

def _scene(name, nenv=3, seed=0):
    m = engine.put_model(load_model(str(FIXTURES / name)), torch.float64,
                         "cpu")
    d = engine.make_data(m, nenv)
    rng = np.random.default_rng(seed)
    qvel = torch.tensor(rng.uniform(-0.5, 0.5, d.qvel.shape))
    ctrl = torch.tensor(rng.uniform(-0.3, 0.3, d.ctrl.shape))
    return m, d.replace(qvel=qvel, ctrl=ctrl)


@pytest.mark.parametrize("name", ["floor_box.xml", "manip_bin6.xml"])
def test_step_graph_matches_eager_step(name):
    m, d = _scene(name)
    g = StepGraph(engine.step)
    dg = de = d
    for _ in range(4):
        dg = g(m, dg)
        de = engine.step(m, de)
        _same(dg, de)
        assert torch.equal(dg.contact.dist, de.contact.dist)
        assert torch.equal(dg.efc_force, de.efc_force)
    assert g.captures == 1 and g.replays == 4


def test_step_graph_result_is_not_overwritten():
    m, d = _scene("floor_box.xml")
    g = StepGraph(engine.step)
    a = g(m, d)
    kept = {k: getattr(a, k).clone() for k in STATE}
    b = g(m, a)
    for k in STATE:
        assert torch.equal(getattr(a, k), kept[k]), k
    for k in ("time", "qpos", "qvel"):
        assert getattr(a, k).data_ptr() != getattr(b, k).data_ptr()
    # a leaf the step passes through is the caller's own tensor
    assert a.body_active is d.body_active
    assert a.geom_rgba is d.geom_rgba


def test_step_graph_sees_a_mask_flip_between_calls():
    m, d = _scene("floor_box.xml")
    g = StepGraph(engine.step)
    a = g(m, d)
    off = a.body_active.clone()
    off[:, 1] = False                    # despawn the box
    flipped = a.replace(body_active=off)
    _same(g(m, flipped), engine.step(m, flipped))
    on = g(m, a)
    assert not torch.equal(on.qvel, g(m, flipped).qvel)


def test_step_graph_honours_a_timestep_change():
    m, d = _scene("floor_box.xml")
    loop = SimLoop(m, d, real_time=False)
    dt = float(m.opt.timestep)
    a = loop.step_graph(loop.m, d)
    loop._set_dt(2 * dt)
    b = loop.step_graph(loop.m, d)
    _same(b, engine.step(loop.m, d))
    assert float(b.time[0]) == pytest.approx(2 * dt)
    assert float(a.time[0]) == pytest.approx(dt)
    loop._set_dt(dt)            # back to nominal: the first capture again
    _same(loop.step_graph(loop.m, d), a)
    assert loop.step_graph.captures == 2


def test_step_graph_run_matches_eager_loop():
    m, d = _scene("floor_box.xml")
    g = StepGraph(engine.step)
    out = g.run(m, d, n=5)
    de = d
    for _ in range(5):
        de = engine.step(m, de)
    _same(out, de)


# ---------------------------------------------------- entry points on it

def _eager_loop(m, d, n, ctrl_fn=None):
    for _ in range(n):
        if ctrl_fn is not None:
            d = d.replace(ctrl=ctrl_fn(d))
        d = engine.step(m, d)
    return d


@pytest.mark.parametrize("name", ["floor_box.xml", "manip_bin6.xml"])
def test_rollout_with_ctrl_fn_matches_eager_steps(name):
    m, d = _scene(name, nenv=4, seed=2)
    phase = torch.tensor(np.random.default_rng(7).uniform(
        0.0, 6.28, d.ctrl.shape))

    def ctrl_fn(d_):
        return torch.sin(4.0 * d_.time[:, None] + phase)

    _same(rollout(m, d, 5, ctrl_fn=ctrl_fn),
          _eager_loop(m, d, 5, ctrl_fn), STATE + ("ctrl",))
    short = rollout(m, d, 5, full_final=False)
    _same(short, _eager_loop(m, d, 5))
    assert short.xpos is d.xpos            # derived leaves stay the template


def test_sharded_rollout_and_step_match_eager_steps():
    m, d = _scene("floor_box.xml", nenv=4)
    mesh = pmesh.make_env_mesh(["cpu"] * 2)
    mR = pmesh.replicate_model(m, mesh)
    dS = pmesh.shard_batch(d, mesh)
    run = pmesh.make_sharded_rollout(mR, mesh, 6)
    out = run(mR, dS)
    assert len(run.graphs) == 2 and all(g.replays == 6 for g in run.graphs)
    _same(out.gather(), _eager_loop(m, d, 6))
    one = pmesh.make_sharded_step(mR, mesh)(mR, dS)
    _same(one.gather(), engine.step(m, d))


def test_rollout_collect_and_traj_match_eager_steps():
    m, d = _scene("floor_box.xml", nenv=4)
    ref, de = [], d
    for _ in range(8):
        de = engine.step(m, de)
        ref.append(de.qpos)
    ref = torch.stack(ref).numpy()
    final, traj = pmesh.rollout_traj(m, d, 8)
    np.testing.assert_array_equal(traj.numpy(), ref)
    _same(final, de)
    mesh = pmesh.make_env_mesh(["cpu"] * 2)
    mR = pmesh.replicate_model(m, mesh)
    cache = {}
    final, host = egress.rollout_collect(mR, pmesh.shard_batch(d, mesh), 8,
                                         chunk=4, jit_cache=cache)
    np.testing.assert_array_equal(host, ref)
    _same(final.gather(), de)
    assert sum(1 for k in cache if k[0] == "graph") == 2


def test_scan_reduced_matches_eager_steps():
    m, d = _scene("floor_box.xml")
    _same(pmesh.scan_reduced(lambda d_: engine.step(m, d_), d, 4),
          _eager_loop(m, d, 4))


def test_step_with_control_matches_eager():
    m, d = _scene("manip_bin6.xml", nenv=2)
    cfg = C.pd_config_for_joints(
        m, [m.names.joint[j] for j in range(m.njnt)
            if int(m.layout.jnt_type[j]) in (2, 3)][:3])
    st = C.make_pd_state(m, 2)
    des = d.qpos[:, cfg.dof_qposadr] + 0.1

    def ctrl(m_, d_, st_):
        st_ = C.pd_accel(cfg, st_, d_, des, 0.002)
        return C.apply_control(m_, d_, st_, cfg.ctrl_mask)

    dg, sg = d, st
    de, se = d, st
    for _ in range(3):
        dg, sg = engine.step_with_control(m, dg, ctrl, sg)
        de, se = engine.step_with_control_eager(m, de, ctrl, se)
        _same(dg, de)
        assert torch.equal(sg.err_int, se.err_int)


def test_simulation_step_and_reset_through_graphs():
    m = load_model(str(FIXTURES / "floor_box.xml"))
    sim = Simulation(m, dtype=torch.float64, device="cpu")
    d0 = sim.d
    sim.step(3)
    _same(sim.d, _eager_loop(sim.m, d0, 3))
    assert sim.step_graph.replays == 3
    sim.reset()
    ref = engine.forward(sim.m, sim.d)
    _same(sim.d, ref)
    assert torch.equal(sim.d.xpos, ref.xpos)


# ------------------------------------------- replay counts by kernel name

def _chip_smoke():
    """chip_smoke.py as a module (it imports torch and numpy only at its
    top; nothing runs until main)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", FIXTURES.parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _globals_in_csrc():
    """The names of the __global__ functions in mujoco_sim_tpu_torch/csrc/,
    comments stripped."""
    src = FIXTURES.parent.parent / "mujoco_sim_tpu_torch" / "csrc"
    found = {}
    for f in sorted(src.glob("*.cu*")):
        text = re.sub(r"//[^\n]*|/\*.*?\*/", "", f.read_text(), flags=re.S)
        for name in re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                r"(\w+)\s*\(", text):
            found[name] = f.name
    return found


def test_replay_counts_name_every_kernel_in_csrc():
    """chip_smoke.py counts the hand-written kernels of each replayed step
    by the names of their __global__ functions, as ops/cuda_build.KERNELS
    lists them (REPLAY_KERNELS): each __global__ in csrc/ is named there
    under a kernel's launch count, and each name there is a __global__, so
    a kernel added later cannot drop out of the replay counts."""
    from mujoco_sim_tpu_torch.runtime import profiler
    cs = _chip_smoke()
    found = _globals_in_csrc()
    assert len(found) >= 9, found
    named = {g for gs in cs.REPLAY_KERNELS.values() for g in gs}
    assert set(found) <= named, sorted(set(found) - named)
    assert named <= set(found), sorted(named - set(found))
    assert set(cs.REPLAY_KERNELS) == set(profiler.LAUNCH_COUNTS)


@pytest.mark.parametrize("name", sorted(cuda_build.KERNELS))
def test_kernel_table_row_names_what_exists(name):
    """A row of ops/cuda_build.KERNELS: its source and the shared headers
    exist, each function it names is a __global__ of its own source, and
    its launch count is a slot of the recorder's table."""
    from mujoco_sim_tpu_torch.runtime import profiler
    row = cuda_build.KERNELS[name]
    assert pathlib.Path(cuda_build.source_path(name)).is_file()
    for h in cuda_build.HEADERS:
        assert (pathlib.Path(cuda_build.CSRC_DIR) / h).is_file(), h
    found = _globals_in_csrc()
    assert row.functions
    for g in row.functions:
        assert found.get(g) == row.source, g
    assert row.slot in profiler.SLOTS


@pytest.mark.parametrize("rc", [0, 2, 700])
def test_launch_errors_name_the_entry_and_the_code(rc, monkeypatch):
    """cuda_build.check raises on a cudaError other than 0, naming the C
    entry and the code, and passes on 0; launch checks what its entry
    returns (the current device and stream stubbed: no card here)."""
    def chol_solve_f32(*args):
        return rc

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    calls = (lambda: cuda_build.check(rc, "chol_solve_f32"),
             lambda: cuda_build.launch(torch.device("cuda", 0),
                                       chol_solve_f32, 1, 2))
    for call in calls:
        if rc == 0:
            assert call() is None
        else:
            with pytest.raises(RuntimeError, match=(
                    f"^chol_solve_f32 failed: cudaError {rc}$")):
                call()


def test_replay_counts_read_demangled_kernel_names():
    """The profiler's names of the kernels as they launch (templates,
    anonymous namespaces, argument lists) map to their wrapper's count;
    PyTorch's own kernels, a name that merely contains one, map to
    none."""
    cs = _chip_smoke()
    for key, names in cs.REPLAY_KERNELS.items():
        for g in names:
            for shown in (f"void (anonymous namespace)::{g}<48>(float const*, "
                          "int)", f"{g}(satk::Query)",
                          f"void {g}<satk::Layout<8, 4, 6, false>, true>()"):
                assert cs._hand_written(shown) == key, shown
    for other in ("void at::native::elementwise_kernel<128, 2>(int)",
                  "void at::native::offset_set_any<4>(int)",
                  "Memcpy DtoD (Device -> Device)",
                  "void chol_solve_kernel_v2(float const*)"):
        assert cs._hand_written(other) is None, other


def test_launch_counts_on_the_card_only():
    """The hand-written kernels' launch counts for a graph's replays are
    added on a CUDA device only: a CPU device keeps the recorder's table (its steps
    count), but the twins on the CPU launch nothing, so its launch counts
    stay 0; and a launch where no counts are kept adds nothing."""
    from mujoco_sim_tpu_torch.runtime import profiler
    m, d = _scene("floor_box.xml")
    before = profiler.counts("cpu")
    with profiler.counting("cpu"):
        engine.step(m, d)
    got = profiler.counts("cpu")
    assert {k: got[k] for k in profiler.LAUNCH_COUNTS} == dict.fromkeys(
        profiler.LAUNCH_COUNTS, 0)
    assert profiler.counts("cpu")["step.count"] == before["step.count"] + 1
    profiler.count("chol_solve", torch.device("cuda", 0))
    assert not profiler._MODE
    assert set(profiler.LAUNCH_COUNTS) == set(_chip_smoke().REPLAY_KERNELS)


def test_counting_is_kept_inside_its_block_only(monkeypatch):
    """profiler.counting(device): launches count inside the block, on
    the device's one count tensor, and stop counting when the block ends,
    by an exception too; a nested block leaves the outer one counting.  A
    CPU tensor stands in for the card's counts (no card here)."""
    from mujoco_sim_tpu_torch.runtime import profiler
    dev = torch.device("cuda", 0)
    counts = torch.zeros(len(profiler.SLOTS), dtype=torch.int64)
    monkeypatch.setitem(profiler._TABLES, dev, counts)
    i = profiler.SLOTS.index("mtv_query")
    with profiler.counting(dev):
        profiler.count("mtv_query", dev)
        with profiler.counting("cuda:0"):
            profiler.count("mtv_query", dev)
        profiler.count("mtv_query", dev)
    profiler.count("mtv_query", dev)
    assert int(counts[i]) == 3 and int(counts.sum()) == 3
    with pytest.raises(RuntimeError):
        with profiler.counting(dev):
            raise RuntimeError("a failed capture")
    assert not profiler._MODE
    profiler.count("mtv_query", dev)
    assert int(counts[i]) == 3
    assert profiler.counts(dev)["mtv_query"] == 3
    assert profiler._TABLES[dev] is counts


def test_capture_gives_the_warmups_blocks_back_first(monkeypatch):
    """StepGraph on a card: the warm-up call, then the caching allocator's
    free blocks given back to the card (empty_cache: the capture's private
    pool cannot reuse them, and manip_bin6 at 65 536 envs kept ~30 GB of
    them), then the capture.  The CUDA calls are stubbed and their order
    recorded: a capture needs a card."""
    import contextlib
    from mujoco_sim_tpu_torch.utils import graph as G
    calls = []

    @contextlib.contextmanager
    def capture(graph, dev):
        calls.append("capture")
        yield

    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: calls.append("sync"))
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: calls.append("empty_cache"))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev=None: 0)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(G.loops, "capture", capture)

    def fn(_, x):
        calls.append("fn")
        return x + 1.0

    g = StepGraph(fn)
    x = torch.zeros(3, dtype=torch.float64)
    assert torch.equal(g(None, x), x + 1.0)       # the CPU path: no capture
    calls.clear()
    g.last._warm_and_capture(torch.device("cpu"))
    assert calls == ["fn", "sync", "empty_cache", "capture", "fn", "sync"]
