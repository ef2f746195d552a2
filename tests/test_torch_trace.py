"""The port's recorder (runtime/profiler.py): off by default and then
absent from every graph; the table of counts, the ring of stage stamps
and the host spans on the CPU, held to independent counts; and on the
card (marked ``cuda``; they skip without one) the stamp kernel, a traced
graph's counts against eager steps, the stamps' clock against the
profiler's and a graph captured with tracing off.  No JAX: the card runs
this file too,

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_trace.py
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from mujoco_sim_tpu_torch import engine
from mujoco_sim_tpu_torch.models.compile import load_model
from mujoco_sim_tpu_torch.ops import cuda_build, loops, trace_stamp
from mujoco_sim_tpu_torch.parallel import mesh as pmesh
from mujoco_sim_tpu_torch.parallel import rollout as prollout
from mujoco_sim_tpu_torch.runtime import profiler
from mujoco_sim_tpu_torch.utils.graph import StepGraph
from tests.torch_threads import one_thread  # noqa: F401 (autouse)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def no_spans_left():
    profiler.clear_spans()
    yield
    profiler.clear_spans()


def _scene(name, nenv, seed=0, dtype=torch.float64, device="cpu"):
    m = engine.put_model(load_model(str(FIXTURES / name)), dtype, device)
    d = engine.make_data(m, nenv)
    rng = np.random.default_rng(seed)
    qvel = torch.tensor(rng.uniform(-0.5, 0.5, d.qvel.shape), dtype=dtype,
                        device=device)
    ctrl = torch.tensor(rng.uniform(-0.3, 0.3, d.ctrl.shape), dtype=dtype,
                        device=device)
    return m, d.replace(qvel=qvel, ctrl=ctrl)


class _Refuse(dict):
    def __getitem__(self, key):
        raise AssertionError(f"the recorder's table of {key} was written")


# ------------------------------------------------------------------ the CPU

def test_tracing_off_records_nothing_and_runs_no_recorder_code(monkeypatch):
    """With recording off, a StepGraph body (on the CPU it runs at every
    replay) reaches neither stamp function nor any table, and no span is
    recorded (a capture's span is recorded always, but the CPU makes no
    capture)."""
    def refuse(*a, **k):
        raise AssertionError("a stamp was written")
    monkeypatch.setattr(trace_stamp, "stamp_plain", refuse)
    monkeypatch.setattr(trace_stamp, "stamp_cuda", refuse)
    monkeypatch.setattr(profiler, "_TABLES", _Refuse())
    monkeypatch.setattr(profiler, "_RINGS", _Refuse())
    m, d = _scene("floor_box.xml", 2)
    g = StepGraph(engine.step)
    g.run(m, g(m, d), n=2)
    prollout.batched_step(m, d)
    assert profiler.spans() == [] and not profiler._MODE
    assert profiler.mode(CPU) == profiler.OFF


def test_capture_key_differs_by_tracing_state():
    """A capture is keyed on what the recorder records on its device:
    turning tracing (or counting) on or off makes a new capture, and a
    tracing block with no device leaves the key as it was."""
    m, d = _scene("floor_box.xml", 2)
    g = StepGraph(engine.step)
    g(m, d)
    with profiler.tracing():
        g(m, d)
    assert g.captures == 1
    with profiler.tracing(CPU):
        assert profiler.mode(CPU) == profiler.TRACE
        g(m, d)
        g(m, d)
    assert g.captures == 2
    with profiler.counting(CPU):
        assert profiler.mode(CPU) == profiler.COUNT
        g(m, d)
    g(m, d)
    assert g.captures == 4 and profiler.mode(CPU) == profiler.OFF


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent.id]


def test_span_tree_of_batched_step_and_scan_reduced(tmp_path):
    """One batched_step call: its entry span with graph.load, graph.replay
    and graph.result under it, all with the call's id; a scan_reduced
    segment of 3 steps: its entry span with 3 replays.  Self time is the
    duration minus the children's cover, and the spans write out as one
    JSON object a line."""
    m, d = _scene("floor_box.xml", 2)
    prollout.batched_step(m, d)
    step = lambda c: engine.step(m, c)
    pmesh.scan_reduced(step, d, 1)
    with profiler.tracing():
        prollout.batched_step(m, d)
        pmesh.scan_reduced(step, d, 3)
    spans = profiler.spans()
    top = [s for s in spans if s.parent is None]
    assert [s.name for s in top] == ["rollout.batched_step",
                                     "mesh.scan_reduced"]
    assert top[0].call != top[1].call
    assert _children(spans, top[0]) == ["graph.load", "graph.replay",
                                        "graph.result"]
    assert _children(spans, top[1]) == ["graph.load"] + ["graph.replay"] * 3 \
        + ["graph.result"]
    for s in spans:
        parent = next((p for p in top if p.id == s.parent), s)
        assert s.call == parent.call and s.end_ns >= s.start_ns
        if s.parent is not None:
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    assert all(s.attrs["bytes"] > 0 for s in spans
               if s.name in ("graph.load", "graph.result"))
    own = profiler.self_ns(spans)
    for p in top:
        kids = sum(s.end_ns - s.start_ns for s in spans if s.parent == p.id)
        assert own[p.id] == p.end_ns - p.start_ns - kids
    path = tmp_path / "spans.jsonl"
    profiler.write_spans(str(path))
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["name"] for x in lines] == [s.name for s in spans]


def test_self_time_counts_overlapping_children_once():
    S = profiler.Span
    spans = [S("a", 0, 100, id=0), S("b", 10, 40, id=1, parent=0),
             S("c", 30, 60, id=2, parent=0), S("d", 90, 120, id=3,
                                                parent=0)]
    assert profiler.self_ns(spans)[0] == 100 - 50 - 10


def test_ring_row_per_replay_in_stage_order():
    """StepGraph.run of 3 steps while tracing writes 3 ring rows, each
    stage's stamps in the order the step runs them, inside its replay's
    span (on the CPU the stamps are on the spans' clock)."""
    m, d = _scene("floor_box.xml", 2)
    g = StepGraph(engine.step)
    with profiler.tracing(CPU):
        profiler.reset(CPU)
        profiler.clear_spans()
        g.run(m, d, n=3)
        rows = profiler.ring(CPU)
        assert profiler.counts(CPU)["step.count"] == 3
    replays = [s for s in profiler.spans() if s.name == "graph.replay"]
    assert len(rows) == len(replays) == 3
    for row, rep in zip(rows, replays):
        vals = [row[k] for k in profiler.STAMPS]
        assert vals == sorted(vals) and vals[0] > 0
        assert rep.start_ns <= vals[0] and vals[-1] <= rep.end_ns
    assert rows[0]["integrate.end"] <= rows[1]["position.start"]


def test_loop_and_contact_counts_match_an_independent_count(monkeypatch):
    """manip_bin6 at 8 envs, 2 stirred steps: each named loop's
    iterations and the envs active in them, counted by the recorder,
    equal a count made around the loop's own cond_fn/body_fn; the
    contacts equal the steps' d.ncon summed."""
    real = loops.while_loop
    seen = {}

    def counted(cond_fn, body_fn, carry, name=None):
        rec = seen.setdefault(name, [0, 0])
        masks = []

        def cond(c):
            mask = cond_fn(c)
            masks.append(int(mask.sum()))
            return mask

        def body(c):
            rec[0] += 1
            rec[1] += masks[-1]
            return body_fn(c)
        return real(cond, body, carry, name)

    monkeypatch.setattr(loops, "while_loop", counted)
    m, d = _scene("manip_bin6.xml", 8, seed=3)
    ncon = 0
    with profiler.counting(CPU):
        profiler.reset(CPU)
        for _ in range(2):
            d = engine.step(m, d)
            ncon += int(d.ncon.sum())
        c = profiler.counts(CPU)
    assert seen["newton"][0] > 0 and seen["linesearch"][0] > 0
    for name in profiler.LOOPS:
        it, env = seen.get(name, (0, 0))
        assert (c[f"loop.{name}.iters"], c[f"loop.{name}.env_iters"]) == \
            (it, env), name
    assert c["contacts"] == ncon > 0 and c["step.count"] == 2


def test_span_start_is_on_the_profilers_clock():
    """Under torch.profiler a span is also a record_function range; its
    start lies within 50 us of that event's (one host clock): the median
    over five spans, so that a preemption between the two reads does not
    decide it; every span's range lies in its own."""
    from torch.profiler import ProfilerActivity, profile
    with profiler.tracing(), profile(activities=[ProfilerActivity.CPU]) as p:
        with profiler.span("warm.record_function"):
            pass
        for i in range(5):
            with profiler.span(f"probe.{i}"):
                torch.ones(8).sum()
    mine = {s.name: s for s in profiler.spans()}
    events = {e.name(): e for e in p.profiler.kineto_results.events()
              if e.name().startswith("probe.")}
    assert len(events) == 5
    gaps = sorted(abs(e.start_ns() - mine[n].start_ns)
                  for n, e in events.items())
    assert gaps[2] < 50_000, gaps
    for name, e in events.items():
        assert mine[name].start_ns - 50_000 <= e.start_ns() <= \
            e.start_ns() + e.duration_ns() <= mine[name].end_ns + 50_000


def test_setup_spans(monkeypatch, tmp_path):
    """The set-up spans: the kernel build and put_model, each an entry of
    its own."""
    monkeypatch.setattr(cuda_build, "KERNELS", {})
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    m = load_model(str(FIXTURES / "floor_box.xml"))
    with profiler.tracing():
        cuda_build.build_all()
        engine.put_model(m, torch.float64, "cpu")
    spans = profiler.spans()
    assert [s.name for s in spans] == ["cuda_build.build_all",
                                       "engine.put_model"]
    assert all(s.parent is None for s in spans)
    assert spans[0].call != spans[1].call


def test_device_offset_pairs_stamps_with_their_kernels():
    """device_offset_ns on a made-up trace whose stamp kernels start 1500
    ns before their stamps (and one 200 ns later still): mean and
    spread."""
    m, d = _scene("floor_box.xml", 2)
    with profiler.tracing(CPU):
        profiler.reset(CPU)
        for _ in range(2):
            d = engine.step(m, d)
    stamps = [v for row in profiler.ring(CPU) for v in row.values()]
    recs = [("void trace_stamp_kernel(long long*)", v - 1500, v)
            for v in stamps]
    recs[5] = (recs[5][0], recs[5][1] - 200, recs[5][2])
    recs.append(("other_kernel", 0, 10))
    mean, spread = profiler.device_offset_ns(recs, CPU)
    assert spread == 200
    assert mean == pytest.approx(1500 + 200 / len(stamps))


# ------------------------------------------------------------------ the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _stirred(m, nenv, seed=1):
    phase = torch.tensor(np.random.default_rng(seed).uniform(
        0, 6.28, (nenv, m.nu)), dtype=torch.float32, device="cuda")
    return lambda d_: torch.sin(4.0 * d_.time[:, None] + phase)


@pytest.mark.cuda
def test_trace_stamp_builds_and_writes_increasing_values(cuda_device):
    ring = torch.zeros((4, 16), dtype=torch.int64, device=cuda_device)
    table = torch.zeros(len(profiler.SLOTS), dtype=torch.int64,
                        device=cuda_device)
    step, count = profiler.STEP, profiler.SLOTS.index("trace_stamp")
    for row in range(2):
        for slot in range(16):
            trace_stamp.stamp_cuda(ring, table, slot, step, count)
        table[step].add_(1)
    torch.cuda.synchronize()
    vals = ring[:2].reshape(-1).tolist()
    assert vals == sorted(vals) and vals[-1] > vals[0] > 0
    assert ring[2:].abs().sum() == 0
    assert int(table[count]) == 32 and int(table[step]) == 2


@pytest.mark.cuda
def test_traced_graph_counts_like_eager_steps(cuda_device):
    """A manip step graph captured while tracing: over 4 replays it counts
    the launches, loop iterations, contacts and steps that 4 eager steps
    from the same state count under counting (the graph is bit-equal to
    eager), with one ring row a replay and 16 stamps each; the WHILE
    predicate runs in the replays only."""
    from mujoco_sim_tpu_torch.utils import graph
    m, _ = _scene("manip_bin6.xml", 32, dtype=torch.float32, device="cuda")
    ctrl_fn = _stirred(m, 32)
    d = prollout.rollout(m, engine.make_data(m, 32), 3, ctrl_fn=ctrl_fn)
    try:
        graph.clear_all()
        with profiler.tracing(cuda_device):
            prollout.rollout(m, d, 1, ctrl_fn=ctrl_fn)     # the capture
            profiler.reset(cuda_device)
            got = prollout.rollout(m, d, 4, ctrl_fn=ctrl_fn)
            traced = profiler.counts(cuda_device)
            rows = profiler.ring(cuda_device)
        with profiler.counting(cuda_device):
            profiler.reset(cuda_device)
            want = prollout.rollout_eager(m, d, 4, ctrl_fn=ctrl_fn)
            eager = profiler.counts(cuda_device)
    finally:
        graph.clear_all()
    assert torch.equal(got.qpos, want.qpos)
    same = [k for k in profiler.SLOTS if k not in ("graph_loop",
                                                   "trace_stamp")]
    assert {k: traced[k] for k in same} == {k: eager[k] for k in same}
    assert traced["step.count"] == 4 and traced["loop.newton.iters"] > 0
    assert traced["contacts"] > 0 and traced["graph_loop"] > 0
    assert eager["graph_loop"] == eager["trace_stamp"] == 0
    assert traced["trace_stamp"] == 4 * len(profiler.STAMPS)
    assert len(rows) == 4
    for row in rows:
        vals = list(row.values())
        assert vals == sorted(vals) and vals[0] > 0


@pytest.mark.cuda
def test_device_offset_spread_within_5us(cuda_device):
    """The stamps' %globaltimer against their kernels' starts in a
    torch.profiler trace of 10 replays: the offset spreads by 5 us at
    most."""
    from torch.profiler import ProfilerActivity, profile
    from mujoco_sim_tpu_torch.utils import graph
    m, d = _scene("floor_box.xml", 256, dtype=torch.float32, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
    try:
        graph.clear_all()
        with profiler.tracing(cuda_device):
            d = prollout.rollout(m, d, 2)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as p:
                prollout.rollout(m, d, 10)
                torch.cuda.synchronize()
            mean, spread = profiler.device_offset_ns(p, cuda_device)
    finally:
        graph.clear_all()
    assert spread <= 5000, (mean, spread)


@pytest.mark.cuda
def test_graph_captured_with_tracing_off_holds_no_stamp_or_count(
        cuda_device):
    """A step graph captured with recording off: its replay launches no
    trace_stamp kernel and writes nothing into the recorder's table; its
    capture's spans are the only ones recorded."""
    from torch.profiler import ProfilerActivity, profile
    from mujoco_sim_tpu_torch.utils import graph
    m, d = _scene("manip_bin6.xml", 32, dtype=torch.float32, device="cuda")
    with profiler.counting(cuda_device):
        pass                                  # the table exists
    try:
        graph.clear_all()
        d = prollout.rollout(m, d, 2)
        before = profiler.counts(cuda_device)
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            prollout.rollout(m, d, 3)
            torch.cuda.synchronize()
        after = profiler.counts(cuda_device)
    finally:
        graph.clear_all()
    names = [e.name() for e in p.profiler.kineto_results.events()]
    assert names and not [n for n in names if "trace_stamp" in n]
    assert after == before
    assert {s.name for s in profiler.spans()} == {"graph.capture", "warm",
                                                  "capture"}
