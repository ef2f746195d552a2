"""The yardstick's arithmetic on hand-computed cases: roofline bounds,
percentiles and rates, spreads, and the device's busy time as a union."""

import math
import statistics
import types

import pytest

from harness import roofline, stats, trace


def test_chol_solve_bound_at_manip_shape():
    # (1024, 42): A and b in, x out, float32; bytes bound it
    nbytes = 4 * 1024 * (42 * 42 + 2 * 42)
    flops = 1024 * (42 ** 3 / 3 + 2 * 42 * 42)
    assert nbytes == 7_569_408 and flops == 28_901_376
    assert roofline.chol_solve_bound_s(1024, 42) == pytest.approx(
        nbytes / 3.35e12, rel=1e-12)


def test_hull_sat_bound_by_hand():
    # N=10, V=4, F=3, k=2 with a point mask: points 12 + planes 12 floats,
    # outputs 12 k + 16 bytes, mask 4 V bytes an instance
    nbytes = 4 * 10 * (12 + 12) + 10 * (24 + 16) + 4 * 10 * 4
    assert nbytes == 1520
    got = roofline.hull_sat_bound_s(10, 4, 3, 2, True, False, False)
    assert got == pytest.approx(max(1520 / 3.35e12, 960 / 67e12), rel=1e-12)
    # the lateral filter doubles the depths' flops, a slack adds 4 bytes
    got = roofline.hull_sat_bound_s(10 ** 6, 24, 44, 2, False, True, True)
    flops = 10 ** 6 * (6 * 24 * 44 * 2 + 6 * 24)
    nbytes = 4 * 10 ** 6 * (72 + 176) + 10 ** 6 * 40 + 4 * 10 ** 6
    assert got == pytest.approx(max(nbytes / 3.35e12, flops / 67e12))


@pytest.mark.parametrize("values,q,want", [
    (list(range(1, 101)), 95, 95.05),
    ([1.0, 2.0, 3.0, 4.0], 95, 3.85),
    ([5.0], 95, 5.0),
    ([3.0, 1.0, 2.0], 50, 2.0),
])
def test_percentile_is_linear_between_ranks(values, q, want):
    assert stats.percentile(values, q) == pytest.approx(want)


def test_rate_and_its_window():
    assert stats.rate(8192 * 340, 20.0) == pytest.approx(139264.0)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_spread_uses_statistics_quartiles():
    v = [100.0, 101.0, 99.0, 100.5, 98.0, 102.0]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)


def _trace(device, window=(0, 100), host=()):
    return trace.Trace(list(device), list(host), window)


def test_busy_is_the_union_of_overlapping_intervals():
    tr = _trace([("a", 10, 30), ("b", 20, 40), ("c", 35, 50),
                 ("d", 60, 70), ("e", 65, 66), ("f", 90, 120)])
    # [10, 50] + [60, 70] + [90, 100] (clipped to the window)
    assert trace.busy_s(tr) == pytest.approx(60e-9)
    assert trace.window_s(tr) == pytest.approx(100e-9)
    assert trace.gaps(tr) == [(0, 10), (50, 60), (70, 90)]
    # a sum of the kernels' times would read 96 ns, not 60
    assert sum(e - s for _, s, e in tr.device) == 96


def test_while_node_spans_count_as_busy():
    dev = [("k1", 0, 10), ("set_any<<<1>>>", 12, 14), ("k2", 30, 40)]
    nodes = trace.while_nodes(dev)
    assert nodes == [(trace.WHILE_NODE, 14, 30)]
    tr = _trace(dev + nodes, window=(0, 40))
    assert trace.busy_s(tr) == pytest.approx(38e-9)


def test_idle_gaps_are_named_by_the_innermost_host_span():
    tr = _trace([("k", 0, 10), ("k", 40, 50)], window=(0, 60),
                host=[(trace.WINDOW, 0, 60), ("outer", 5, 55),
                      ("inner", 8, 45)])
    bd = trace.breakdown(tr)
    assert bd["device_ops"] == [["k", pytest.approx(20e-9)]]
    assert bd["idle_gaps"] == [["inner", pytest.approx(30e-9)],
                               ["outer", pytest.approx(10e-9)]]


def test_kernel_names_are_shortened_for_the_breakdown():
    name = ("void at::native::elementwise_kernel<128, 2, at::native::"
            "BinaryFunctor<float, float, float, at::native::"
            "binary_internal::MulFunctor<float> > >(int, x)")
    assert trace.short(name) == ("at::native::elementwise_kernel"
                                 "[BinaryFunctor,MulFunctor]")
    assert trace.short("void chol_solve_kernel<16>(float const*)") == \
        "chol_solve_kernel"


def test_kernel_times_by_name():
    dev = [("void chol_solve_kernel<16>()", 0, 2000),
           ("chol_solve_panel_kernel", 5000, 9000), ("other", 0, 1)]
    assert trace.kernel_times_s(dev, "chol_solve") == [2e-6, 4e-6]
    assert math.isclose(sum(trace.kernel_times_s(dev, "other")), 1e-9)


def _contacts(rows) -> dict:
    """One answer's contact leaves from rows of (active, geom1, geom2,
    dist, includemargin)."""
    import torch
    kinds = (("active", torch.bool), ("geom1", torch.int64),
             ("geom2", torch.int64), ("dist", torch.float64),
             ("includemargin", torch.float64))
    return {k: torch.tensor([[r[i] for r in rows]], dtype=dt)
            for i, (k, dt) in enumerate(kinds)}


def _pair_gaps(prog_rows, ref_rows):
    from harness import check
    post = {"contact." + k: v for k, v in _contacts(prog_rows).items()}
    ref = types.SimpleNamespace(
        contact=types.SimpleNamespace(**_contacts(ref_rows)))
    return check.pair_gaps(post, ref)


def test_pair_gaps_deepest_contact_of_each_pair():
    # a tie: another corner picked at the same depth, and one contact
    # fewer on the pair; the deepest distance is the same
    gaps, dcount, nref = _pair_gaps(
        [(1, 0, 3, -1e-3, 0.0), (1, 0, 3, -1e-3, 0.0), (0, 0, 0, 0.0, 0.0)],
        [(1, 0, 3, -1e-3, 0.0), (1, 3, 0, -1e-3, 0.0), (1, 0, 3, -2e-4, 0.0)])
    assert gaps == [0.0] and dcount == 1 and nref == 3
    # a pair on one side only counts from its margin; a deeper contact
    # moves the pair's number
    gaps, dcount, nref = _pair_gaps(
        [(1, 1, 2, -5e-4, 1e-3), (1, 0, 3, -3e-3, 0.0)],
        [(0, 1, 2, 0.0, 0.0), (1, 0, 3, -1e-3, 0.0)])
    assert sorted(gaps) == pytest.approx([1.5e-3, 2e-3]) and dcount == 1
    assert nref == 1
