"""The traced fit's readers: the idle share is the union of device
intervals, not their sum; the gaps and the layout's kernel count."""

import numpy as np
import torch

from perfbench import harness
from perfbench import trace as T
from perfbench.drivers.fit_loop import FitRecord

METRICS = harness.load_metrics()


def summary_of(kernels, lo=0, hi=None, layout=None):
    names = sorted({k[0] for k in kernels})
    idx = {n: i for i, n in enumerate(names)}
    hi = max(k[2] for k in kernels) if hi is None else hi
    ranges = {T.FIT_RANGE: [(lo, hi)]}
    if layout is not None:
        ranges["fit/layout"] = [layout]
    return T.TraceSummary(
        names=names, k_name=np.array([idx[k[0]] for k in kernels]),
        k_start=np.array([k[1] for k in kernels]),
        k_end=np.array([k[2] for k in kernels]),
        k_launch=np.array([k[1] - 5 for k in kernels]),
        d_start=np.array([k[1] for k in kernels]),
        d_end=np.array([k[2] for k in kernels]), ranges=ranges, cpu_ops=[])


def view_of(kernels, seconds=1.0, **kw):
    cell = harness.load_cell("flickr30k.fit", 1, torch.device("cpu"))
    fit = FitRecord(0.0, seconds, 0, {"fit/layout": 1.0, "fit/graph_0": 0.25,
                                      "fit/graph_1": 0.5}, False, [])
    return harness.RunView(cell, [fit], summary_of(kernels, **kw))


def test_union_not_sum_of_overlapping_kernels():
    # two streams overlap on [40, 60]: busy 80 of 100, not the summed 100
    kernels = [("a", 0, 60), ("b", 40, 80)]
    view = view_of(kernels, lo=0, hi=100)
    assert T.union_length(np.array([0, 40]), np.array([60, 80])) == 80
    assert view.trace.busy_ns(0, 100) == 80
    idle = METRICS["device_idle_pct.fit"].read(view)
    assert abs(idle - 20.0) < 1e-12
    assert T.idle_gaps(np.array([0, 40]), np.array([60, 80]), 0, 100) == [
        (80, 100)]


def test_nested_and_clipped_intervals():
    s, e = np.array([0, 10, 50, 95]), np.array([100, 20, 60, 130])
    assert T.union_length(s, e) == 130
    trace = summary_of([("a", 0, 100), ("b", 10, 20), ("c", 95, 130)],
                       lo=0, hi=110)
    assert trace.busy_ns(0, 110) == 110
    assert T.idle_gaps(np.array([10, 50]), np.array([20, 60]), 0, 100) == [
        (0, 10), (20, 50), (60, 100)]


def test_layout_kernels_per_epoch_counts_launches_in_the_layout_range():
    kernels = [(f"k{i}", 100 + i, 101 + i) for i in range(1200)]
    view = view_of(kernels, layout=(0, 10_000))
    assert METRICS["layout_kernels_per_epoch.fit"].read(view) == 2.0
    view = view_of(kernels, layout=(0, 100 + 599 - 5))
    assert METRICS["layout_kernels_per_epoch.fit"].read(view) == 1.0


def test_phase_readers_and_nothing_to_read():
    view = view_of([("k", 0, 1)])
    assert METRICS["graph_s.fit"].read(view) == 0.75
    assert METRICS["layout_s.fit"].read(view) == 1.0
    assert METRICS["knn_tile_roofline_pct.fit"].read(view) is None
    assert METRICS["layout_terms_roofline_pct.fit"].read(view) is None
    empty = harness.RunView(view.cell, view.fits, None)
    for name in ("device_idle_pct.fit", "layout_kernels_per_epoch.fit",
                 "knn_tile_roofline_pct.fit"):
        assert METRICS[name].read(empty) is None


def test_breakdown_lists_ops_and_labelled_gaps():
    trace = summary_of([("a", 0, 60), ("b", 70, 80)], lo=0, hi=100,
                       layout=(0, 100))
    trace.cpu_ops = [(55, 75, "aten::copy_"), (85, 99, "aten::mul")]
    brk = T.breakdown(trace)
    assert brk["device_ops"] == [["a", 60e-9], ["b", 10e-9]]
    assert brk["idle_gaps"] == [["fit/layout: aten::mul", 20e-9],
                                ["fit/layout: aten::copy_", 10e-9]]
