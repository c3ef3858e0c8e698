"""The readers of the program's spans and epoch sections: the median over
untraced fits, sums over modalities, the traced fit's sections per epoch,
the device's idle time inside the layout set-up's host windows, and
nothing to read where the program has no such span."""

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench import trace as T
from perfbench.drivers.fit_loop import FitRecord

METRICS = harness.load_metrics()
NEW = ("knn_s.fit", "fuzzy_s.fit", "spectral_s.fit", "layout_setup_s.fit",
       "layout_setup_idle_s.fit", "epoch_infonce_ms.fit",
       "epoch_modality_ms.fit", "epoch_adam_ms.fit")
SECTIONS = ("draws", "modality_fwd", "infonce_fwd", "infonce_bwd",
            "modality_bwd", "adam")


def fit(scale, traced=False, sections=False):
    """A fit record whose spans are ``scale`` times a base reading."""
    phases = {"fit/graph_0": 1.0 * scale, "fit/graph_1": 2.0 * scale,
              "fit/layout": 5.0 * scale}
    for i in (0, 1):
        phases |= {f"fit/graph_{i}/knn": 0.1 * scale * (i + 1),
                   f"fit/graph_{i}/sigma": 0.01 * scale * (i + 1),
                   f"fit/graph_{i}/union": 0.02 * scale * (i + 1),
                   f"fit/graph_{i}/spectral": 0.5 * scale * (i + 1)}
    phases |= {"fit/layout/prepare": 0.2 * scale,
               "fit/layout/warmup": 0.1 * scale,
               "fit/layout/capture": 0.3 * scale,
               "fit/layout/epochs": 4.0 * scale}
    if sections:
        # seconds over the cell's 600 epochs
        phases |= {f"fit/layout/epochs/{s}": 0.6 * (k + 1)
                   for k, s in enumerate(SECTIONS)}
    return FitRecord(0.0, 6.0 * scale, 0, phases, traced, [])


def view_of(fits, trace=None):
    cell = harness.load_cell("flickr30k.fit", 1, torch.device("cpu"))
    return harness.RunView(cell, fits, trace)


def summary(device_ops, ranges):
    s = np.array([a for a, _ in device_ops], dtype=np.int64)
    e = np.array([b for _, b in device_ops], dtype=np.int64)
    lo, hi = min(s.min(), 0), max(e.max(), 10_000)
    return T.TraceSummary(
        names=["k"], k_name=np.zeros(len(s), dtype=np.int64), k_start=s,
        k_end=e, k_launch=s - 5, d_start=s, d_end=e,
        ranges={T.FIT_RANGE: [(lo, hi)], **ranges}, cpu_ops=[])


def test_graph_spans_sum_modalities_median_over_untraced_fits():
    # the traced fit (x100) is left out; untraced scales 1, 3, 2: median 2
    view = view_of([fit(100.0, traced=True), fit(1.0), fit(3.0), fit(2.0)])
    assert METRICS["knn_s.fit"].read(view) == pytest.approx(2 * 0.3)
    assert METRICS["fuzzy_s.fit"].read(view) == pytest.approx(2 * 0.09)
    assert METRICS["spectral_s.fit"].read(view) == pytest.approx(2 * 1.5)
    assert METRICS["layout_setup_s.fit"].read(view) == pytest.approx(
        2 * 0.6)


def test_span_readers_ignore_the_phases_and_nested_names():
    rec = fit(1.0)
    rec.phases["fit/graph_0/knn/tile"] = 50.0  # deeper: not the span
    rec.phases["fit/graph_cache_save"] = 50.0
    view = view_of([rec])
    assert METRICS["knn_s.fit"].read(view) == pytest.approx(0.3)
    assert METRICS["graph_s.fit"].read(view) == pytest.approx(3.0)
    assert METRICS["layout_s.fit"].read(view) == pytest.approx(5.0)


def test_epoch_sections_per_epoch_of_the_traced_fit():
    view = view_of([fit(1.0, traced=True, sections=True), fit(1.0)])
    # (0.6 * (k + 1)) s over 600 epochs: (k + 1) ms an epoch
    assert METRICS["epoch_infonce_ms.fit"].read(view) == pytest.approx(3 + 4)
    assert METRICS["epoch_modality_ms.fit"].read(view) == pytest.approx(
        2 + 5)
    assert METRICS["epoch_adam_ms.fit"].read(view) == pytest.approx(6)


def test_layout_setup_idle_is_the_gap_inside_the_host_windows():
    # prepare [0, 100] with device work on [20, 50] and [40, 60]: idle 60;
    # warmup [200, 300] fully busy across two streams: idle 0; capture
    # [400, 500] with nothing on the device: idle 100; work outside every
    # window does not count
    ops = [(20, 50), (40, 60), (190, 260), (250, 310), (600, 900)]
    ranges = {"fit/layout/prepare": [(0, 100)],
              "fit/layout/warmup": [(200, 300)],
              "fit/layout/capture": [(400, 500)],
              "fit/layout/epochs": [(500, 1000)]}
    view = view_of([fit(1.0, traced=True)], summary(ops, ranges))
    assert METRICS["layout_setup_idle_s.fit"].read(view) == pytest.approx(
        160e-9)
    # a second prepare window (the runner's Adam state) adds its own
    ranges["fit/layout/prepare"].append((350, 380))
    view = view_of([fit(1.0, traced=True)], summary(ops, ranges))
    assert METRICS["layout_setup_idle_s.fit"].read(view) == pytest.approx(
        190e-9)


def test_nothing_to_read_without_the_spans():
    # the parent's records: phases only, no nested spans or sections
    bare = FitRecord(0.0, 4.0, 0, {"fit/graph_0": 0.3, "fit/graph_1": 0.4,
                                   "fit/layout": 3.0}, True, [])
    trace = summary([(0, 10)], {"fit/layout": [(0, 100)]})
    for tr in (trace, None):
        view = view_of([bare, FitRecord(0.0, 4.0, 0, dict(bare.phases),
                                        False, [])], tr)
        for name in NEW:
            assert METRICS[name].read(view) is None, name
    # an untraced run's sections are not read: only the traced fit's
    view = view_of([fit(1.0, sections=True)])
    for name in ("epoch_infonce_ms.fit", "epoch_modality_ms.fit",
                 "epoch_adam_ms.fit"):
        assert METRICS[name].read(view) is None
