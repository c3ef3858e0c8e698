"""PyTorch port: the spans inside a phase and the layout epoch's sections
(``utils/prof.py``). Imports no JAX, so on a GPU machine without JAX it
runs as

    python -m pytest --noconftest tests/test_torch_prof.py -q

On the CPU: span names nest under the active phase, a span outside any
phase adds nothing, span seconds lie within their phase; a tiny
two-modality fit (and a mesh fit on two gloo ranks) under an active
``torch.profiler`` is bit-equal to the plain one and has every epoch
section, the plain one none; both have the graph stage's and the layout
set-up's spans; transform and invert have theirs. On the card (``cuda``
marker): a span and the section borders never sync the host, and the
captured epoch with the section markers is bit-equal to the one without,
which holds no event-record node.
"""

import contextlib
import ctypes
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_dist import profiled_fit_rank, run_ranks  # noqa: E402
from test_torch_layout_graph import KW, _problem  # noqa: E402

from multimodal_umap_tpu_torch.models import layout as PL  # noqa: E402
from multimodal_umap_tpu_torch.models.mixture import (  # noqa: E402
    MultimodalUMAP,
)
from multimodal_umap_tpu_torch.utils import prof  # noqa: E402
from multimodal_umap_tpu_torch.utils.prof import PhaseTimer  # noqa: E402

torch.set_num_threads(1)

SECTIONS = [f"fit/layout/epochs/{s}" for s in PL.EPOCH_SECTIONS]
GRAPH_SPANS = [f"fit/graph_{i}/{s}" for i in range(2)
               for s in ("knn", "sigma", "union", "spectral")]
FIT_KW = dict(epochs=4, num_rep=3, lr=0.05, alpha=0.5, batch_size=64)


def _profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _tables(n=240, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, 12)) * 4.0
    labels = np.arange(n) % 4
    x0 = (centers[labels] + rng.normal(size=(n, 12))).astype(np.float32)
    x1 = (centers[labels, :8] + rng.normal(size=(n, 8))).astype(np.float32)
    return x0, x1


def test_span_names_nest_under_the_active_phase():
    timer = PhaseTimer("cpu")
    with _profiler() as p:
        with timer.phase("fit/layout"):
            with prof.span("warmup"):
                with prof.span("inner"):
                    pass
            with prof.span("warmup"):
                pass
    assert set(timer.phases) == {"fit/layout", "fit/layout/warmup",
                                 "fit/layout/warmup/inner"}
    names = [e.name for e in p.events()]
    assert names.count("fit/layout/warmup") == 2
    assert "fit/layout/warmup/inner" in names


def test_span_outside_a_phase_adds_no_entry():
    timer = PhaseTimer("cpu")
    with _profiler() as p:
        with prof.span("knn"):
            pass
        with timer.phase("fit/graph_0"):
            pass
        with prof.span("sigma"):
            pass
    assert timer.phases.keys() == {"fit/graph_0"}
    # still a profiler range, under its own name
    assert {"knn", "sigma"} <= {e.name for e in p.events()}
    assert prof.traced_sections(torch.device("cpu")) is None


def test_span_seconds_lie_within_the_phase():
    timer = PhaseTimer("cpu")
    with timer.phase("fit/graph_0"):
        with prof.span("knn"):
            time.sleep(0.02)
        with prof.span("knn"):  # calls sum
            time.sleep(0.01)
        time.sleep(0.01)
    knn = timer.phases["fit/graph_0/knn"]
    assert 0.03 <= knn <= timer.phases["fit/graph_0"] - 0.01


def test_a_phase_that_raises_keeps_its_time_not_its_spans():
    timer = PhaseTimer("cpu")
    with pytest.raises(ValueError):
        with timer.phase("fit/layout"):
            with prof.span("capture"):
                raise ValueError("capture failed")
    assert set(timer.phases) == {"fit/layout"}


def test_sections_tile_a_pass_and_count_replays():
    stamps = iter([1.0, 1.5, 3.5, 4.0, 10.0, 10.25, 11.0])
    sections = prof.Sections(torch.device("cpu"), captured=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(prof, "_stamp", lambda device, external=False:
                   next(stamps))
        sections.start("draws")
        sections.start("modality_fwd")
        sections.stop()
        sections.replays = 3
        assert sections.seconds() == {"draws": 1.5, "modality_fwd": 6.0}
        eager = prof.Sections(torch.device("cpu"))
        for _ in range(2):  # two epochs, each timed
            eager.start("adam")
            eager.stop()
        assert eager.seconds() == {"adam": 6.75}


def test_border_is_an_identity_that_marks_forward_and_backward():
    sections = prof.Sections(torch.device("cpu"))
    x = torch.randn(5, 3, requires_grad=True)
    y = torch.randn(4, 3, requires_grad=True)
    sections.start("modality_fwd")
    bx, by = sections.through((x, y), "infonce_fwd", "modality_bwd")
    assert torch.equal(bx, x) and torch.equal(by, y)
    loss = (bx * 2).sum() + by.square().sum()
    sections.start("infonce_bwd")
    loss.backward()
    sections.stop()
    assert [n for n, _ in sections.passes[0]] == [
        "modality_fwd", "infonce_fwd", "infonce_bwd", "modality_bwd", None]
    assert torch.equal(x.grad, torch.full_like(x, 2.0))
    assert torch.equal(y.grad, 2 * y.detach())


@pytest.fixture(scope="module")
def fits():
    """The same tiny fit without and under an active profiler."""
    x0, x1 = _tables()
    out = {}
    for profiled in (False, True):
        model = MultimodalUMAP(6, 4, 0.1, 2, seed=3, device="cpu")
        ctx = _profiler() if profiled else contextlib.nullcontext()
        with ctx:
            model.fit([x0, x1], **FIT_KW)
        out[profiled] = model
    return out


def test_profiled_fit_is_bit_equal_to_the_plain_one(fits):
    plain, profiled = fits[False], fits[True]
    for a, b in zip(plain.embeds, profiled.embeds):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(plain.loss_history["fit"],
                                  profiled.loss_history["fit"])


def test_only_the_profiled_fit_has_the_epoch_sections(fits):
    assert set(SECTIONS) <= set(fits[True].timer.phases)
    assert not [k for k in fits[False].timer.phases if "/epochs/" in k]
    phases = fits[True].timer.phases
    # the eager runner times each epoch: the sections tile the epochs
    assert sum(phases[k] for k in SECTIONS) <= phases["fit/layout/epochs"]


@pytest.mark.parametrize("profiled", [False, True])
def test_graph_and_layout_setup_spans_in_both_fits(fits, profiled):
    phases = fits[profiled].timer.phases
    assert set(GRAPH_SPANS) <= set(phases)
    assert {"fit/layout/prepare", "fit/layout/epochs"} <= set(phases)
    for i in range(2):
        spans = sum(phases[f"fit/graph_{i}/{s}"]
                    for s in ("knn", "sigma", "union", "spectral"))
        assert spans <= phases[f"fit/graph_{i}"]


@pytest.mark.parametrize("mode", ["transform", "invert"])
def test_query_modes_have_their_spans(mode):
    x0, x1 = _tables()
    model = MultimodalUMAP(6, 4, 0.1, 2, seed=3, device="cpu")
    model.fit([x0, x1], **dict(FIT_KW, epochs=2))
    if mode == "transform":
        model.transform([x0[:40]], epochs=2, data_indices=[0], batch_size=16)
    else:
        z = model.transform([x1[:40]], epochs=2, data_indices=[1],
                            batch_size=16)
        model.inverse_transform(z, epochs=2, data_indices=[0],
                                batch_size=16)
    want = {f"{mode}/graph/knn", f"{mode}/graph/sigma",
            f"{mode}/layout/prepare", f"{mode}/layout/epochs"}
    assert want <= set(model.timer.phases)


def test_profiled_mesh_fit_is_bit_equal_and_has_the_sections(tmp_path):
    x0, x1 = _tables(n=128)
    res = run_ranks(profiled_fit_rank, 2, tmp_path, x0, x1,
                    dict(FIT_KW, epochs=3, batch_size=32), timeout=120.0)
    for plain, profiled in res:
        assert plain["sharded"] and profiled["sharded"]
        for a, b in zip(plain["embeds"], profiled["embeds"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(plain["hist"], profiled["hist"])
        assert set(SECTIONS) <= set(profiled["phases"])
        assert not [k for k in plain["phases"] if "/epochs/" in k]
        assert set(GRAPH_SPANS) <= set(plain["phases"])


# ---- on the card ----

# CUgraphNodeType's CU_GRAPH_NODE_TYPE_EVENT_RECORD (cuda.h)
_EVENT_RECORD = 7


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (CUDA events and graphs)")


def _event_record_nodes(raw_graph: int) -> int:
    """Event-record nodes of a CUDA graph (``cuGraphGetNodes``)."""
    cu = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(ctypes.c_void_p(raw_graph), None,
                              ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(ctypes.c_void_p(raw_graph), nodes,
                              ctypes.byref(n)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    assert kinds, "an empty graph"
    return kinds.count(_EVENT_RECORD)


@pytest.mark.cuda
def test_span_and_section_borders_never_sync_on_cuda():
    _require_cuda()
    dev = torch.device("cuda", 0)
    x = torch.randn(1 << 16, 8, device=dev, requires_grad=True)
    timer = PhaseTimer(dev)
    with timer.phase("fit/layout"):
        sections = prof.Sections(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            with prof.span("epochs"):
                sections.start("modality_fwd")
                (y,) = sections.through((x,), "infonce_fwd", "modality_bwd")
                loss = (y * y).sum()
                sections.start("infonce_bwd")
                loss.backward()
                sections.stop()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        prof.defer(sections.seconds)
    assert {"fit/layout/epochs", "fit/layout/modality_bwd"} <= set(
        timer.phases)
    assert 0 < timer.phases["fit/layout/epochs"] <= timer.phases[
        "fit/layout"]


@pytest.mark.cuda
def test_captured_epoch_markers_change_no_number(monkeypatch):
    """The fit layout captured at 2,048 rows under a phase, with and
    without an active profiler: bit-equal embeddings and losses; the
    plain capture holds no event-record node, the profiled one one a
    section border."""
    _require_cuda()
    nodes = []

    class Kept(torch.cuda.CUDAGraph):
        def capture_end(self):
            super().capture_end()
            nodes.append(_event_record_nodes(self.raw_cuda_graph()))

    # keep_graph: the captured cudaGraph_t stays readable (replay
    # instantiates it)
    monkeypatch.setattr(torch.cuda, "CUDAGraph",
                        lambda: Kept(keep_graph=True))
    inits, tasks, statics = _problem("fit", n=2048, dev="cuda")
    runs = []
    for profiled in (False, True):
        timer = PhaseTimer("cuda")
        ctx = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
            if profiled else contextlib.nullcontext())
        with ctx, timer.phase("fit/layout"):
            runs.append(PL.train_layout(inits, tasks, statics, mode="fit",
                                        epochs=30, alpha=0.5, **KW))
        sections = [k for k in timer.phases if "/epochs/" in k]
        assert sorted(sections) == (sorted(SECTIONS) if profiled else [])
        assert {"fit/layout/prepare", "fit/layout/warmup",
                "fit/layout/capture", "fit/layout/epochs"} <= set(
            timer.phases)
        if profiled:
            total = sum(timer.phases[k] for k in SECTIONS)
            assert 0 < total <= timer.phases["fit/layout/epochs"]
    assert nodes == [0, len(PL.EPOCH_SECTIONS) + 1]
    (e0, h0), (e1, h1) = runs
    assert torch.equal(h0, h1)
    for a, b in zip(e0, e1):
        assert torch.equal(a, b)
