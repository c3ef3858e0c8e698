"""PyTorch port: a fit of three modalities (InfoNCE over every pair i < j).

Against the benchmark's plain float64 reference (``perfbench/reference``):
a three-modality fit at widths (24, 32, 48) taken through the benchmark's
fit loop and judged by ``perfbench/judge.py`` within the limits of its
CPU-sized cell (``perfbench/tests/cells/configs/tiny.json``), and the
reference objective's InfoNCE term summed over all three pairs. Each
fault of ``perfbench/readings_modality.py`` planted in the last modality
alone (its Adam state left unchanged, half its rows out of the loss, its
InfoNCE pairs dropped) leaves every graph number as it was and raises
``loss_ratio``, the one number that sees that modality's layout.

Against the JAX package, on ``tests/test_multimodal3.py``'s set-up: each
modality's symmetric graph (ids and validity equal; weights, bandwidths
and nearest distances rtol 5e-4 / atol 1e-6, as the transform graphs of
tests/test_torch_model.py: both engines' f32 distances sum in another
order); the spectral inits, which lie in the null space of the normalized
Laplacian there (each graph has 4 components, one a cluster, for 3
columns; which directions of that space an init takes is arbitrary, so
each must lie in it: principal-angle cosines > 0.99, as
tests/test_torch_graph.py); one deterministic epoch's loss rtol 1e-5 and
gradients rtol 2e-4 / atol 1e-6 on each package's own graphs, and a
replayed 12-epoch trajectory with the tolerances of
tests/test_torch_layout.py.

The spans: a profiled three-modality fit has every ``fit/graph_<i>`` span
and every epoch section. The benchmark's InfoNCE roofline metric
(``perfbench/metrics/infonce_roofline_pct.fit.py``): its bytes give the
InfoNCE bound of one pair at 31,783 and 118,287 rows and three times a
pair's at three modalities; it reads the ``infonce_*`` kernels of the
traced fit's window only.
"""

import copy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from _torch_parity import (  # noqa: E402
    jax_epoch_draws,
    jax_train_draws,
    subspace_sv,
    t,
)
from chip_smoke import exact_null_space  # noqa: E402

from multimodal_umap_tpu.data.synthetic import (  # noqa: E402
    clustered_modalities as j_clustered,
)
from multimodal_umap_tpu.models import layout as JL  # noqa: E402
from multimodal_umap_tpu.models.encoder import (  # noqa: E402
    ModalityEncoder as JEncoder,
)
from multimodal_umap_tpu_torch.models import encoder as PE  # noqa: E402
from multimodal_umap_tpu_torch.models import layout as PL  # noqa: E402
from multimodal_umap_tpu_torch.models.mixture import (  # noqa: E402
    MultimodalUMAP,
)
from multimodal_umap_tpu_torch.ops.graph import DenseSymGraph  # noqa: E402
from perfbench import harness  # noqa: E402
from perfbench import readings_modality as RM  # noqa: E402
from perfbench import trace as T  # noqa: E402
from perfbench.drivers import fit_loop as FL  # noqa: E402
from perfbench.judge import GRAPH_NUMBERS, verdict  # noqa: E402
from perfbench.reference import loss as RL  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
K, OUT_DIM, MIN_DIST = 6, 3, 0.1
FIT_KW = dict(num_rep=2, lr=0.05, alpha=0.5, batch_size=48)


def _cell(seed: int) -> harness.Cell:
    """The benchmark's CPU-sized cell at three widths, 300 rows and 40
    epochs, with its limits."""
    cfg = copy.deepcopy(harness.load_json(
        harness.ROOT / "tests" / "cells" / "configs" / "tiny.json"))
    cfg.update(name="tiny3", n_pairs=300, dims=[24, 32, 48])
    cfg["program"]["train_epochs"] = 40
    return harness.Cell("tiny3.fit", {"config": "tiny3", "traffic": "fit3",
                                      "chips": 1},
                        cfg, {"driver": "fit_loop", "warm_epochs": 2}, seed,
                        CPU)


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_fit_passes_the_plain_reference(seed):
    cell = _cell(seed)
    state = FL.setup(cell)
    result = FL.window(cell, state, 0.0, False)
    assert len(result["fits"]) == 1
    outs = result["fits"][0].outputs
    assert len(outs) == 3
    assert [o["embed"].shape for o in outs] == [(300, 64)] * 3
    numbers, info = FL.check(cell, state, result)
    ok, checks = verdict(numbers, cell.config["limits"])
    assert ok, checks
    assert info["infonce_ratio"] < 1.0


@pytest.fixture(scope="module")
def sound_fit():
    """The CPU-sized three-modality cell's set-up and its sound fit's
    numbers."""
    cell = _cell(3)
    state = FL.setup(cell)
    result = FL.window(cell, state, 0.0, False)
    return cell, state, FL.check(cell, state, result)


@pytest.mark.parametrize("fault", RM.FAULTS)
def test_fault_in_the_last_modality_raises_only_the_loss_ratio(sound_fit,
                                                               fault):
    cell, state, (sound, sound_info) = sound_fit
    state.observer = FL._InitObserver(state.observer.module)
    with RM.planted_in(fault, 2):
        result = FL.window(cell, state, 0.0, False)
    numbers, info = FL.check(cell, state, result)
    assert numbers["loss_ratio"] > sound["loss_ratio"] + 0.01
    assert {k: numbers[k] for k in GRAPH_NUMBERS} == {
        k: sound[k] for k in GRAPH_NUMBERS}
    outs = result["fits"][0].outputs
    half = cell.config["n_pairs"] // 2
    moved = [not torch.equal(o["embed"], o["init"].float()) for o in outs]
    if fault == "unchanged":
        assert moved == [True, True, False]
    elif fault == "half":
        assert moved == [True, True, True]
        assert torch.equal(outs[2]["embed"][half:],
                           outs[2]["init"][half:].float())
    else:
        assert info["infonce_ratio"] > sound_info["infonce_ratio"] + 0.1


def test_reference_infonce_counts_every_pair(monkeypatch):
    calls = []
    plain = RL.infonce

    def counted(e0, e1, **kw):
        v = plain(e0, e1, **kw)
        which = [next(m for m, e in enumerate(embeds)
                      if torch.equal(x, e.double())) for x in (e0, e1)]
        calls.append((*which, float(v)))
        return v

    monkeypatch.setattr(RL, "infonce", counted)
    gen = torch.Generator().manual_seed(0)
    n, k = 50, 4
    embeds = [torch.randn(n, 2, generator=gen) for _ in range(3)]
    ids = torch.stack([torch.randperm(n - 1, generator=gen)[:k] for _ in
                       range(n)])
    ids = ids + (ids >= torch.arange(n)[:, None]).long()
    graph = (ids, torch.rand(n, k, generator=gen),
             torch.zeros(n, k, dtype=torch.bool))
    out = RL.fit_loss(embeds, [graph] * 3, a=1.577, b=0.8951, num_rep=2,
                      batch_size=16, alpha=0.5, n_neg=8, temperature=0.5,
                      group_size=1000, seed=9, draws=2)
    pairs = [(0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1)]
    assert [c[:2] for c in calls] == pairs * 2
    np.testing.assert_allclose(out["infonce"],
                               0.5 * sum(c[2] for c in calls) / 2,
                               rtol=1e-12)


@pytest.fixture(scope="module")
def fitted():
    """The port's three-modality fit on test_multimodal3.py's data (its
    spectral inits kept), and the JAX package's graph stage on the same
    tables."""
    data = j_clustered(96, dims=(12, 18, 10), n_clusters=4, seed=3)
    arrays = [data[k] for k in data]
    seen = []
    plain = PE.spectral_embedding

    def kept(*args, **kwargs):
        seen.append(plain(*args, **kwargs))
        return seen[-1]

    PE.spectral_embedding = kept
    try:
        model = MultimodalUMAP(K, OUT_DIM, MIN_DIST, 3, device="cpu")
        model.fit(arrays, epochs=2, **FIT_KW)
    finally:
        PE.spectral_embedding = plain
    jax_graphs = []
    for i, x in enumerate(arrays):
        enc = JEncoder(K, OUT_DIM, id=i)
        graph, dense, init = enc.fit_graph(jnp.asarray(x))
        jax_graphs.append((graph, dense, init, enc))
    return arrays, model, seen, jax_graphs


@pytest.mark.parametrize("m", [0, 1, 2])
def test_graphs_match_jax(fitted, m):
    _, model, _, jax_graphs = fitted
    j_graph, _, _, j_enc = jax_graphs[m]
    p_graph = model.graphs[m]
    for f in ("rows", "cols", "valid"):
        np.testing.assert_array_equal(getattr(p_graph, f).numpy(),
                                      np.asarray(getattr(j_graph, f)))
    np.testing.assert_allclose(p_graph.weights.numpy(),
                               np.asarray(j_graph.weights), rtol=5e-4,
                               atol=1e-6)
    enc = model.encoders[m]
    np.testing.assert_allclose(enc.sigmas.numpy(), np.asarray(j_enc.sigmas),
                               rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(enc.rhos.numpy(), np.asarray(j_enc.rhos),
                               rtol=5e-4, atol=1e-6)


@pytest.mark.parametrize("m", [0, 1, 2])
def test_spectral_inits_lie_in_the_null_space_as_jax(fitted, m):
    _, model, seen, jax_graphs = fitted
    assert len(seen) == 3
    _, _, j_init, _ = jax_graphs[m]
    basis = exact_null_space(model.graphs[m]).numpy()
    assert basis.shape[1] == 4  # one component a cluster
    port = seen[m].numpy()
    assert port.shape == (96, OUT_DIM)
    assert subspace_sv(np.asarray(j_init), basis).min() > 0.99
    assert subspace_sv(port, basis).min() > 0.99
    np.testing.assert_allclose(port.T @ port, np.eye(OUT_DIM), atol=1e-4)


def test_deterministic_epoch_loss_matches_jax(fitted):
    """The fit objective with expected keeps on each package's own three
    graphs, at the same embeddings and JAX's draws replayed."""
    _, model, _, jax_graphs = fitted
    j_tasks, j_statics = zip(*(JL.fit_task(d, FIT_KW["batch_size"])
                               for _, d, _, _ in jax_graphs))
    dense = [PE.ModalityEncoder(K, OUT_DIM, id=i).fit_graph(x)[1]
             for i, x in enumerate(model.data)]
    p_tasks, p_statics = zip(*(PL.fit_task(d, FIT_KW["batch_size"])
                               for d in dense))
    rng = np.random.default_rng(12)
    embeds = [rng.normal(size=(96, OUT_DIM)).astype(np.float32)
              for _ in range(3)]
    key = jax.random.PRNGKey(13)
    kw = dict(mode="fit", num_rep=FIT_KW["num_rep"], alpha=FIT_KW["alpha"],
              batch_size=FIT_KW["batch_size"], deterministic=True)
    j_fn = JL.make_loss_fn(j_statics, **kw)
    v_j, g_j = jax.value_and_grad(j_fn)(
        tuple(jnp.asarray(e) for e in embeds), j_tasks,
        (jnp.float32(model.a), jnp.float32(model.b)), key)
    draws = jax_epoch_draws(key, [(96, K)] * 3, mode="fit",
                            num_rep=FIT_KW["num_rep"], alpha=FIT_KW["alpha"])
    assert len(draws.infonce) == 3
    params = [t(e).requires_grad_() for e in embeds]
    v_p = PL.make_loss_fn(p_statics, **kw)(params, p_tasks, model.a, model.b,
                                           draws)
    v_p.backward()
    np.testing.assert_allclose(v_p.item(), float(v_j), rtol=1e-5)
    for p, g in zip(params, g_j):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=2e-4,
                                   atol=1e-6)


def test_fit_trajectory_matches_jax(fitted):
    """12 replayed epochs of three modalities from the JAX graphs."""
    _, model, _, jax_graphs = fitted
    j_tasks, j_statics = zip(*(JL.fit_task(d, FIT_KW["batch_size"])
                               for _, d, _, _ in jax_graphs))
    p_tasks, p_statics = zip(*(PL.fit_task(
        DenseSymGraph(nbrs=t(d.nbrs), weights=t(d.weights),
                      bwd_valid=t(d.bwd_valid), num_rows=96),
        FIT_KW["batch_size"]) for _, d, _, _ in jax_graphs))
    inits = [np.asarray(init) for _, _, init, _ in jax_graphs]
    key = jax.random.PRNGKey(5)
    kw = dict(mode="fit", epochs=12, a=model.a, b=model.b, **FIT_KW)
    j_emb, j_hist = JL.train_layout([jnp.asarray(e) for e in inits], j_tasks,
                                    j_statics, key=key, epoch_chunk=5, **kw)
    p_emb, p_hist = PL.train_layout(
        [t(e) for e in inits], p_tasks, p_statics,
        draws=jax_train_draws(key, 12, [(96, K)] * 3, mode="fit",
                              num_rep=FIT_KW["num_rep"],
                              alpha=FIT_KW["alpha"]),
        epoch_chunk=5, **kw)
    np.testing.assert_allclose(p_hist.numpy(), np.asarray(j_hist), rtol=1e-4)
    for p, j in zip(p_emb, j_emb):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=1e-3,
                                   atol=1e-4)


def test_profiled_fit_has_every_span_and_section(fitted):
    arrays = fitted[0]
    model = MultimodalUMAP(K, OUT_DIM, MIN_DIST, 3, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        model.fit(arrays, epochs=3, **FIT_KW)
    phases = model.timer.phases
    spans = [f"fit/graph_{i}/{s}" for i in range(3)
             for s in ("knn", "sigma", "union", "spectral")]
    sections = [f"fit/layout/epochs/{s}" for s in PL.EPOCH_SECTIONS]
    assert set(spans) <= set(phases)
    assert set(sections) <= set(phases)
    assert not [p for p in phases if p.startswith("fit/graph_3")]
    for i in range(3):
        assert sum(phases[f"fit/graph_{i}/{s}"] for s in (
            "knn", "sigma", "union", "spectral")) <= phases[f"fit/graph_{i}"]
    assert sum(phases[s] for s in sections) <= phases["fit/layout/epochs"]


def _metric():
    return harness.load_metrics()["infonce_roofline_pct.fit"]


@pytest.mark.parametrize("rows, ms", [(31_783, 0.0149), (118_287, 0.0554)])
def test_infonce_roofline_bytes_are_the_pair_bound(rows, ms):
    mod = _metric()
    got = mod.pair_bytes(rows, 64, 8) / mod.PEAK_BYTES * 1e3
    assert round(got, 4) == ms
    assert mod.epoch_bytes(rows, 64, 8, 2) == mod.pair_bytes(rows, 64, 8)
    assert mod.epoch_bytes(rows, 64, 8, 3) == 3 * mod.pair_bytes(rows, 64, 8)


def _summary(kernels, window):
    names = sorted({k[0] for k in kernels})
    idx = {n: i for i, n in enumerate(names)}
    arr = np.array([k[1] for k in kernels], dtype=np.int64)
    end = np.array([k[2] for k in kernels], dtype=np.int64)
    return T.TraceSummary(
        names=names, k_name=np.array([idx[k[0]] for k in kernels]),
        k_start=arr, k_end=end, k_launch=np.full(len(kernels), -1),
        d_start=arr, d_end=end, ranges={T.FIT_RANGE: [window]}, cpu_ops=[])


@pytest.mark.parametrize("cell", ["coco2017.fit", "spokencoco.fit"])
def test_infonce_roofline_reads_the_window_kernels(cell):
    mod = _metric()
    c = harness.load_cell(cell, 1, CPU)
    view = harness.RunView(c, [], None)
    assert mod.read(view) is None
    kernels = [("void (anonymous namespace)::infonce_fwd_kernel<16, 4>()",
                100, 600_100),
               ("void (anonymous namespace)::infonce_bwd_kernel<16, 4>()",
                700_000, 1_100_000),
               ("(anonymous namespace)::knn_tile_bf16_kernel()", 0, 10**9),
               ("void (anonymous namespace)::infonce_fwd_kernel<16, 4>()",
                5 * 10**9, 6 * 10**9)]
    view = harness.RunView(c, [], _summary(kernels, (0, 2 * 10**9)))
    cfg, p = c.config, c.config["program"]
    want = 100.0 * p["train_epochs"] * mod.epoch_bytes(
        cfg["n_pairs"], p["out_dim"], cfg["infonce"]["n_neg"],
        len(cfg["dims"])) / mod.PEAK_BYTES / 1e-3
    np.testing.assert_allclose(mod.read(view), want, rtol=1e-12)
    view = harness.RunView(c, [], _summary(kernels[2:3], (0, 2 * 10**9)))
    assert mod.read(view) is None
