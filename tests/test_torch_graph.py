"""PyTorch port: sigma solve, fuzzy graph, curve fit and spectral init
against the JAX package and the reference goldens.

Tolerances: rtol 1e-5 against JAX on the same (dists, nbrs) -- the same
f32 formulas, summed in another order; the goldens' own bands of
tests/test_parity_goldens.py; spectral subspaces by principal angles
(cosines > 0.99), since the start blocks' random draws differ (LOBPCG
is also held against JAX's from JAX's own start block).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import subspace_sv, t

from multimodal_umap_tpu.models.curve import get_ab_coeffs as j_ab
from multimodal_umap_tpu.ops import graph as JG
from multimodal_umap_tpu.ops.sigma import solve_sigmas as j_sigmas
from multimodal_umap_tpu.ops.spectral import spectral_embedding as j_spectral
from multimodal_umap_tpu_torch.models.curve import get_ab_coeffs
from multimodal_umap_tpu_torch.ops import graph as PG
from multimodal_umap_tpu_torch.ops import spectral as PS
from multimodal_umap_tpu_torch.ops.sigma import solve_sigmas

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens",
                       "reference_goldens.npz")


@pytest.fixture(scope="module")
def g():
    return np.load(GOLDENS)


def _knn_graph(n=120, k=6, d=5, seed=0):
    """(dists, nbrs) of an exact self kNN graph, in numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    dist = np.linalg.norm(x[:, None] - x[None], axis=2)
    np.fill_diagonal(dist, np.inf)
    nbrs = np.argsort(dist, axis=1, kind="stable")[:, :k].astype(np.int32)
    return np.take_along_axis(dist, nbrs, 1).astype(np.float32), nbrs


def test_sigmas_match_jax_and_golden(g):
    dists, _ = _knn_graph()
    rhos = dists.min(1)
    np.testing.assert_allclose(
        solve_sigmas(t(dists), t(rhos)).numpy(),
        np.asarray(j_sigmas(jnp.asarray(dists), jnp.asarray(rhos))),
        rtol=1e-5)
    np.testing.assert_allclose(
        solve_sigmas(t(g["sigma_dists"]), t(g["sigma_rhos"])).numpy(),
        g["sigma_values"], rtol=1e-3, atol=1e-4)


def test_fuzzy_and_curve_weights_match_jax():
    dists, _ = _knn_graph(seed=1)
    got = PG.fuzzy_weights(t(dists))
    want = JG.fuzzy_weights(jnp.asarray(dists))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)
    np.testing.assert_allclose(
        PG.curve_weights(t(dists), 1.577, 0.8951).numpy(),
        np.asarray(JG.curve_weights(jnp.asarray(dists), jnp.float32(1.577),
                                    jnp.float32(0.8951))),
        rtol=1e-5)


def test_symmetrize_matches_jax():
    dists, nbrs = _knn_graph(seed=2)
    w = np.asarray(JG.fuzzy_weights(jnp.asarray(dists))[0])
    got = PG.symmetrize(t(nbrs), t(w))
    want = JG.symmetrize(jnp.asarray(nbrs), jnp.asarray(w))
    for name in ("rows", "cols", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               rtol=1e-5)
    np.testing.assert_allclose(PG.to_dense(got).numpy(),
                               np.asarray(JG.to_dense(want)), rtol=1e-5)
    dense = PG.symmetrize_dense(t(nbrs), t(w))
    want_d = JG.symmetrize_dense(jnp.asarray(nbrs), jnp.asarray(w))
    np.testing.assert_array_equal(dense.nbrs.numpy(), np.asarray(want_d.nbrs))
    np.testing.assert_array_equal(dense.bwd_valid.numpy(),
                                  np.asarray(want_d.bwd_valid))
    np.testing.assert_allclose(dense.weights.numpy(),
                               np.asarray(want_d.weights), rtol=1e-5)


def test_symmetrize_golden(g):
    graph = PG.symmetrize(t(g["sym_nbrs"]), t(g["sym_weights"]))
    dense = PG.to_dense(graph).numpy()
    np.testing.assert_allclose(dense, g["sym_dense"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dense, dense.T, rtol=1e-5, atol=1e-6)


def test_embed_query_matches_jax():
    rng = np.random.default_rng(3)
    nbrs = rng.integers(0, 50, size=(17, 6)).astype(np.int32)
    w = rng.random((17, 6)).astype(np.float32)
    w[0] = 0.0  # row sums clamp >= 1e-6
    ref = rng.normal(size=(50, 4)).astype(np.float32)
    np.testing.assert_allclose(
        PG.embed_query(t(nbrs), t(w), t(ref)).numpy(),
        np.asarray(JG.embed_query(jnp.asarray(nbrs), jnp.asarray(w),
                                  jnp.asarray(ref))),
        rtol=1e-5, atol=1e-7)


def test_ab_coeffs_match_jax_and_golden(g):
    for md in (0.0, 0.05, 0.1, 0.25, 0.5, 0.99):
        np.testing.assert_allclose(get_ab_coeffs(md), j_ab(md), rtol=1e-12)
    for md, (a_ref, b_ref) in zip(g["ab_min_dists"], g["ab_values"]):
        a, b = get_ab_coeffs(float(md))
        assert abs(a - a_ref) < 5e-3 * max(1.0, abs(a_ref))
        assert abs(b - b_ref) < 5e-3 * max(1.0, abs(b_ref))


@pytest.mark.parametrize("method", ["dense", "chebyshev", "auto"])
def test_spectral_golden_subspace(g, method):
    graph = PG.symmetrize(t(g["sym_nbrs"]), t(g["sym_weights"]))
    ours = PS.spectral_embedding(graph, 4, method=method).numpy()
    assert ours.shape == (96, 4) and np.isfinite(ours).all()
    assert subspace_sv(ours, g["spectral_vectors"]).min() > 0.99
    j_graph = JG.symmetrize(jnp.asarray(g["sym_nbrs"]),
                            jnp.asarray(g["sym_weights"]))
    for j_method in ("dense", "chebyshev"):
        theirs = np.asarray(j_spectral(j_graph, 4, method=j_method))
        assert subspace_sv(ours, theirs).min() > 0.99


def test_chebyshev_matches_jax_and_converges():
    """A larger graph (the filter path proper, not the small-n dense
    guardrail): subspace equal to JAX's filter and to dense eigh, worst
    residual of the returned Ritz vectors <= tol."""
    dists, nbrs = _knn_graph(n=400, k=10, d=3, seed=4)
    w = np.asarray(JG.fuzzy_weights(jnp.asarray(dists))[0])
    graph = PG.symmetrize(t(nbrs), t(w))
    ours = PS.spectral_embedding(graph, 6, method="chebyshev").numpy()
    j_graph = JG.symmetrize(jnp.asarray(nbrs), jnp.asarray(w))
    theirs = np.asarray(j_spectral(j_graph, 6, method="chebyshev"))
    assert subspace_sv(ours, theirs).min() > 0.99
    dense = PS.spectral_embedding(graph, 6, method="dense").numpy()
    assert subspace_sv(ours, dense).min() > 0.99
    lap = PS._Laplacian(graph)
    x = torch.from_numpy(ours)
    theta = (x * lap(x)).sum(0)
    resid = torch.sqrt(((lap(x) - x * theta) ** 2).sum(0)).max()
    assert float(resid) <= 2e-3


def test_lobpcg_matches_jax_on_same_start_block():
    """The port's LOBPCG from JAX's PRNGKey(42) start block against JAX's
    ``lobpcg`` method, and its own seeded start against dense eigh
    (principal-angle cosines > 0.99); ``lobpcg_standard`` itself on the
    same operator and block stops at JAX's iteration (its convergence
    test scales with n) with the same Ritz values (atol 1e-4); the 5k < n
    precondition raises."""
    import functools

    import jax
    from jax.experimental.sparse.linalg import lobpcg_standard as j_lobpcg

    from multimodal_umap_tpu.ops.spectral import (
        _degrees as j_degrees,
        _laplacian_matvec as j_matvec,
    )

    dists, nbrs = _knn_graph(n=400, k=10, d=3, seed=4)
    w = np.asarray(JG.fuzzy_weights(jnp.asarray(dists))[0])
    graph = PG.symmetrize(t(nbrs), t(w))
    j_graph = JG.symmetrize(jnp.asarray(nbrs), jnp.asarray(w))
    theirs = np.asarray(j_spectral(j_graph, 6, method="lobpcg"))
    x0 = t(jax.random.normal(jax.random.PRNGKey(42), (400, 7)))
    j_op = jax.jit(functools.partial(j_matvec, j_graph,
                                     j_degrees(j_graph) ** -0.5))
    j_theta, _, j_iters = j_lobpcg(j_op, jnp.asarray(x0), m=64)
    lap = PS._Laplacian(graph)
    theta, _, iters = PS.lobpcg_standard(
        lambda y: PS._LOBPCG_SHIFT * y - lap(y), x0.clone(), m=64)
    assert iters == int(j_iters) < 64
    np.testing.assert_allclose(theta.numpy(), np.asarray(j_theta), atol=1e-4)
    ours = PS._spectral_lobpcg(graph, 6, x0=x0).numpy()
    assert ours.shape == (400, 6) and np.isfinite(ours).all()
    assert subspace_sv(ours, theirs).min() > 0.99
    seeded = PS.spectral_embedding(graph, 6, method="lobpcg").numpy()
    dense = PS.spectral_embedding(graph, 6, method="dense").numpy()
    assert subspace_sv(seeded, dense).min() > 0.99
    with pytest.raises(ValueError, match="search dim"):
        PS.spectral_embedding(graph, 80, method="lobpcg")


def _cluster_graph(n, k, n_clusters=32, seed=0):
    """(nbrs, weights) of a kNN-shaped graph with ``n_clusters``
    disconnected clusters: each row's ``k`` neighbours are other rows of
    its own cluster, drawn without a distance computation (the fit graph
    of clustered data at a row count too large for an exact kNN here)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_clusters, n)
    order = np.argsort(labels, kind="stable")
    pos = np.empty(n, np.int64)
    pos[order] = np.arange(n)
    counts = np.bincount(labels, minlength=n_clusters)[labels][:, None]
    starts = np.searchsorted(labels[order], labels)[:, None]
    off = rng.integers(1, counts, (n, k))
    nbrs = order[starts + (pos[:, None] - starts + off) % counts]
    return (nbrs.astype(np.int32),
            rng.uniform(0.05, 1.0, (n, k)).astype(np.float32))


@pytest.mark.parametrize("n,out_dim", [(16_384, 64), (131_072, 16)])
def test_lobpcg_stops_at_jax_iteration_at_scale(n, out_dim):
    """JAX's LOBPCG stopping test scales with n (``|r| < eps * 10 * n *
    (theta + |A v|)``), so at the CLI path's 131,072 rows it stops after
    one iteration: the port's ``lobpcg_standard`` on the same operator
    and start block stops at the same iteration, with the same Ritz
    values (atol 2e-4: f32 rounding of two summation orders, carried
    through five 195-column Rayleigh-Ritz steps at 16,384 rows)."""
    import functools

    import jax
    from jax.experimental.sparse.linalg import lobpcg_standard as j_lobpcg

    from multimodal_umap_tpu.ops.spectral import (
        _degrees as j_degrees,
        _laplacian_matvec as j_matvec,
    )

    nbrs, w = _cluster_graph(n, 15)
    j_graph = JG.symmetrize(jnp.asarray(nbrs), jnp.asarray(w))
    x0 = np.array(jax.random.normal(jax.random.PRNGKey(42),
                                    (n, out_dim + 1)))
    d_inv_sqrt = j_degrees(j_graph) ** -0.5
    trivial = 1.0 / d_inv_sqrt
    j_x0 = jnp.asarray(x0).at[:, 0].set(trivial / jnp.linalg.norm(trivial))
    j_theta, _, j_iters = j_lobpcg(
        jax.jit(functools.partial(j_matvec, j_graph, d_inv_sqrt)), j_x0,
        m=64)
    matvec, p_x0 = PS.lobpcg_problem(PG.symmetrize(t(nbrs), t(w)), out_dim,
                                     t(x0))
    theta, _, iters = PS.lobpcg_standard(matvec, p_x0, m=64)
    assert iters == int(j_iters)
    np.testing.assert_allclose(theta.numpy(), np.asarray(j_theta), atol=2e-4)


def test_component_labels_span_the_laplacian_null_space():
    """chip_smoke's component labels (label propagation) equal scipy's
    connected components on a clustered graph, and d^1/2 on each
    component is annihilated by the port's Laplacian (up to its 1e-6
    shift): the exact null space that chip_smoke holds LOBPCG's and
    Chebyshev's null-space columns against."""
    import sys
    from pathlib import Path

    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import component_labels, exact_null_space

    n, n_clusters = 3000, 7
    nbrs, w = _cluster_graph(n, 6, n_clusters=n_clusters, seed=3)
    graph = PG.symmetrize(t(nbrs), t(w))
    labels = component_labels(graph).numpy()
    rows = np.repeat(np.arange(n), nbrs.shape[1])
    n_comp, ref = connected_components(
        coo_matrix((np.ones(rows.size), (rows, nbrs.ravel())), (n, n)),
        directed=False)
    assert n_comp == n_clusters
    # the same partition, each row labelled by its component's least row
    least_row = np.unique(ref, return_index=True)[1]
    assert (labels == least_row[ref]).all()
    basis = exact_null_space(graph)
    assert basis.shape == (n, n_comp)
    np.testing.assert_allclose(basis.T @ basis, np.eye(n_comp), atol=1e-12)
    lap = PS._Laplacian(graph)
    resid = lap(basis.float()) - PS._EPS_SHIFT * basis.float()
    assert float(resid.abs().max()) < 1e-5
