"""PyTorch port: the fit layout's attraction and repulsion terms
(``ops/layout_terms.py``) and their CUDA kernels (``csrc/layout_terms.cu``).

On the CPU: the transposed index (CSR) of the neighbour ids and the
attraction backward's chunk plan over it (hubs at C, C + 1 and several C
in-edges, rows without in-edges, row ranges with hubs outside them, the
sharded engine's rows); the kernels' backward (weights once, then the
gather over the plan's work items), written in PyTorch with the kernels'
index arithmetic, against autograd of the plain terms; the plain and gather
forms against the JAX package's ``_fit_modality_loss(part="attr" /
"rep")`` on JAX's replayed draws; a CPU tensor taking the plain version;
the sharded engine calling the same two functions as the single-device
one. On the card (``cuda`` marker; JAX is imported only by the tests
that compare with it, so on a GPU machine without JAX this runs as
``python -m pytest --noconftest tests/test_torch_layout_terms.py -m
cuda``): the kernels against the plain versions, bit-reproducible over
two runs, a captured replay equal to the eager call, and no CUDA tensor
reaching the plain version.

Tolerances, each with its reason:
* gather form vs autograd, float64: rtol 1e-12, atol 1e-12 x max|grad|
  (the same closed forms; the sums run in another order, and autograd
  differentiates the repulsion's quotient as 1/(1+u) - u/(1+u)^2 where
  the gather form takes 1/(1+u)^2);
* the same in float32: rtol 1e-5, atol 1e-5 x max|grad| (a row's
  gradient sums signed terms, and the quotient's two parts cancel for far
  negatives, so f32 rounding is relative to the largest row entry);
* against JAX: values rtol 1e-5, gradients rtol 2e-4 / atol 1e-6, as in
  ``tests/test_torch_layout.py`` (same f32 formulas, reductions in
  another order);
* kernel vs plain on the card: the float32 kernels against the plain
  version on the same inputs cast to float64 (the exact value to float32
  precision): losses rtol 1e-5; gradients rtol 1e-5, atol 1e-5 x
  max|grad| (the float32 case above). Not against the plain version in
  float32: its autograd of the repulsion cancels for far negatives (the
  quotient's two parts, about u float32 ulps of rounding with u = a s^b),
  which passes 1e-5 of the largest entry where every pair is far, as at
  D = 200-300 on normal rows; the kernel forms 1/(1+u)^2 directly.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from multimodal_umap_tpu_torch.models import layout as PL  # noqa: E402
from multimodal_umap_tpu_torch.ops import layout_terms as LT  # noqa: E402

torch.set_num_threads(1)

A, B = 1.577, 0.8951


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")


def _attr_problem(n, n_rows, row0, k, d, seed, dtype=torch.float64,
                  hub=False, dups=False, device="cpu"):
    """(embed, nbrs, coef) with ids over [0, n - 3) (the last 3 rows get
    no in-edge), a quarter of the coefficients 0; ``hub``: row 7 is every
    other anchor's slot-1 neighbour, or a dict {row: in-degree} of rows
    that take exactly that many slots, picked at random (the other slots
    avoid them); ``dups``: anchor row0 + 1 is a copy of its slot-0
    neighbour (clamp region)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    if isinstance(hub, dict):
        others = np.setdiff1d(np.arange(n - 3), list(hub))
        flat = others[rng.integers(0, others.size, size=n_rows * k)]
        slots = rng.permutation(n_rows * k)
        for row, deg in hub.items():
            flat[slots[:deg]] = row
            slots = slots[deg:]
        nbrs = flat.reshape(n_rows, k)
    else:
        nbrs = rng.integers(0, n - 3, size=(n_rows, k))
        if hub:
            nbrs[::2, 1] = 7
    if dups:
        x[row0 + 1] = x[nbrs[1, 0]]
    coef = rng.random((n_rows, k))
    coef[rng.random((n_rows, k)) < 0.25] = 0.0
    return (torch.tensor(x, dtype=dtype, device=device),
            torch.tensor(nbrs, dtype=torch.int64, device=device),
            torch.tensor(coef, dtype=dtype, device=device))


def _rep_problem(n, n_rows, row0, d, rolls, seed, dtype=torch.float64,
                 device="cpu"):
    """(embed, pi, pi_inv, rolls, rep_coef): anchor row0 + 2 is its own
    negative at offset 0 (a fixed point of pi), rows 0 and 1 are equal,
    every fifth coefficient 0."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x[1] = x[0]
    pi = rng.permutation(n)
    fix = row0 + 2
    j = int(np.flatnonzero(pi == fix)[0])
    pi[j], pi[fix] = pi[fix], fix
    coef = rng.random(n_rows)
    coef[::5] = 0.0
    t = lambda v, dt: torch.tensor(v, dtype=dt, device=device)  # noqa: E731
    return (t(x, dtype), t(pi, torch.int64), t(np.argsort(pi), torch.int64),
            t(rolls, torch.int64), t(coef, dtype))


def _close(got, want, rtol, atol_of_max):
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=atol_of_max * float(want.abs().max()))


def _autograd(term, embed, *args, g=0.37, **kw):
    e = embed.detach().clone().requires_grad_(True)
    loss = term(e, *args, **kw)
    (g * loss).backward()
    return loss.detach(), e.grad


TOL = {torch.float64: (1e-12, 1e-12), torch.float32: (1e-5, 1e-5)}

C = LT.CHUNK_EDGES  # the most in-edges a work item of the backward takes

ATTR_CASES = {  # n, n_rows, row0, k, d, hub, dups
    "whole": (61, 61, 0, 6, 5, False, True),
    "row_range": (70, 29, 23, 5, 4, False, True),
    "hub": (203, 203, 0, 15, 33, True, True),
    "wide": (40, 40, 0, 4, 200, True, True),
    # hubs of exactly C, C + 1 and several C in-edges: one chunk, two,
    # several; in a row range, hubs outside it and inside it
    "chunk_bounds": (160, 160, 0, 6, 5,
                     {3: C, 50: C + 1, 77: 3 * C, 90: 2 * C + 5}, True),
    "range_hubs_outside": (150, 60, 70, 6, 4, {5: 2 * C + 1, 140: C + 1},
                           True),
    "range_hub_inside": (150, 60, 40, 6, 4, {45: 3 * C + 2, 120: C}, True),
    "wide_chunk_bounds": (90, 90, 0, 4, 200, {10: C + 1, 11: 2 * C}, True),
}
HUB_CASES = [c for c, v in ATTR_CASES.items() if isinstance(v[5], dict)]
def _rolls(n, r):
    """r round offsets over [0, n): 0, n - 1, then spread."""
    return [0, n - 1] + [(37 * j * j + 5 * j) % n for j in range(2, r)]


REP_CASES = {  # n, n_rows, row0, d, rolls
    "r1_roll0": (53, 53, 0, 5, [0]),
    "r1_roll_n-1": (53, 53, 0, 5, [52]),
    "r8_whole": (77, 77, 0, 6, [0, 76, 3, 40, 11, 9, 60, 25]),
    "r8_row_range": (77, 30, 41, 6, [0, 76, 3, 40, 11, 9, 60, 25]),
    "wide_row_range": (45, 20, 11, 200, [0, 44, 7]),
    # more rounds than the kernels' batch of 8: a second and third batch
    "r9_whole": (77, 77, 0, 6, _rolls(77, 9)),
    "r17_row_range": (77, 30, 41, 6, _rolls(77, 17)),
}


@pytest.mark.parametrize("case", ["whole", "row_range", "hub"])
def test_reverse_index_lists_each_rows_in_edges(case):
    n, n_rows, row0, k, d, hub, dups = ATTR_CASES[case]
    _, nbrs, _ = _attr_problem(n, n_rows, row0, k, d, 0, hub=hub, dups=dups)
    rev = LT.reverse_index(nbrs, n)
    flat = nbrs.reshape(-1).tolist()
    assert rev.offsets.shape == (n + 1,) and rev.order.shape == (n_rows * k,)
    for t in range(n):
        lo, hi = int(rev.offsets[t]), int(rev.offsets[t + 1])
        want = [e for e, v in enumerate(flat) if v == t]  # slot order
        assert rev.order[lo:hi].tolist() == want
    deg = (rev.offsets[1:] - rev.offsets[:-1])
    assert int(deg[-3:].sum()) == 0  # rows without in-edges
    if hub:
        assert int(deg[7]) >= n_rows // 2


def _sharded_rank1(dtype=torch.float64):
    """Rank 1 of two in the sharded engine: its rows of a graph with a
    hub on each rank's side (row 3 on rank 0's, row 100 on its own), the
    reverse index of those rows over the whole table, as
    ``layout.with_reverse_index`` builds it for a sharded task."""
    from multimodal_umap_tpu_torch.parallel import Mesh, ShardingPlan

    n, k = 160, 6
    embed, nbrs, coef = _attr_problem(n, n, 0, k, 5, 12, dtype,
                                      hub={3: 4 * C + 3, 100: 2 * C + 9},
                                      dups=True)
    plan = ShardingPlan(Mesh(rank=1, size=2, device=torch.device("cpu"),
                             backend="gloo"))
    row0 = plan.row_range(n)[0]
    local_nbrs, local_coef = plan.rows(nbrs), plan.rows(coef)
    return embed, local_nbrs, local_coef, row0


def _plan_case(case, dtype=torch.float64):
    """(embed, nbrs, coef, row0) of a chunk-plan case."""
    if case == "sharded_rank1":
        return _sharded_rank1(dtype)
    n, n_rows, row0, k, d, hub, dups = ATTR_CASES[case]
    embed, nbrs, coef = _attr_problem(n, n_rows, row0, k, d, 11, dtype,
                                      hub=hub, dups=dups)
    return embed, nbrs, coef, row0


@pytest.mark.parametrize("case", HUB_CASES + ["sharded_rank1"])
def test_chunk_plan_covers_each_in_edge_once(case):
    """The backward's work items: every row has its items; a row of at
    most C in-edges is one whole item, a longer one ceil(deg / C) chunks
    of at most C, in CSR order and in consecutive partial rows; every
    in-edge lies in exactly one item."""
    embed, nbrs, _, row0 = _plan_case(case)
    n = embed.shape[0]
    rev = LT.reverse_index(nbrs, n)
    off = rev.offsets.tolist()
    deg = [off[t + 1] - off[t] for t in range(n)]
    assert rev.multi_row.tolist() == [t for t in range(n) if deg[t] > C]
    it = LT.attr_work_items(rev)
    items = {}
    for t, lo, hi, part in zip(*(it[f].tolist() for f in (
            "row", "lo", "hi", "partial"))):
        items.setdefault(t, []).append((part, lo, hi))
    assert sorted(items) == list(range(n))
    covered = []
    for t, mine in items.items():
        if deg[t] <= C:
            assert mine == [(-1, off[t], off[t + 1])]
        else:
            parts = [m[0] for m in mine]
            assert len(mine) == -(-deg[t] // C)
            assert parts == list(range(parts[0], parts[0] + len(mine)))
            assert [m[1] for m in mine] == list(range(off[t], off[t + 1], C))
            assert [m[2] for m in mine][-1] == off[t + 1]
        for _, lo, hi in mine:
            assert 0 <= hi - lo <= C
            covered += range(lo, hi)
    assert sorted(covered) == list(range(nbrs.numel()))
    partials = sorted(p for p in it["partial"].tolist() if p >= 0)
    assert partials == list(range(rev.chunk_multi.shape[0]))
    if case in ATTR_CASES:  # the hubs' exact in-degrees
        for row, want in ATTR_CASES[case][5].items():
            assert deg[row] == want
            assert len(items[row]) == max(1, -(-want // C))
    assert any(d == 0 for d in deg)  # rows with no in-edge
    if "range" in case or case == "sharded_rank1":
        n_rows = nbrs.shape[0]
        outside = [t for t in rev.multi_row.tolist()
                   if not row0 <= t < row0 + n_rows]
        assert outside or case == "range_hub_inside"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_attr_gather_backward_is_autograd_sharded(dtype):
    embed, nbrs, coef, row0 = _sharded_rank1(dtype)
    _, want = _autograd(LT.fit_attraction_plain, embed, nbrs, coef, A, B,
                        row0=row0)
    got = LT._attr_grad_gather(embed, nbrs, coef,
                               LT.reverse_index(nbrs, embed.shape[0]), 0.37,
                               A, B, row0=row0)
    _close(got, want, *TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(ATTR_CASES))
def test_attr_gather_backward_is_autograd(case, dtype):
    n, n_rows, row0, k, d, hub, dups = ATTR_CASES[case]
    embed, nbrs, coef = _attr_problem(n, n_rows, row0, k, d, 1, dtype,
                                      hub=hub, dups=dups)
    _, want = _autograd(LT.fit_attraction_plain, embed, nbrs, coef, A, B,
                        row0=row0)
    got = LT._attr_grad_gather(embed, nbrs, coef, LT.reverse_index(nbrs, n),
                               0.37, A, B, row0=row0)
    _close(got, want, *TOL[dtype])
    if dups:  # the clamped pair moves neither row
        j = int(nbrs[1, 0])
        assert float((embed[row0 + 1] - embed[j]).abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", list(REP_CASES))
def test_rep_gather_backward_is_autograd(case, dtype):
    n, n_rows, row0, d, rolls = REP_CASES[case]
    args = _rep_problem(n, n_rows, row0, d, rolls, 2, dtype)
    _, want = _autograd(LT.fit_repulsion_plain, *args, A, B, row0=row0)
    got = LT._rep_grad_gather(*args, 0.37, A, B, row0=row0)
    _close(got, want, *TOL[dtype])


def _fit_graph(n, d, k, seed):
    """A JAX-built fit graph and its port twin (identical arrays)."""
    import jax.numpy as jnp

    from multimodal_umap_tpu.ops.graph import fuzzy_weights, symmetrize_dense
    from multimodal_umap_tpu.ops.knn import knn as j_knn
    from multimodal_umap_tpu_torch.ops.graph import DenseSymGraph

    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))
    dist, nbrs = j_knn(x, x, k, exclude_self=True)
    w, _, _ = fuzzy_weights(dist)
    jd = symmetrize_dense(nbrs, w)
    pd = DenseSymGraph(nbrs=torch.tensor(np.asarray(jd.nbrs)),
                       weights=torch.tensor(np.asarray(jd.weights)),
                       bwd_valid=torch.tensor(np.asarray(jd.bwd_valid)),
                       num_rows=n)
    return jd, pd


@pytest.mark.parametrize("part,num_rep", [("attr", 0), ("attr", 8),
                                          ("rep", 1), ("rep", 8)])
def test_terms_match_jax_parts(part, num_rep):
    """Plain value and gradient, and the gather-form gradient, against
    ``_fit_modality_loss(part=...)`` on JAX's draws (num_rep 0: the
    modality loss is the attraction alone)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from _torch_parity import jax_fit_draws

    from multimodal_umap_tpu.models import layout as JL

    n, k = 97, 6
    jd, pd = _fit_graph(n, 7, k, seed=4)
    j_task, j_static = JL.fit_task(jd, 32)
    p_task, p_static = PL.fit_task(pd, 32)
    embed = np.random.default_rng(5).normal(size=(n, 4)).astype(np.float32)
    key = jax.random.PRNGKey(7)

    def j_loss(e):
        return JL._fit_modality_loss(
            e, j_task, j_static, key, a=jnp.float32(A), b=jnp.float32(B),
            num_rep=max(num_rep, 1), batch_size=32, deterministic=False,
            part=part)

    v_j, g_j = jax.value_and_grad(j_loss)(jnp.asarray(embed))
    draws = jax_fit_draws(key, n, k, max(num_rep, 1))
    coef, rep_coef = PL._fit_coefs(p_task, p_static, draws, batch_size=32,
                                   deterministic=False)
    e = torch.tensor(embed)
    if part == "attr":
        args = (p_task.nbrs, coef, A, B)
        v, g = _autograd(LT.fit_attraction_plain, e, *args, g=1.0)
        g_gather = LT._attr_grad_gather(e, p_task.nbrs, coef,
                                        LT.reverse_index(p_task.nbrs, n), 1.0,
                                        A, B)
        if num_rep == 0:  # the modality loss without repulsion
            m = PL._fit_modality_loss(e, p_task, p_static, draws, a=A, b=B,
                                      num_rep=0, batch_size=32,
                                      deterministic=False)
            assert torch.equal(m, v)
    else:
        rolls = torch.tensor(PL._fit_rolls(draws, p_static, num_rep))
        args = (draws.pi, draws.pi_inv, rolls, rep_coef, A, B)
        v, g = _autograd(LT.fit_repulsion_plain, e, *args, g=1.0)
        g_gather = LT._rep_grad_gather(e, *args[:4], 1.0, A, B)
    np.testing.assert_allclose(float(v), float(v_j), rtol=1e-5)
    for got in (g, g_gather):
        np.testing.assert_allclose(got.numpy(), np.asarray(g_j), rtol=2e-4,
                                   atol=1e-6)


def _no_kernel(monkeypatch):
    def refuse():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(LT, "_library", refuse)


@pytest.mark.parametrize("term", ["attr", "rep"])
def test_cpu_tensor_takes_the_plain_version(term, monkeypatch):
    _no_kernel(monkeypatch)
    before = (LT.FIT_ATTR_LAUNCHES, LT.FIT_REP_LAUNCHES,
              LT.FIT_ATTR_BWD_LAUNCHES, LT.FIT_REP_BWD_LAUNCHES)
    if term == "attr":
        embed, nbrs, coef = _attr_problem(40, 40, 0, 4, 3, 3, torch.float32)
        args = (nbrs, coef, A, B)
        got = _autograd(LT.fit_attraction, embed, *args)
        want = _autograd(LT.fit_attraction_plain, embed, *args)
    else:
        args = _rep_problem(40, 40, 0, 3, [5, 17], 3, torch.float32)
        got = _autograd(LT.fit_repulsion, *args, A, B)
        want = _autograd(LT.fit_repulsion_plain, *args, A, B)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert before == (LT.FIT_ATTR_LAUNCHES, LT.FIT_REP_LAUNCHES,
                      LT.FIT_ATTR_BWD_LAUNCHES, LT.FIT_REP_BWD_LAUNCHES)


def test_non_cuda_device_raises_without_fallback():
    """Neither a CPU nor a CUDA tensor: the wrappers raise (no plain
    fallback), as they do for a wrong shape or a missing reverse index."""
    embed, nbrs, coef = _attr_problem(20, 20, 0, 3, 3, 4, torch.float32,
                                      device="meta")
    with pytest.raises(ValueError, match="device"):
        LT.fit_attraction(embed, nbrs, coef, A, B,
                          rev=LT.ReverseIndex(nbrs.reshape(-1), nbrs[:, 0],
                                              *(nbrs[:0, 0],) * 3))
    args = _rep_problem(20, 20, 0, 3, [1], 4, torch.float32, device="meta")
    with pytest.raises(ValueError, match="device"):
        LT.fit_repulsion(*args, A, B)
    with pytest.raises(ValueError, match="shape"):
        LT.fit_attraction(embed, nbrs, coef[:, :2], A, B)
    with pytest.raises(ValueError, match="reverse_index"):
        LT.fit_attraction(embed, nbrs, coef, A, B)  # built once, never here


@pytest.mark.parametrize("p", [1, 2])
def test_sharded_engine_calls_the_same_terms(p, tmp_path):
    """The sharded fit loss calls ``fit_attraction`` / ``fit_repulsion``
    once each over its rank's rows of the gathered table: at one rank with
    the single-device engine's coefficients, values, loss and gradient
    (bit-equal); at two ranks with each rank's rows of them, the values
    summing to the single-device terms."""
    import _torch_dist as TD

    n, k = 96, 6
    _, pd = _fit_graph(n, 5, k, seed=8)
    task_np = {"nbrs": pd.nbrs.numpy(), "weights": pd.weights.numpy(),
               "bwd_valid": pd.bwd_valid.numpy()}
    res = TD.run_ranks(TD.term_calls_rank, p, tmp_path, task_np, n, k, 3, 4,
                       11)
    single = res[0]["single"]
    assert [c["term"] for c in single["calls"]] == ["attr", "rep"]
    rows = n // p
    for rank, r in enumerate(res):
        calls = r["sharded"]["calls"]
        assert [c["term"] for c in calls] == ["attr", "rep"]
        for c, s in zip(calls, single["calls"]):
            assert c["row0"] == rank * rows and c["table_rows"] == n
            np.testing.assert_array_equal(
                c["coef"], s["coef"][rank * rows:(rank + 1) * rows])
    if p == 1:
        sh = res[0]["sharded"]
        for c, s in zip(sh["calls"], single["calls"]):
            np.testing.assert_array_equal(c["value"], s["value"])
        np.testing.assert_array_equal(sh["loss"], single["loss"])
        np.testing.assert_array_equal(sh["grad"], single["grad"])
    else:
        for i in range(2):
            total = sum(float(r["sharded"]["calls"][i]["value"]) for r in res)
            np.testing.assert_allclose(total,
                                       float(single["calls"][i]["value"]),
                                       rtol=1e-6)
        grad = np.concatenate([r["sharded"]["grad"] for r in res])
        np.testing.assert_allclose(grad, single["grad"], rtol=1e-5,
                                   atol=1e-7)


# --- on the card ---------------------------------------------------------------

CUDA_ATTR = {  # n, n_rows, row0, k, d, hub, dups
    "main_width": (4099, 4099, 0, 15, 64, True, True),
    "row_range": (3000, 1100, 1700, 15, 64, False, True),
    "d33": (517, 517, 0, 7, 33, True, False),
    "d128": (300, 300, 0, 5, 128, False, False),
    # past 128 columns the instance that holds no row in registers
    "d200": (600, 600, 0, 15, 200, True, True),
    "d300_row_range": (700, 310, 250, 9, 300, True, True),
    # hubs at the chunk bounds (C, C + 1, several C in-edges)
    "main_width_chunk_bounds": (4099, 4099, 0, 15, 64,
                                {7: C, 8: C + 1, 9: 2 * C, 10: 5 * C + 3},
                                True),
    "row_range_chunk_bounds": (3000, 1100, 1700, 15, 64,
                               {5: 3 * C + 1, 2000: C + 1, 2001: C}, True),
    "d200_chunk_bounds": (600, 600, 0, 15, 200, {1: C + 1, 2: 3 * C},
                          True),
}
CUDA_REP = {  # n, n_rows, row0, d, rolls
    "main_width": (4099, 4099, 0, 64, [0, 4098, 5, 512, 1024, 2049, 3000,
                                       7]),
    "row_range": (3000, 1100, 1700, 64, [0, 2999, 17, 800]),
    "d3_r1": (257, 257, 0, 3, [256]),
    "d200": (600, 600, 0, 200, [0, 599, 5, 300, 71, 2, 450, 9]),
    "d300_row_range": (700, 310, 250, 300, [0, 699, 31, 400]),
    # more rounds than the kernels' batch of 8 (the anchor part carried
    # across batches, past 128 columns in the output row)
    "r9": (4099, 4099, 0, 64, _rolls(4099, 9)),
    "r17_row_range": (3000, 1100, 1700, 64, _rolls(3000, 17)),
    "d200_r9": (600, 600, 0, 200, _rolls(600, 9)),
    "d200_r17_row_range": (700, 310, 250, 200, _rolls(700, 17)),
}


def _cuda_attr(case):
    n, n_rows, row0, k, d, hub, dups = CUDA_ATTR[case]
    embed, nbrs, coef = _attr_problem(n, n_rows, row0, k, d, 9,
                                      torch.float32, hub=hub, dups=dups,
                                      device="cuda")
    return embed, (nbrs, coef, A, B), dict(row0=row0)


def _cuda_rep(case):
    n, n_rows, row0, d, rolls = CUDA_REP[case]
    embed, *rest = _rep_problem(n, n_rows, row0, d, rolls, 10,
                                torch.float32, device="cuda")
    return embed, (*rest, A, B), dict(row0=row0)


def _cuda_case(term, case):
    """(kernel term, plain term, embed, args, keywords); the attraction's
    reverse index is built here, as ``train_layout`` builds it before any
    capture."""
    if term == "rep":
        return LT.fit_repulsion, LT.fit_repulsion_plain, *_cuda_rep(case)
    embed, args, kw = _cuda_attr(case)
    rev = LT.reverse_index(args[0], embed.shape[0])

    def kernel(e, *a, **k):
        return LT.fit_attraction(e, *a, rev=rev, **k)

    return kernel, LT.fit_attraction_plain, embed, args, kw


def _f64(args):
    return tuple(a.double() if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)


CUDA_PARAMS = ([("attr", c) for c in CUDA_ATTR]
               + [("rep", c) for c in CUDA_REP])


@pytest.mark.cuda
@pytest.mark.parametrize("term,case", CUDA_PARAMS)
def test_kernels_match_plain_on_cuda(term, case):
    """The float32 kernels against the plain version on the same inputs
    in float64 (see the module note on tolerances)."""
    _require_cuda()
    fn, plain, embed, args, kw = _cuda_case(term, case)
    v, g = _autograd(fn, embed, *args, **kw)
    torch.cuda.synchronize()
    v_p, g_p = _autograd(plain, embed.double(), *_f64(args), **kw)
    torch.testing.assert_close(v.double(), v_p, rtol=1e-5, atol=0.0)
    _close(g.double(), g_p, *TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("term,case", CUDA_PARAMS)
def test_kernels_are_bit_reproducible(term, case):
    _require_cuda()
    fn, _, embed, args, kw = _cuda_case(term, case)
    first = _autograd(fn, embed, *args, **kw)
    second = _autograd(fn, embed, *args, **kw)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("term", ["attr", "rep"])
def test_captured_replay_equals_eager(term):
    """Forward and backward captured in a CUDA graph (inputs at fixed
    addresses, the rolls read on the device) replay bit-equal to the
    eager call, also after the inputs change in place."""
    _require_cuda()
    fn, _, embed, args, kw = _cuda_case(term, "main_width")
    e = embed.clone().requires_grad_(True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        fn(e, *args, **kw).backward()
    torch.cuda.current_stream().wait_stream(side)
    e.grad = None
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loss = fn(e, *args, **kw)
        loss.backward()
    for step in range(2):
        with torch.no_grad():
            e.mul_(1.0 + 0.01 * step)
            if term == "rep":
                args[2].copy_(torch.roll(args[2], 1))  # new rolls
        e.grad.zero_()
        graph.replay()
        want = _autograd(fn, e.detach(), *args, g=1.0, **kw)
        assert torch.equal(loss.detach(), want[0])
        assert torch.equal(e.grad, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("term", ["attr", "rep"])
def test_cuda_tensor_never_takes_the_plain_version(term, monkeypatch):
    _require_cuda()

    def refuse(*_, **__):
        raise AssertionError("a CUDA tensor reached the plain version")

    fn, _, embed, args, kw = _cuda_case(term, "d33" if term == "attr"
                                        else "d3_r1")
    monkeypatch.setattr(LT, "fit_attraction_plain", refuse)
    monkeypatch.setattr(LT, "fit_repulsion_plain", refuse)
    counts = (LT.FIT_ATTR_LAUNCHES + LT.FIT_REP_LAUNCHES,
              LT.FIT_ATTR_BWD_LAUNCHES + LT.FIT_REP_BWD_LAUNCHES)
    _autograd(fn, embed, *args, **kw)
    assert (LT.FIT_ATTR_LAUNCHES + LT.FIT_REP_LAUNCHES,
            LT.FIT_ATTR_BWD_LAUNCHES + LT.FIT_REP_BWD_LAUNCHES) == (
                counts[0] + 1, counts[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("term,case", [("attr", "d33"), ("attr", "d128"),
                                       ("rep", "r17_row_range")])
def test_backward_launches_each_pass(term, case):
    """A backward call launches its edge pass and its gather once each,
    and the attraction's finishing pass once where a row has more than
    CHUNK_EDGES in-edges (d33's hub), else not at all."""
    _require_cuda()
    fn, _, embed, args, kw = _cuda_case(term, case)
    before = dict(LT.BWD_PASS_LAUNCHES)
    _autograd(fn, embed, *args, **kw)
    got = {k: v - before[k] for k, v in LT.BWD_PASS_LAUNCHES.items()}
    hubs = term == "attr" and bool(
        (torch.bincount(args[0].reshape(-1)) > C).any())
    assert hubs == (case == "d33")
    want = {f"fit_{term}_bwd_weights_kernel": 1, f"fit_{term}_bwd_kernel": 1}
    if term == "attr":
        want["fit_attr_bwd_finish_kernel"] = int(hubs)
    assert {k: v for k, v in got.items() if k.startswith(f"fit_{term}")} \
        == want
    assert sum(got.values()) == sum(want.values())
