"""The comparison that decides ``correct`` for a fit.

The program's outputs of each fit are held against the plain reference
(``reference/``), worked out again from the benchmark's own input tables:

* ``knn_dist_gap``: each row's listed neighbours, their exact distances
  sorted, against the exact k nearest distances; the largest relative
  excess. Near ties that swap the k-th neighbour read about 1e-7; a wrong
  neighbour reads the gap to the true one.
* ``rho_rel_err``: each row's nearest distance against the reference's
  (largest relative error).
* ``sigma_rel_err``: each row's bandwidth against the reference's, on the
  rows whose bandwidth solves its equation in the reference (relative
  residual under :data:`SOLVED`) and that are not fragile. On the other
  rows the published Newton solve ends on its oscillation at about 2.9e6,
  whose exact value turns on the last bits of the arithmetic, and every
  membership of the row is about 1 (``reference/fuzzy.py``); the weights
  judge those rows. On a fragile row the solve's 20th step turns on the last
  bits of the distances (``fuzzy.fragile_rows``). Both shares are reported.
* ``weight_abs_err``: the symmetric fuzzy graph's weights, on the program's
  neighbour lists, against the reference's memberships and fuzzy union (both
  directed copies), on the pairs of rows that are not fragile, and the
  transposed copies' validity on every pair (a mismatch reads 1).
* ``spectral_null_resid``: the spectral initialisation's first
  min(C - 1, out_dim) columns, C the graph's connected components, must lie
  in the exact null space of the normalized Laplacian of the program's own
  symmetric graph (whose weights the number before judges); the largest
  share of a column's norm outside it. Which direction of that C-dimensional
  space the program drops is arbitrary (its Ritz values there are equal),
  so a column along d^1/2 itself is sound; the next two numbers give the
  columns their norm and rank.
* ``spectral_orth_err``: the initialisation's columns must be orthonormal
  (the Ritz vectors the program returns): the largest entry of
  |X^T X - I| over all out_dim columns. A zero, a copied or an unnormalised
  column reads about 1.
* ``spectral_rayleigh_gap``: column j's Rayleigh quotient under the
  normalized Laplacian of the program's symmetric graph against that
  Laplacian's (j + 2)-th smallest eigenvalue (the first, a null vector, is
  the one the program drops), both from the reference in float64; the
  largest absolute gap over the columns. An unconverged, rotated or wrong
  eigenvector reads the gap to the eigenvalue it should have.
* ``loss_ratio``: the fit objective (attraction, repulsion and InfoNCE as
  the reference defines them, on the same draws) at the fitted embeddings
  over its value at the program's initialisation.
* ``pair_cos_gap`` / ``pair_cos_worst``: 1 minus the mean and the least
  cosine between a pair's two embeddings.

Each number is the worst over the modalities and the fits judged; a
malformed output reads inf. A number is correct at or below its limit.
Where the reference follows the program's own state (the neighbour lists
for the weights and the null space, the initialisation for the loss
ratio), that state is judged on its own by the number before it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .reference import fuzzy, spectral
from .reference.curve import ab_coeffs
from .reference.knn import direct_distances, exact_knn
from .reference.loss import fit_loss
from .reference.quality import pair_cosines

# A row's bandwidth solves its equation where the relative residual of
# sum_j exp(-(d_ij - rho_i) / sigma_i) = log2(k) in float64 is under this.
SOLVED = 1e-9

GRAPH_NUMBERS = ("knn_dist_gap", "rho_rel_err", "sigma_rel_err",
                 "weight_abs_err", "spectral_null_resid", "spectral_orth_err",
                 "spectral_rayleigh_gap")
LAYOUT_NUMBERS = ("loss_ratio", "pair_cos_gap", "pair_cos_worst")


@dataclasses.dataclass
class ModalityOutputs:
    """One modality's outputs of a fit, as the reference reads them."""

    ids: torch.Tensor  # (N, k) neighbour lists
    rho: torch.Tensor  # (N,)
    sigma: torch.Tensor  # (N,)
    sym: torch.Tensor  # (N, k) union weight of each listed pair
    sym_t: torch.Tensor  # (N, k) the same, on the transposed copy
    back: torch.Tensor  # (N, k) bool: the pair is listed both ways
    layout_ok: bool = True
    init: torch.Tensor | None = None  # (N, out_dim) spectral init
    embed: torch.Tensor | None = None  # (N, out_dim) fitted embedding


@dataclasses.dataclass
class RefModality:
    x64: torch.Tensor  # (N, D) float64 table
    d: torch.Tensor  # (N, k) exact ascending distances
    ids: torch.Tensor  # (N, k)
    rho: torch.Tensor
    sigma: torch.Tensor
    steady: torch.Tensor  # (N,) bool: not fuzzy.fragile_rows
    solved: torch.Tensor  # (N,) bool: steady, and sigma solves its equation


def reference_modality(table: torch.Tensor, k: int) -> RefModality:
    x64 = table.double()
    d, ids = exact_knn(x64, k)
    rho = d[:, 0].clone()
    sigma = fuzzy.solve_sigmas(d, rho)
    steady = ~fuzzy.fragile_rows(d)
    solved = steady & (fuzzy.solve_residual(d, rho, sigma) < SOLVED)
    return RefModality(x64, d, ids, rho, sigma, steady, solved)


def _max(t: torch.Tensor) -> float:
    v = float(t.max()) if t.numel() else 0.0
    return v if math.isfinite(v) else math.inf


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return _max((a.double() - b).abs() / b.abs().clamp_min(1e-300))


def _lists_ok(ids: torch.Tensor, n: int, k: int) -> bool:
    if ids.shape != (n, k) or int(ids.min()) < 0 or int(ids.max()) >= n:
        return False
    srt = ids.sort(1).values
    own = torch.arange(n, device=ids.device)[:, None]
    return not bool((srt[:, 1:] == srt[:, :-1]).any() or (ids == own).any())


class SpectrumCache:
    """The Laplacian blocks and smallest eigenvalues of the last graph seen
    for one modality, reused while a fit's graph is the same, bit for bit,
    as the one before."""

    def __init__(self):
        self.key = None
        self.value = None

    def get(self, ids, sym, back, sym_t, m: int):
        key = (ids, sym, back, sym_t)
        if self.key is not None and all(
                a.shape == b.shape and torch.equal(a, b)
                for a, b in zip(key, self.key)):
            return self.value
        blocks = list(spectral.laplacian_blocks(ids, sym, back, sym_t))
        self.key, self.value = key, (blocks,
                                     spectral.smallest_spectrum(blocks, m)[0])
        return self.value


def spectral_numbers(init: torch.Tensor, ids, sym, back, sym_t,
                     cache: SpectrumCache | None = None) -> dict:
    """The three numbers of a spectral initialisation (N, out_dim) on the
    program's symmetric graph."""
    if not bool(torch.isfinite(init).all()):
        return {k: math.inf for k in GRAPH_NUMBERS if k.startswith("spec")}
    init = init.double()
    out_dim = init.shape[1]
    basis = spectral.null_basis(ids, sym, back, sym_t)
    m = min(basis.shape[1] - 1, out_dim)
    nums = {"spectral_null_resid": (
        _max(spectral.outside_share(init[:, :m], basis)) if m > 0 else 0.0)}
    gram = init.T @ init
    gram.diagonal().sub_(1.0)
    nums["spectral_orth_err"] = _max(gram.abs())
    try:
        blocks, lam = (cache or SpectrumCache()).get(ids, sym, back, sym_t,
                                                     out_dim + 1)
    except ValueError:
        nums["spectral_rayleigh_gap"] = math.inf
        return nums
    if lam.numel() < out_dim + 1:
        nums["spectral_rayleigh_gap"] = math.inf
        return nums
    q = spectral.rayleigh_quotients(blocks, init)
    nums["spectral_rayleigh_gap"] = _max((q - lam[1:]).abs())
    return nums


def graph_numbers(out: ModalityOutputs, ref: RefModality,
                  cache: SpectrumCache | None = None):
    """(numbers, (ids, sym, back) of the reference graph on the program's
    lists, or None where the lists are malformed)."""
    n, k = ref.ids.shape
    dev = ref.x64.device
    ids = out.ids.to(dev).long()
    if not (out.layout_ok and _lists_ok(ids, n, k)):
        return dict.fromkeys(GRAPH_NUMBERS, math.inf), None
    rows = torch.arange(n, device=dev)
    d_p = direct_distances(ref.x64, rows, ids)
    nums = {
        "knn_dist_gap": _max((d_p.sort(1).values - ref.d)
                             / ref.d.clamp_min(1e-300)),
        "rho_rel_err": _rel(out.rho.to(dev), ref.rho),
        "sigma_rel_err": _rel(out.sigma.to(dev)[ref.solved],
                              ref.sigma[ref.solved]),
    }
    sym, back = fuzzy.fuzzy_union(ids, fuzzy.memberships(d_p, ref.rho,
                                                         ref.sigma))
    pair = ref.steady[:, None] & ref.steady[ids]
    p_sym, p_sym_t = out.sym.to(dev).double(), out.sym_t.to(dev).double()
    err = max(_max((p_sym - sym).abs()[pair]),
              _max((p_sym_t - sym).abs()[pair]))
    if not torch.equal(out.back.to(dev), back):
        err = max(err, 1.0)
    nums["weight_abs_err"] = err
    if out.init is not None:
        nums.update(spectral_numbers(out.init.to(dev), ids, p_sym,
                                     out.back.to(dev), p_sym_t, cache))
    return nums, (ids, sym, back)


def shares(refs: list[RefModality]) -> dict:
    return {"sigma_fragile_share": max(
                1.0 - float(r.steady.double().mean()) for r in refs),
            "sigma_unsolved_share": max(
                1.0 - float(r.solved.double().mean()) for r in refs)}


def layout_numbers(outs: list[ModalityOutputs], graphs, cfg: dict,
                   seed: int) -> tuple[dict, dict]:
    """(numbers, info) of one fit's layout."""
    dev = graphs[0][0].device
    inits = [o.init.to(dev) for o in outs]
    embeds = [o.embed.to(dev) for o in outs]
    if not all(bool(torch.isfinite(e).all()) for e in embeds):
        return dict.fromkeys(LAYOUT_NUMBERS, math.inf), {}
    a, b = ab_coeffs(cfg["min_dist"])
    kw = dict(a=a, b=b, num_rep=cfg["num_rep"], batch_size=cfg["batch_size"],
              alpha=cfg["alpha"], n_neg=cfg["infonce"]["n_neg"],
              temperature=cfg["infonce"]["temperature"],
              group_size=cfg["infonce"]["group_size"], seed=seed)
    start = fit_loss(inits, graphs, **kw)
    end = fit_loss(embeds, graphs, **kw)
    cos = pair_cosines(embeds[0], embeds[1])
    nums = {"loss_ratio": end["total"] / start["total"],
            "pair_cos_gap": 1.0 - float(cos.mean()),
            "pair_cos_worst": 1.0 - float(cos.min())}
    info = {f"{t}_ratio": end[t] / start[t] for t in ("attr", "rep",
                                                        "infonce")
            if start[t] != 0.0}
    info["loss_end"] = end["total"]
    return {k: (v if math.isfinite(v) else math.inf)
            for k, v in nums.items()}, info


def judge(fits: list[list[ModalityOutputs]], refs: list[RefModality],
          cfg: dict, seed: int) -> tuple[dict, dict]:
    """(numbers, info): each number the worst over fits and modalities."""
    worst: dict[str, float] = {}
    info: dict[str, float] = {}

    def take(nums):
        for key, v in nums.items():
            worst[key] = max(worst.get(key, -math.inf), v)

    info.update(shares(refs))
    caches = [SpectrumCache() for _ in refs]
    for f, outs in enumerate(fits):
        graphs = []
        for out, ref, cache in zip(outs, refs, caches):
            nums, graph = graph_numbers(out, ref, cache)
            take(nums)
            graphs.append(graph)
        if any(o.embed is not None for o in outs):
            if any(g is None for g in graphs) or any(
                    o.init is None or o.embed is None for o in outs):
                take(dict.fromkeys(LAYOUT_NUMBERS, math.inf))
                continue
            nums, extra = layout_numbers(outs, graphs, cfg, seed + f)
            take(nums)
            for key, v in extra.items():
                info[key] = max(info.get(key, -math.inf), v)
    return worst, info


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over every limited number; a
    number the run did not produce is not correct."""
    checks = {name: {"value": numbers.get(name, math.inf), "limit": lim}
              for name, lim in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
