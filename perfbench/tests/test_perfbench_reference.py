"""The plain reference on tiny cases worked out by hand."""

import math

import torch

from perfbench.reference import fuzzy, knn, loss, quality, spectral
from perfbench.reference.curve import ab_coeffs


def test_exact_knn_on_a_line():
    x = torch.tensor([[0.0], [1.0], [3.0], [7.0], [15.0]])
    d, ids = knn.exact_knn(x, 2)
    assert ids.tolist() == [[1, 2], [0, 2], [1, 0], [2, 1], [3, 2]]
    assert d.tolist() == [[1, 3], [1, 2], [2, 3], [4, 6], [8, 12]]
    assert d.dtype == torch.float64


def test_bandwidth_and_memberships_by_hand():
    # shifts (0, 1, 1, 1): 1 + 3 exp(-1 / sigma) = log2(4) = 2, so
    # sigma = 1 / ln 3 and the memberships are (1, 1/3, 1/3, 1/3)
    d = torch.tensor([[5.0, 6.0, 6.0, 6.0]], dtype=torch.float64)
    rho = d[:, 0]
    sigma = fuzzy.solve_sigmas(d, rho)
    assert abs(float(sigma) - 1 / math.log(3)) < 1e-12
    w = fuzzy.memberships(d, rho, sigma)
    assert torch.allclose(w, torch.tensor([[1, 1 / 3, 1 / 3, 1 / 3]],
                                          dtype=torch.float64))
    assert float(fuzzy.solve_residual(d, rho, sigma)) < 1e-12


def test_newton_oscillation_and_fragile_rows():
    # shifts (0, 3e-3, 3e-3, 3e-3): the first step overshoots, sigma is
    # clamped and then swings; the 20th step lands near
    # 1e-6 + (log2(4) - 1) / 1e-6, about 1e6, which does not solve the
    # equation
    d = torch.tensor([[5.0, 5.003, 5.003, 5.003]], dtype=torch.float64)
    sigma = fuzzy.solve_sigmas(d, d[:, 0])
    assert float(sigma) > 5e5
    assert float(fuzzy.solve_residual(d, d[:, 0], sigma)) > 0.4
    steady = torch.tensor([[5.0, 6.0, 6.0, 6.0]], dtype=torch.float64)
    assert not bool(fuzzy.fragile_rows(steady).any())
    path = []
    fuzzy.solve_sigmas(d, d[:, 0], path=path)
    assert float(path[0]) == 1e-6  # the first step overshoots to the clamp
    assert not bool(fuzzy.fragile_rows(d).any())
    # a near tie (a second neighbour 4e-7 of the distance further) moves
    # between the oscillation and a solve at the clamp with a millionth
    tie = torch.tensor([[90.0, 90.00004, 90.00004, 90.00004]],
                       dtype=torch.float64)
    assert bool(fuzzy.fragile_rows(tie).all())


def test_fuzzy_union_by_hand():
    ids = torch.tensor([[1], [0], [0]])
    w = torch.tensor([[0.5], [0.25], [0.8]], dtype=torch.float64)
    sym, back = fuzzy.fuzzy_union(ids, w)
    assert torch.allclose(sym, torch.tensor([[0.625], [0.625], [0.8]],
                                            dtype=torch.float64))
    assert back.tolist() == [[True], [True], [False]]


def test_null_space_of_two_components():
    ids = torch.tensor([[1], [0], [3], [2]])
    sym = torch.ones(4, 1, dtype=torch.float64)
    back = torch.ones(4, 1, dtype=torch.bool)
    assert spectral.components(4, torch.tensor([0, 2]),
                               torch.tensor([1, 3])).tolist() == [0, 0, 2, 2]
    basis = spectral.null_basis(ids, sym, back)
    r = 1 / math.sqrt(2)
    assert torch.allclose(basis, torch.tensor(
        [[r, 0], [r, 0], [0, r], [0, r]], dtype=torch.float64))
    x = torch.tensor([[1.0, 1.0], [-1.0, 1.0], [0.0, 1.0], [0.0, 1.0]])
    assert torch.allclose(spectral.outside_share(x, basis),
                          torch.tensor([1.0, 0.0], dtype=torch.float64))


def _triangle_and_pair():
    # a triangle (nodes 0-2) and a pair (3-4), unit weights, k = 2; the
    # pair's second entry is a self-loop of weight 0. The normalized
    # Laplacian's spectrum: triangle 0, 1.5, 1.5; pair 0, 2
    ids = torch.tensor([[1, 2], [0, 2], [0, 1], [4, 3], [3, 4]])
    sym = torch.tensor([[1.0, 1.0]] * 3 + [[1.0, 0.0]] * 2,
                       dtype=torch.float64)
    return ids, sym, torch.ones(5, 2, dtype=torch.bool)


def test_smallest_spectrum_and_rayleigh_quotients_by_hand():
    ids, sym, back = _triangle_and_pair()
    blocks = list(spectral.laplacian_blocks(ids, sym, back))
    lam, vecs = spectral.smallest_spectrum(blocks, 5, vectors=True)
    assert torch.allclose(lam, torch.tensor([0, 0, 1.5, 1.5, 2.0],
                                            dtype=torch.float64))
    q = spectral.rayleigh_quotients(blocks, vecs)
    assert torch.allclose(q, lam, atol=1e-12)
    # two components, so two smallest eigenvalues need no solve
    zeros, _ = spectral.smallest_spectrum(blocks, 2)
    assert zeros.tolist() == [0.0, 0.0]


def test_spectral_numbers_need_norm_rank_and_eigenvalues():
    from perfbench.judge import spectral_numbers

    ids, sym, back = _triangle_and_pair()
    r2, r6 = 1 / math.sqrt(2), 1 / math.sqrt(6)
    sound = torch.tensor([[0, r2, r6], [0, -r2, r6], [0, 0, -2 * r6],
                          [r2, 0, 0], [r2, 0, 0]], dtype=torch.float64)
    nums = spectral_numbers(sound, ids, sym, back, sym)
    assert max(nums.values()) < 1e-12
    zero = sound.clone()
    zero[:, 1] = 0.0
    assert spectral_numbers(zero, ids, sym, back, sym)[
        "spectral_orth_err"] == 1.0
    # the pair's eigenvector of 2 in place of the triangle's of 1.5:
    # orthonormal, but its Rayleigh quotient is 0.5 off
    wrong = sound.clone()
    wrong[:, 2] = torch.tensor([0, 0, 0, r2, -r2], dtype=torch.float64)
    nums = spectral_numbers(wrong, ids, sym, back, sym)
    assert nums["spectral_orth_err"] < 1e-12
    assert abs(nums["spectral_rayleigh_gap"] - 0.5) < 1e-12


def test_attraction_of_one_pair_by_hand():
    # two rows listing each other, weight 1: both kept, one window of two
    # rows, so attraction = 2 * (1/2) * log(1 + a d^b) at d = 1
    a, b = ab_coeffs(0.1)
    x = torch.tensor([[0.0], [1.0]], dtype=torch.float64)
    ids = torch.tensor([[1], [0]])
    gen = torch.Generator().manual_seed(0)
    attr, rep = loss.modality_loss(
        x, ids, torch.ones(2, 1, dtype=torch.float64),
        torch.ones(2, 1, dtype=torch.bool), a=a, b=b, num_rep=1,
        batch_size=2, gen=gen)
    assert abs(float(attr) - math.log1p(a)) < 1e-12
    assert float(rep) > 0.0


def test_curve_and_cosines():
    a, b = ab_coeffs(0.1)
    assert abs(a - 1.577) < 1e-3 and abs(b - 0.8951) < 1e-4
    c = quality.pair_cosines(torch.tensor([[1.0, 0.0], [1.0, 1.0]]),
                             torch.tensor([[2.0, 0.0], [-1.0, -1.0]]))
    assert torch.allclose(c, torch.tensor([1.0, -1.0], dtype=torch.float64))


def test_loss_draws_repeat_with_the_seed():
    gen = torch.Generator().manual_seed(1)
    x = [torch.randn(300, 4, generator=gen) for _ in range(2)]
    ids = torch.stack([(torch.arange(300) + s) % 300 for s in (1, 2, 3)], 1)
    graph = (ids, torch.full((300, 3), 0.6, dtype=torch.float64),
             torch.zeros(300, 3, dtype=torch.bool))
    kw = dict(a=1.577, b=0.8951, num_rep=2, batch_size=64, alpha=1.0,
              n_neg=8, temperature=0.5, group_size=100, seed=5)
    one = loss.fit_loss(x, [graph, graph], **kw)
    assert one == loss.fit_loss(x, [graph, graph], **kw)
    assert one["total"] == one["attr"] + one["rep"] + one["infonce"]
    assert one["infonce"] > 0.0
