"""Fuzzy memberships and the fuzzy-union symmetric graph.

Per row i: rho_i the nearest distance, sigma_i solving
sum_j exp(-(d_ij - rho_i) / sigma_i) = log2(k) by 20 Newton steps from 1.0
(derivative regularised by 1e-6, sigma clamped >= 1e-6: the published
solver of the system), memberships w_ij = exp(-(d_ij - rho_i) / sigma_i),
and the union w_ij + w_ji - w_ij w_ji, where w_ji is 0 unless i is among
j's neighbours.

The Newton steps do not settle on every row: where a step overshoots,
sigma is clamped to 1e-6 and the steps then swing between the clamp and
1e-6 + (log2(k) - 1) / 1e-6, about 2.9e6, where the 20th step leaves them.
Which way a row goes can turn on the last bits of its distances, where the
steps wander before they settle: :func:`fragile_rows` finds those rows.
"""

from __future__ import annotations

import math

import torch


def solve_sigmas(d: torch.Tensor, rho: torch.Tensor, num_iters: int = 20,
                 path: list | None = None) -> torch.Tensor:
    """``path``, if given, receives sigma after each step."""
    target = math.log2(d.shape[1])
    shifted = (d - rho[:, None]).clamp_min(0.0)
    sigma = torch.ones_like(rho)
    for _ in range(num_iters):
        e = torch.exp(-shifted / sigma[:, None])
        f = e.sum(1) - target
        df = (e * shifted).sum(1) / (sigma * sigma)
        sigma = (sigma - f / (df + 1e-6)).clamp_min(1e-6)
        if path is not None:
            path.append(sigma)
    return sigma


def solve_residual(d: torch.Tensor, rho: torch.Tensor,
                   sigma: torch.Tensor) -> torch.Tensor:
    """(N,) |sum_j exp(-(d_ij - rho_i) / sigma_i) - log2(k)| / log2(k)."""
    target = math.log2(d.shape[1])
    shifted = (d - rho[:, None]).clamp_min(0.0)
    return (torch.exp(-shifted / sigma[:, None]).sum(1) - target).abs() / target


# The last step at which a settled row's solve may still jump by more than
# a factor of 2, or first reach the clamp.
SETTLE_STEP = 5


def fragile_rows(d: torch.Tensor, rel: float = 1e-6, tol: float = 1e-2,
                 draws: int = 4) -> torch.Tensor:
    """(N,) bool: rows whose 20th step turns on the last bits. A row is
    fragile where its solve still jumps by more than a factor of 2 after
    step :data:`SETTLE_STEP` before it settles, where it first reaches the
    clamp after that step, or where its 20th step moves by more than
    ``tol`` of itself when its distances move by ``rel`` of themselves
    (alternate signs along the row both ways, and ``draws`` seeded random
    signs) or when the solve runs in float32: on the oscillation that is a
    row that leaves it on the other side, at the clamp, whose memberships
    are then all but the nearest 0 instead of 1."""
    path: list = []
    sigma = solve_sigmas(d, d.min(1).values, path=path)
    steps = torch.stack(path, 1)
    prev = torch.cat([torch.ones_like(steps[:, :1]), steps[:, :-1]], 1)
    jumps = (steps > 2.0 * prev) | (steps < 0.5 * prev)
    after = torch.arange(steps.shape[1], device=d.device) > SETTLE_STEP
    solved = solve_residual(d, d.min(1).values, sigma) < 1e-6
    late_jump = (jumps & after).any(1) & solved
    late_clamp = ((steps <= 1e-6) & after).any(1) & ~(
        (steps <= 1e-6) & ~after).any(1)
    fragile = late_jump | late_clamp
    signs = [torch.ones(d.shape[1], dtype=d.dtype, device=d.device)]
    signs[0][1::2] = -1.0
    signs.append(-signs[0])
    gen = torch.Generator(device=d.device).manual_seed(0)
    signs += [torch.randint(0, 2, d.shape, generator=gen, device=d.device)
              .to(d.dtype) * 2.0 - 1.0 for _ in range(draws)]
    for dp in [d * (1.0 + rel * s) for s in signs] + [d.float()]:
        sp = solve_sigmas(dp, dp.min(1).values).double()
        fragile |= (sp - sigma).abs() > tol * sigma
    return fragile


def memberships(d: torch.Tensor, rho: torch.Tensor,
                sigma: torch.Tensor) -> torch.Tensor:
    return torch.exp(-(d - rho[:, None]) / sigma[:, None])


def fuzzy_union(ids: torch.Tensor, w: torch.Tensor, block: int = 16384):
    """((N, k) union weights of each listed pair (i, ids[i, m]),
    (N, k) bool: whether ids[i, m] lists i too)."""
    ids = ids.long()
    sym, back = [], []
    for s in range(0, ids.shape[0], block):
        nb = ids[s:s + block]
        me = torch.arange(s, s + nb.shape[0], device=ids.device)
        match = ids[nb] == me[:, None, None]  # (rows, k, k)
        w_rev = torch.where(match, w[nb], 0.0).sum(2)
        wf = w[s:s + block]
        sym.append(wf + w_rev - wf * w_rev)
        back.append(match.any(2))
    return torch.cat(sym), torch.cat(back)
