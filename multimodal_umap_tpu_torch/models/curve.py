"""Gauss-Newton fit of the UMAP curve parameters (a, b).

Fits 1/(1 + a d^(2b)) to the target psi(d) = 1 if d <= min_dist else
exp(-(d - min_dist)) over 200 sample distances on linspace(1e-4, 3),
50 iterations of beta <- beta - pinv(J) @ r. min_dist=0.1 yields
(a, b) = (1.5770, 0.8951), umap-learn's canonical fit.

Pure numpy with an analytic Jacobian (200 scalars, 50 iterations);
the port's own copy of ``multimodal_umap_tpu/models/curve.py``.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=64)
def get_ab_coeffs(min_dist: float, num_iters: int = 50) -> tuple[float, float]:
    """Returns the fitted (a, b) UMAP curve coefficients."""
    d = np.linspace(1e-4, 3.0, 200, dtype=np.float64)
    target = np.where(d <= min_dist, 1.0, np.exp(-(d - min_dist)))
    betas = np.array([1.0, 1.0], dtype=np.float64)

    for _ in range(num_iters):
        a = abs(betas[0]) + 1e-6
        b = abs(betas[1]) + 1e-6
        d2b = d ** (2.0 * b)
        denom = 1.0 + a * d2b
        res = target - 1.0 / denom
        # d(est)/da and d(est)/db for est = 1/denom, via |beta| chain rule.
        d_est_da = -d2b / denom**2 * np.sign(betas[0])
        d_est_db = -2.0 * a * d2b * np.log(d) / denom**2 * np.sign(betas[1])
        # residual = target - est  =>  J = -d(est)/dbeta
        jac = np.stack([-d_est_da, -d_est_db], axis=1)
        betas = betas - np.linalg.pinv(jac) @ res

    return float(abs(betas[0]) + 1e-6), float(abs(betas[1]) + 1e-6)
