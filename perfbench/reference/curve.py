"""The UMAP output curve's (a, b) from ``min_dist``.

Fits 1 / (1 + a d^(2b)) to psi(d) = 1 for d <= min_dist, else
exp(-(d - min_dist)), over 200 distances on linspace(1e-4, 3) by 50
Gauss-Newton steps from (1, 1) (umap-learn's fit; min_dist 0.1 gives
a = 1.577, b = 0.8951).
"""

from __future__ import annotations

import numpy as np


def ab_coeffs(min_dist: float, num_iters: int = 50) -> tuple[float, float]:
    d = np.linspace(1e-4, 3.0, 200, dtype=np.float64)
    target = np.where(d <= min_dist, 1.0, np.exp(-(d - min_dist)))
    beta = np.array([1.0, 1.0])
    for _ in range(num_iters):
        a, b = abs(beta[0]) + 1e-6, abs(beta[1]) + 1e-6
        d2b = d ** (2.0 * b)
        denom = 1.0 + a * d2b
        res = target - 1.0 / denom
        jac = np.stack([d2b / denom**2 * np.sign(beta[0]),
                        2.0 * a * d2b * np.log(d) / denom**2
                        * np.sign(beta[1])], axis=1)
        beta = beta - np.linalg.pinv(jac) @ res
    return float(abs(beta[0]) + 1e-6), float(abs(beta[1]) + 1e-6)
