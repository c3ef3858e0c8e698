"""Draws the spectral init's null space on the CLI graph, on one CUDA card.

    python3 spectral_null_space.py [--draws 8]

Runs ``chip_smoke.py``'s CLI path once (``main_torch.main`` at 131,072
synthetic pairs, bf16 tables, ``--knn_engine approx``; output under
``chip_smoke_out/cli/``), whose text graph has 32 disconnected clusters,
so the normalized Laplacian's null space has 32 dimensions. Then, per
draw, it runs the Chebyshev filter (``spectral_embedding(method=
"chebyshev")``) and LOBPCG with ``tol=0`` (all 64 iterations) from
``--spectral lobpcg``'s start block. The null eigenvalues are equal, so
each method's first column -- the one the spectral init drops as
"trivial" -- is some null vector, and which one changes from draw to
draw with the order of the card's atomic sums. Per draw it prints:

- ``exact``: per method, the least principal-angle cosine between its
  first (components - 1) returned columns and the exact null space (d^1/2
  on each connected component), the measure ``chip_smoke.py`` checks;
- ``via_d_half``: the measure ``chip_smoke.py`` checked before, the
  least cosine between [d^1/2, the first 31 returned columns] of the two
  methods, which assumes the dropped column is d^1/2;
- ``dropped_on_d_half``: per method, |<first column, d^1/2>| of the
  full block, by which the old measure divides its rounding error.

Prints the card (``nvidia-smi`` name and power limit) first and a
summary last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as CS  # noqa: E402


def chebyshev_block(graph, out_dim: int) -> torch.Tensor:
    """``spectral_embedding(method="chebyshev")``'s rounds, at its
    defaults, returning the whole Ritz block (its first column too)."""
    from multimodal_umap_tpu_torch.ops import spectral as PS

    lap = PS._Laplacian(graph)
    x, theta = PS._cheb_init(lap, graph.num_rows, out_dim, guard=8)
    for _ in range(8):
        x, theta = PS._cheb_filter_round(lap, x, theta, degree=24)
        if float(PS._cheb_residual(lap, x, theta, out_dim)) <= 2e-3:
            break
    return x[:, :out_dim + 1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("spectral_null_space: needs a CUDA GPU")
    from multimodal_umap_tpu_torch.ops import spectral as PS

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    _, model, _, _ = CS.cli_path(dev, CS.OUT_DIR)
    graph = model.graphs[0]
    out_dim = model.out_dim
    null = CS.exact_null_space(graph)
    n_comp = null.shape[1]
    d_half = (1.0 / PS._Laplacian(graph).d_inv_sqrt).double()[:, None]
    d_half /= torch.linalg.vector_norm(d_half)
    matvec, x0 = PS.lobpcg_problem(graph, out_dim)
    rows = []
    for draw in range(args.draws):
        cheb_full = chebyshev_block(graph, out_dim)
        lob_full = PS.lobpcg_standard(matvec, x0, m=64, tol=0.0)[1]
        full = {"chebyshev": cheb_full, "lobpcg_tol0": lob_full}
        kept = {k: v[:, 1:out_dim + 1] for k, v in full.items()}
        row = {"draw": draw, "components": n_comp,
               "exact": {k: float(CS.subspace_cosines(
                   v[:, :n_comp - 1], null).min()) for k, v in kept.items()},
               "via_d_half": float(CS.subspace_cosines(
                   *[torch.cat([d_half.float(), v[:, :n_comp - 1]], 1)
                     for v in kept.values()]).min()),
               "dropped_on_d_half": {k: float(
                   (v[:, 0].double() @ d_half[:, 0]).abs())
                   for k, v in full.items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({
        "draws": len(rows),
        "exact_min": {k: min(r["exact"][k] for r in rows)
                      for k in rows[0]["exact"]},
        "via_d_half_min": min(r["via_d_half"] for r in rows),
        "via_d_half_at_or_below_0.99": sum(r["via_d_half"] <= 0.99
                                           for r in rows)}), flush=True)


if __name__ == "__main__":
    main()
