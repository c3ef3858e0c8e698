"""Readings that set the limits of the numbers compared (not run by the
benchmark's runs).

    python3 perfbench/readings.py --workload <cell> --seeds 1,2,3 \
        [--control] [--faults unchanged,half,altered]

For each seed: the cell's tables, one fit of the program as the window runs
it, and the judge's numbers (``sound``). ``--control`` adds the control: the
reference put in the program's place and computed one precision below the
configuration's float32 distances, in bfloat16 (the tables rounded to
bfloat16, panels in float32 with TF32 off, no exact re-score; the
bandwidths, memberships and union from those distances; the spectral
initialisation the Laplacian's exact smallest eigenvectors, rounded to
bfloat16). ``--faults`` plants faults at the cell's size: ``unchanged``
(Adam's learning rate 0: every step returns the state unchanged), ``half``
(half of each table's rows left out of the loss, the windows' means taken
over the rest), ``altered`` (one neighbour id and, separately, one embedding
row negated in the fit's outputs), ``spectral_zero`` (the spectral
initialisation all zeros), ``spectral_short`` (its Chebyshev iteration cut
to one round). Prints one JSON line per reading.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def planted(fault: str):
    import torch

    from multimodal_umap_tpu_torch.models import layout as PL
    from multimodal_umap_tpu_torch.ops import spectral as PS

    make_opt, make_loss = PL.make_optimizer, PL.make_loss_fn
    cheb = PS._spectral_chebyshev
    if fault == "spectral_zero":
        PS._spectral_chebyshev = lambda graph, out_dim: torch.zeros(
            graph.num_rows, out_dim, device=graph.weights.device)
    elif fault == "spectral_short":
        PS._spectral_chebyshev = lambda graph, out_dim: cheb(
            graph, out_dim, max_rounds=1)
    elif fault == "unchanged":
        PL.make_optimizer = lambda params, lr: make_opt(params, 0.0)
    elif fault == "half":
        def half_loss(*args, **kwargs):
            fn = make_loss(*args, **kwargs)

            def loss(params, *rest, **kw):
                cut = [torch.cat([p[:p.shape[0] // 2],
                                  p[p.shape[0] // 2:].detach()])
                       for p in params]
                return fn(cut, *rest, **kw)

            return loss

        PL.make_loss_fn = half_loss
    try:
        yield
    finally:
        PL.make_optimizer, PL.make_loss_fn = make_opt, make_loss
        PS._spectral_chebyshev = cheb


def control_outputs(tables, k: int, out_dim: int):
    """The control's graph-stage outputs, one ModalityOutputs a modality."""
    import torch

    from perfbench.judge import ModalityOutputs
    from perfbench.reference import fuzzy, spectral

    torch.backends.cuda.matmul.allow_tf32 = False
    outs = []
    for table in tables:
        x = table.bfloat16().float()
        n = x.shape[0]
        sq = (x * x).sum(1)
        ids, dists = [], []
        for s in range(0, n, 4096):
            panel = torch.addmm(sq[None, :], x[s:s + 4096], x.T, alpha=-2.0)
            panel += sq[s:s + 4096, None]
            rows = torch.arange(panel.shape[0], device=x.device)
            panel[rows, rows + s] = float("inf")
            d, i = torch.topk(panel, k, dim=1, largest=False)
            dists.append(d.clamp_min(0.0).sqrt())
            ids.append(i)
        d, ids = torch.cat(dists), torch.cat(ids)
        rho = d[:, 0].clone()
        sigma = fuzzy.solve_sigmas(d, rho)
        sym, back = fuzzy.fuzzy_union(ids, fuzzy.memberships(d, rho, sigma))
        blocks = spectral.laplacian_blocks(ids, sym.double(), back)
        _, vecs = spectral.smallest_spectrum(blocks, out_dim + 1,
                                             vectors=True)
        init = vecs[:, 1:].bfloat16().double()
        outs.append(ModalityOutputs(ids=ids, rho=rho, sigma=sigma, sym=sym,
                                    sym_t=sym, back=back, init=init))
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from perfbench import harness
    from perfbench.drivers import fit_loop as FL
    from perfbench.judge import judge, reference_modality

    if not torch.cuda.is_available():
        print("readings: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    faults = [f for f in args.faults.split(",") if f]

    def emit(seed, kind, numbers, info=None, **extra):
        print(json.dumps({"seed": seed, "kind": kind, "numbers": numbers,
                          "info": info or {}, **extra}), flush=True)

    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.load_cell(args.workload, seed, dev)
        k = cell.config["program"]["k_neighbors"]
        pcfg = cell.config["program"] | {"infonce": cell.config["infonce"]}
        state = FL.setup(cell)
        t0 = time.perf_counter()
        result = FL.window(cell, state, 0.0, False)
        fit_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        refs = [reference_modality(t, k) for t in state.tables]
        sound = [[FL._outputs(raw, k) for raw in f.outputs]
                 for f in result["fits"]]
        numbers, info = judge(sound, refs, pcfg, seed)
        emit(seed, "sound", numbers, info, fit_s=fit_s)
        if "altered" in faults:
            bad = copy.deepcopy(sound)
            ids = bad[0][0].ids.clone()
            ids[0, 0] = (int(ids[0, 0]) + ids.shape[0] // 2) % ids.shape[0]
            bad[0][0].ids = ids
            emit(seed, "fault:altered_id", judge(bad, refs, pcfg, seed)[0])
            bad = copy.deepcopy(sound)
            e = bad[0][0].embed.clone()
            e[0] = -e[0]
            bad[0][0].embed = e
            emit(seed, "fault:altered_row", judge(bad, refs, pcfg, seed)[0])
        for fault in (f for f in faults if f != "altered"):
            state.observer = FL._InitObserver(state.observer.module)
            with planted(fault):
                res = FL.window(cell, state, 0.0, False)
            outs = [[FL._outputs(raw, k) for raw in f.outputs]
                    for f in res["fits"]]
            emit(seed, f"fault:{fault}", judge(outs, refs, pcfg, seed)[0])
        if args.control:
            ctrl = control_outputs(state.tables, k,
                                   cell.config["program"]["out_dim"])
            emit(seed, "control", judge([ctrl], refs, pcfg, seed)[0])
        del refs, state, result
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
