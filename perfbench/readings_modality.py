"""Faults confined to one modality, for a configuration of three or more
modalities (not run by the benchmark's runs).

    python3 perfbench/readings_modality.py --workload spokencoco.fit \
        --seeds 1,2 [--modality 2]

The judge's ``pair_cos_*`` read pair (0, 1) only, so a layout fault in a
later modality shows in ``loss_ratio`` alone; these readings set that limit.
For each seed: one sound fit, then the faults planted in modality
``--modality`` (default the last) and nowhere else: ``unchanged`` (its
Adam learning rate 0: every step leaves its state unchanged), ``half``
(half of its rows left out of the loss), ``unpaired`` (its InfoNCE pairs
dropped from the loss) and ``altered_row`` (one of its embedding rows
negated in the fit's outputs). Prints one JSON line a reading, as
``readings.py`` does.
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
FAULTS = ("unchanged", "half", "unpaired")


@contextlib.contextmanager
def planted_in(fault: str, m: int):
    """The program with ``fault`` planted in modality ``m`` alone."""
    import torch

    from multimodal_umap_tpu_torch.models import layout as PL

    make_opt, make_loss, pair = (PL.make_optimizer, PL.make_loss_fn,
                                 PL.L.infonce_pair)
    if fault == "unchanged":
        def frozen_opt(params, lr):
            rest = [p for i, p in enumerate(params) if i != m]
            return torch.optim.Adam(
                [{"params": rest}, {"params": [params[m]], "lr": 0.0}],
                lr=lr, capturable=params[0].device.type == "cuda")

        PL.make_optimizer = frozen_opt
    elif fault == "half":
        def half_loss(*args, **kwargs):
            fn = make_loss(*args, **kwargs)

            def loss(params, *rest, **kw):
                p = params[m]
                cut = list(params)
                cut[m] = torch.cat([p[:p.shape[0] // 2],
                                    p[p.shape[0] // 2:].detach()])
                return fn(cut, *rest, **kw)

            return loss

        PL.make_loss_fn = half_loss
    elif fault == "unpaired":
        # make_loss_fn calls infonce_pair once a pair i < j, in that order
        called = []

        def counted_loss(statics, *args, **kwargs):
            fn = make_loss(statics, *args, **kwargs)
            n = len(statics)
            pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]

            def loss(*a, **kw):
                called.clear()
                called.extend(reversed(pairs))
                return fn(*a, **kw)

            return loss

        def dropped(d_ij, d_ji, a, b, **kw):
            if m in called.pop():
                zero = a.new_zeros(())
                return zero, zero
            return pair(d_ij, d_ji, a, b, **kw)

        PL.make_loss_fn, PL.L.infonce_pair = counted_loss, dropped
    else:
        raise ValueError(f"unknown fault: {fault}")
    try:
        yield
    finally:
        PL.make_optimizer, PL.make_loss_fn = make_opt, make_loss
        PL.L.infonce_pair = pair


def altered_row(outs: list, m: int) -> list:
    """The judged outputs with one embedding row of modality ``m`` negated
    in the first fit."""
    bad = copy.deepcopy(outs)
    e = bad[0][m].embed.clone()
    e[0] = -e[0]
    bad[0][m].embed = e
    return bad


def fault_readings(cell, state, refs, m: int):
    """Yields (kind, numbers, info) for one sound fit of ``cell`` and each
    fault in modality ``m``, all judged on the cell's seed."""
    from perfbench.drivers import fit_loop as FL
    from perfbench.judge import judge

    k = cell.config["program"]["k_neighbors"]
    pcfg = cell.config["program"] | {"infonce": cell.config["infonce"]}

    def fit():
        obs = state.observer
        if obs.module.spectral_embedding is obs.original:  # closed
            state.observer = FL._InitObserver(obs.module)
        res = FL.window(cell, state, 0.0, False)
        return [[FL._outputs(raw, k) for raw in f.outputs]
                for f in res["fits"]]

    sound = fit()
    yield ("sound", *judge(sound, refs, pcfg, cell.seed))
    yield ("fault:altered_row",
           judge(altered_row(sound, m), refs, pcfg, cell.seed)[0], {})
    for fault in FAULTS:
        with planted_in(fault, m):
            outs = fit()
        yield (f"fault:{fault}", *judge(outs, refs, pcfg, cell.seed))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modality", type=int, default=-1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from perfbench import harness
    from perfbench.drivers import fit_loop as FL
    from perfbench.judge import reference_modality

    if not torch.cuda.is_available():
        print("readings_modality: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = harness.load_cell(args.workload, seed, dev)
        m = args.modality % len(cell.config["dims"])
        k = cell.config["program"]["k_neighbors"]
        state = FL.setup(cell)
        refs = [reference_modality(t, k) for t in state.tables]
        t0 = time.perf_counter()
        for kind, numbers, info in fault_readings(cell, state, refs, m):
            print(json.dumps({"seed": seed, "kind": kind, "modality": m,
                              "numbers": numbers, "info": info,
                              "s": time.perf_counter() - t0}), flush=True)
        del refs, state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
