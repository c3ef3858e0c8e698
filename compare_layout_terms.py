"""Time the fit layout's term kernels of several checkouts in turns on one
CUDA GPU.

    python3 compare_layout_terms.py TREE [TREE ...] [--rows N] [--cells]
                                    [--out FILE]

Each TREE is the root of a checkout of this repository (``.`` for this
one; an earlier commit unpacked with ``git archive`` into a git-ignored
directory). In the order given -- for an A/B, parent change change parent
-- one process a tree, with that tree's package and its own kernel build,
runs this checkout's ``chip_smoke.layout_terms`` phase (``--cells``:
with the benchmark cells' rows, ``TERM_CELL_SHAPES``, beside its own
shapes): the same shapes, checks (against plain, bit-equal twice) and
timers for every tree (a forward whose gradient is wanted, one under
``no_grad``, a forward and its backward; each kernel's own ms). The
main path's inputs come from a fit as ``chip_smoke.py`` runs it, cut to 2
fit epochs (``--rows``: of that many pairs instead of the main path's
31,744): the first fit-layout call, whose inputs are kept, is the same
as in the full fit. Prints the card (``nvidia-smi`` name and power limit),
then one JSON line a run: per term and shape the kernels' ms of each
timed call, each kernel's own ms, the plain version's ms, the bound,
whether it held against plain and was bit-equal twice, and the in-degree
and chunk counts. Each run also replays the first run's first
fit-layout call (``train_layout(mode="fit")``, captured on the card; its
inputs kept in ``FIRST_FIT``, since the graph built on the card differs
a little from process to process) for ``TRAJECTORY_EPOCHS`` epochs and
prints the sha256 of the fitted embeddings and the loss history: the
terms' forward values feed only the loss history, so a change to the
kernels that keeps the gradients' bits keeps the digest of every tree
equal (the last
line says whether the digests agree, and the largest relative
difference of the loss histories from the first run's). ``--out`` keeps each run's whole phase line. Needs a GPU; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# Epochs of the replayed first fit-layout call (the trajectory check),
# and the file that keeps its inputs from the first run for the others
TRAJECTORY_EPOCHS = 20
FIRST_FIT = os.path.join(HERE, "chip_smoke_out", "first_fit_call.pt")

# Runs in the tree's root with the tree's package first on sys.path and
# this checkout's chip_smoke.py loaded by path.
CHILD = r"""
import hashlib, importlib.util, json, os, sys, torch
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
CS = importlib.util.module_from_spec(spec)
spec.loader.exec_module(CS)
from multimodal_umap_tpu_torch.config import Config
from multimodal_umap_tpu_torch.data.synthetic import clustered_modalities
from multimodal_umap_tpu_torch.eval.validation import train
from multimodal_umap_tpu_torch.models import layout as PL, mixture as MX

first_fit = {}

def observed(inits, tasks, statics, **kw):
    if kw["mode"] == "fit" and not first_fit:
        first_fit.update(inits=[e.detach().clone() for e in inits],
                         tasks=tasks, statics=statics, kw=kw)
    return PL.train_layout(inits, tasks, statics, **kw)

MX.train_layout = observed

dev = torch.device("cuda")
rows = int(sys.argv[4])
data = clustered_modalities(rows + CS.N_TEST, dims=CS.DIMS, seed=0,
                            centers_seed=1)
train_np = {k: v[:rows] for k, v in data.items()}
del data
cfg = Config()
cfg.train_epochs = 2
with CS.first_term_inputs({}) as main:
    train(train_np, cfg, device=dev)
MX.train_layout = PL.train_layout
del train_np
if os.path.exists(sys.argv[3]):
    first_fit = torch.load(sys.argv[3], map_location=dev, weights_only=False)
else:
    first_fit["kw"] = {k: v for k, v in first_fit["kw"].items()
                       if k not in ("epochs", "chunk_callback")}
    first_fit["tasks"] = [t._asdict() for t in first_fit["tasks"]]
    first_fit["statics"] = [s._asdict() for s in first_fit["statics"]]
    torch.save(first_fit, sys.argv[3])
embeds, hist = PL.train_layout(
    first_fit["inits"], [PL.LayoutTask(**t) for t in first_fit["tasks"]],
    [PL.TaskStatic(**s) for s in first_fit["statics"]],
    epochs=int(sys.argv[2]), **first_fit["kw"])
digest = hashlib.sha256()
for e in embeds:
    digest.update(e.detach().cpu().numpy().tobytes())
line = CS.layout_terms(main, dev, cells=sys.argv[5] == "1")
line["trajectory"] = {"epochs": int(sys.argv[2]),
                      "embed_sha256": digest.hexdigest(),
                      "loss_history": hist.tolist()}
print("RESULT " + json.dumps(line), flush=True)
"""

PLAN_KEYS = ("max_in_degree", "max_csr_in_degree", "multi_chunk_rows",
             "chunks")
# The timed calls of chip_smoke.check_term (``bwd``: step - fwd)
CALLS = ("fwd", "fwd_loss_only", "bwd", "step")


def summary(line: dict) -> dict:
    out = {}
    for term in ("attr", "rep"):
        for shape, v in line[term].items():
            out[f"{term}/{shape}"] = {
                "rows": v["rows"], "row0": v["row0"], "ms": v["ms"],
                "kernel_ms": v["kernel_ms"], "plain_ms": v["plain_ms"],
                "plain_timing": v["plain_timing"],
                "bound_ms": {w: v["work"][w]["bound_ms"] for w in CALLS},
                "ok": v["ok"], "bit_equal_twice": v["bit_equal_twice"],
                **{k: v["work"][k] for k in PLAN_KEYS if k in v["work"]}}
    return out


def trajectories_agree(full: list) -> dict:
    """Whether every run's fit-embedding digest equals the first run's, and
    the largest relative difference of a loss history from the first
    run's."""
    t0 = full[0]["line"]["trajectory"]
    rel = 0.0
    for run in full[1:]:
        t = run["line"]["trajectory"]
        rel = max([rel] + [abs(x - y) / abs(y) for x, y in
                           zip(t["loss_history"], t0["loss_history"])])
    return {"embed_sha256_equal": all(
                r["line"]["trajectory"]["embed_sha256"] == t0["embed_sha256"]
                for r in full),
            "loss_history_max_rel_diff": rel}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--cells", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as CS

    rows = CS.N_TRAIN if args.rows is None else args.rows
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi, "rows": rows, "cells": args.cells}),
          flush=True)
    full = []
    os.makedirs(os.path.dirname(FIRST_FIT), exist_ok=True)
    if os.path.exists(FIRST_FIT):
        os.remove(FIRST_FIT)
    for i, tree in enumerate(args.trees):
        root = os.path.abspath(tree)
        env = {**os.environ, "PYTHONPATH": root}
        res = subprocess.run(
            [sys.executable, "-c", CHILD, os.path.join(HERE, "chip_smoke.py"),
             str(TRAJECTORY_EPOCHS), FIRST_FIT, str(rows),
             "1" if args.cells else "0"],
            cwd=root, env=env, capture_output=True, text=True, check=False)
        got = [ln[7:] for ln in res.stdout.splitlines()
               if ln.startswith("RESULT ")]
        if res.returncode != 0 or not got:
            print(res.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"run {i} in {tree} failed "
                             f"({res.returncode})")
        line = json.loads(got[0])
        full.append({"run": i, "tree": tree, "line": line})
        t = line["trajectory"]
        print(json.dumps({"run": i, "tree": tree, "terms": summary(line),
                          "trajectory": {
                              "epochs": t["epochs"],
                              "embed_sha256": t["embed_sha256"],
                              "loss_first_last": [t["loss_history"][0],
                                                  t["loss_history"][-1]]}}),
              flush=True)
    os.remove(FIRST_FIT)
    print(json.dumps({"trajectories": trajectories_agree(full)}),
          flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(full, f)


if __name__ == "__main__":
    main()
