"""Time the fit layout's term kernels of several checkouts in turns on one
CUDA GPU.

    python3 compare_layout_terms.py TREE [TREE ...] [--out FILE]

Each TREE is the root of a checkout of this repository (``.`` for this
one; an earlier commit unpacked with ``git archive`` into a git-ignored
directory). In the order given -- for an A/B, parent change change parent
-- one process a tree, with that tree's package and its own kernel build,
runs this checkout's ``chip_smoke.layout_terms`` phase: the same shapes,
checks (against plain, bit-equal twice) and timers for every tree. The
main path's inputs come from a fit as ``chip_smoke.py`` runs it, cut to 2
fit epochs: the first fit-layout call, whose inputs are kept, is the same
as in the full fit. Prints the card (``nvidia-smi`` name and power limit),
then one JSON line a run: per term and shape the kernels' forward and
backward ms, each kernel's own ms, the plain version's ms, the bound,
whether it held against plain and was bit-equal twice, and the in-degree
and chunk counts. ``--out`` keeps each run's whole phase line. Needs a
GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# Runs in the tree's root with the tree's package first on sys.path and
# this checkout's chip_smoke.py loaded by path.
CHILD = r"""
import importlib.util, json, sys, torch
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
CS = importlib.util.module_from_spec(spec)
spec.loader.exec_module(CS)
from multimodal_umap_tpu_torch.config import Config
from multimodal_umap_tpu_torch.data.synthetic import clustered_modalities
from multimodal_umap_tpu_torch.eval.validation import train

dev = torch.device("cuda")
data = clustered_modalities(CS.N_TRAIN + CS.N_TEST, dims=CS.DIMS, seed=0,
                            centers_seed=1)
train_np = {k: v[:CS.N_TRAIN] for k, v in data.items()}
del data
cfg = Config()
cfg.train_epochs = 2
with CS.first_term_inputs({}) as main:
    train(train_np, cfg, device=dev)
del train_np
print("RESULT " + json.dumps(CS.layout_terms(main, dev)), flush=True)
"""

PLAN_KEYS = ("max_in_degree", "max_csr_in_degree", "multi_chunk_rows",
             "chunks")


def summary(line: dict) -> dict:
    out = {}
    for term in ("attr", "rep"):
        for shape, v in line[term].items():
            out[f"{term}/{shape}"] = {
                "rows": v["rows"], "row0": v["row0"], "ms": v["ms"],
                "kernel_ms": v["kernel_ms"], "plain_ms": v["plain_ms"],
                "plain_timing": v["plain_timing"],
                "bound_ms": {w: v["work"][w]["bound_ms"]
                             for w in ("fwd", "bwd")},
                "ok": v["ok"], "bit_equal_twice": v["bit_equal_twice"],
                **{k: v["work"][k] for k in PLAN_KEYS if k in v["work"]}}
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)
    full = []
    for i, tree in enumerate(args.trees):
        root = os.path.abspath(tree)
        env = {**os.environ, "PYTHONPATH": root}
        res = subprocess.run(
            [sys.executable, "-c", CHILD, os.path.join(HERE, "chip_smoke.py")],
            cwd=root, env=env, capture_output=True, text=True, check=False)
        got = [ln[7:] for ln in res.stdout.splitlines()
               if ln.startswith("RESULT ")]
        if res.returncode != 0 or not got:
            print(res.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"run {i} in {tree} failed "
                             f"({res.returncode})")
        line = json.loads(got[0])
        full.append({"run": i, "tree": tree, "line": line})
        print(json.dumps({"run": i, "tree": tree,
                          "terms": summary(line)}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(full, f)


if __name__ == "__main__":
    main()
