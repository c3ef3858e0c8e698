"""Times the kNN tile kernel against other builds of it, on one CUDA card.

    python3 compare_knn_tile.py --old-src OLD.cu [OLDER.cu ...]
        [--mode bf16|f32] [--reps 10]

Each OLD.cu is an earlier ``csrc/knn_tile.cu`` with either C interface:
the first one (``knn_tile_launch(q, r, d_out, i_out, Q, N, D, tile_k,
row_offset, exclude_self, bf16, stream)``, norms computed inside) or the
current one (norm pointers after ``r``, filled by the current norm
pre-pass in bf16 mode, null in f32 mode). Its column tile is read from
its ``TILE_C``. Each is built with ``nvcc`` into ``build/``; the current
kernel is built by ``ops/knn_tile.py``. All run on the main-path block
of ``chip_smoke.py`` (rows [0, 8192) of the 31,744 x 4,096 synthetic
image table against all of it, exclude_self; bf16 mode: the table in
bf16, tile_k=32; f32 mode: in f32, tile_k=15) cut to its first D = 64,
768 and 4,096 columns, in turns: the builds in order, then in reverse
order, for three rounds. Per build, a line through the D=768 and
D=4,096 times separates the cost that grows with D (the main loop) from
the cost per tile that does not (the selection). Prints the card
(``nvidia-smi`` name and power limit) and one JSON object per D, then
the fits. In f32 mode each D's line also gives the worst error, over
the block, of three panels against a float64 panel, relative to the
cancelled-term scale max |q|^2 + max |r|^2: the plain f32 panel (TF32
off), the three-pass split panel (``tf32_split_plain``'s hi and TF32 lo)
taken by ``torch.matmul`` with TF32 on, which sums all of D on the
tensor cores with no promotion, and the current kernel's returned
distances (at their ids).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

import torch

from chip_smoke import BLOCK_ROWS, DIMS, N_TEST, N_TRAIN, cuda_ms

ROUNDS = 3


def build_old(src: str) -> tuple[ctypes.CDLL, bool, int]:
    """(library, takes norm pointers, column tile) of an earlier source."""
    from torch.utils.cpp_extension import CUDA_HOME

    text = open(src).read()
    with_norms = bool(re.search(r"knn_tile_launch\([^)]*q_sq", text))
    tile_c = int(re.search(r"constexpr int TILE_C = (\d+);", text).group(1))
    tag = hashlib.sha1(text.encode()).hexdigest()[:12]
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       f"knn_tile_old_{tag}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), "-gencode",
               "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-o", out, src]
        if with_norms:
            cmd += [f"-L{os.path.join(CUDA_HOME, 'lib64', 'stubs')}", "-lcuda"]
        subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(out)
    lib.knn_tile_launch.argtypes = (
        [ctypes.c_void_p] * (6 if with_norms else 4) + [ctypes.c_int] * 7
        + [ctypes.c_void_p])
    lib.knn_tile_launch.restype = ctypes.c_int
    return lib, with_norms, tile_c


def panel_errors(KT, q, r, d_k, i_k) -> dict:
    """Worst |panel - float64 panel| / (max |q|^2 + max |r|^2) of the plain
    f32 panel, the unpromoted three-pass TF32 panel and the kernel's
    returned distances (see the module docstring)."""
    q64, r64 = q.double(), r.double()
    q_sq, r_sq = (q64 ** 2).sum(1), (r64 ** 2).sum(1)
    scale = float(q_sq.max() + r_sq.max())
    dot64 = q64 @ r64.T

    def err(dot):
        return float((2.0 * (dot.double() - dot64)).abs().max()) / scale

    out = {"plain_f32": err(q @ r.T)}
    (qh, ql), (rh, rl) = KT.tf32_split_plain(q), KT.tf32_split_plain(r)
    ql, rl = KT.tf32_split_plain(ql)[0], KT.tf32_split_plain(rl)[0]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out["tf32_3pass_unpromoted"] = err(ql @ rh.T + qh @ rl.T + qh @ rh.T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    rows = torch.arange(q.shape[0], device=q.device)[None, :, None]
    ids = i_k.long()
    fin = torch.isfinite(d_k)
    ids = ids.clamp(max=r.shape[0] - 1)  # padded columns: +inf, masked
    exact = (q_sq[rows] + r_sq[ids]) - 2.0 * dot64[rows, ids]
    out["kernel"] = float((d_k.double() - exact.clamp_min(0.0))[fin]
                          .abs().max()) / scale
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-src", required=True, nargs="+")
    ap.add_argument("--mode", choices=("bf16", "f32"), default="bf16")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_knn_tile: needs a CUDA GPU")
    from multimodal_umap_tpu_torch.data.synthetic import clustered_modalities
    from multimodal_umap_tpu_torch.ops import knn_tile as KT

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    data = clustered_modalities(N_TRAIN + N_TEST, dims=DIMS, seed=0,
                                centers_seed=1)
    bf16 = args.mode == "bf16"
    table = torch.from_numpy(data["images"][:N_TRAIN]).cuda()
    table = table.bfloat16() if bf16 else table
    del data
    tk = KT.bf16_tile_k(15, N_TRAIN - 1) if bf16 else 15
    stream = torch.cuda.current_stream().cuda_stream
    olds = {os.path.basename(s): build_old(s) for s in args.old_src}
    names = [*olds, "current"]
    times = {}
    for d in (64, 768, DIMS[1]):
        rb = table[:, :d].contiguous()
        qb = rb[:BLOCK_ROWS]
        nq, n = qb.shape[0], rb.shape[0]
        q_sq = r_sq = None
        if bf16:
            q_sq, r_sq = KT.row_norms_sq(qb), KT.row_norms_sq(rb)
        runners = {"current": lambda: KT.knn_tile(
            qb, rb, tk, exclude_self=True, q_sq=q_sq, r_sq=r_sq)}
        for name, (lib, with_norms, tile_c) in olds.items():
            d_out = torch.empty((-(-n // tile_c), nq, tk), device="cuda")
            i_out = torch.empty_like(d_out, dtype=torch.int32)
            norms = []
            if with_norms:
                norms = ([q_sq.data_ptr(), r_sq.data_ptr()] if bf16
                         else [None, None])

            def run(lib=lib, norms=norms, d_out=d_out, i_out=i_out, name=name):
                err = lib.knn_tile_launch(
                    qb.data_ptr(), rb.data_ptr(), *norms, d_out.data_ptr(),
                    i_out.data_ptr(), nq, n, d, tk, 0, 1, int(bf16), stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            runners[name] = run
        times[d] = {name: [] for name in names}
        for rnd in range(ROUNDS):
            for name in (names if rnd % 2 == 0 else names[::-1]):
                times[d][name].append(cuda_ms(runners[name], args.reps))
        line = {"D": d, "Q": nq, "N": n, "tile_k": tk, "mode": args.mode,
                "ms_in_turns": times[d]}
        if not bf16:
            line["err_of_scale_vs_float64"] = panel_errors(
                KT, qb, rb, *runners["current"]())
        print(json.dumps(line), flush=True)
    fits = {}
    for name in names:
        (d0, t0), (d1, t1) = ((d, min(times[d][name])) for d in (768, DIMS[1]))
        slope = (t1 - t0) / (d1 - d0)
        fits[name] = {"ms_per_1k_d": 1e3 * slope, "ms_at_d0": t0 - slope * d0}
    print(json.dumps({"fit_of_min_times": fits}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
