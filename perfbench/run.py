"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's cards. Needs
CUDA (no fallback to the CPU): without enough cards it exits non-zero and
prints no result. The last line of standard output is the result (JSON);
the last lines of standard error are the numbers compared, each beside its
limit. With ``--trace 0`` the metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics (the first fit of the window runs
under ``torch.profiler``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # Every build and kernel cache inside the checkout, at fixed paths.
    build = CHECKOUT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(CHECKOUT))
    wl_path = CHECKOUT / "perfbench" / "workloads" / f"{args.workload}.json"
    if not wl_path.is_file():
        print(f"perfbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = json.loads(wl_path.read_text())["chips"]
    import torch

    imported = time.perf_counter() - T_START
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; not running on the CPU", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from perfbench import harness

    cell = harness.load_cell(args.workload, args.seed, dev)
    print(f"perfbench: python and torch loaded in {imported:.3f} s",
          file=sys.stderr)
    return harness.run(cell, args.seconds, bool(args.trace), T_START)


if __name__ == "__main__":
    sys.exit(main())
