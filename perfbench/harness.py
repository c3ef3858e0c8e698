"""One run of one cell: set-up, the timed window, the per-layer readers and
the comparison with the reference, driven by the files under ``perfbench/``.

A cell is ``workloads/<cell>.json`` (its configuration, traffic and chips);
the configuration is ``configs/<config>.json`` (the deployment's sizes, the
program's settings, the semantics the reference needs and the limits of the
numbers compared); the traffic is ``traffic/<traffic>.json``, whose
``driver`` names ``drivers/<driver>.py``; each per-layer metric is
``metrics/<metric>.py`` with a ``UNIT`` and a ``read(view)`` that returns a
number or None (nothing to read: the metric is left out of the line).
Adding a configuration, cell, traffic mix or metric adds files; nothing here
names one.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import trace as T
from .judge import verdict

ROOT = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "multimodal_umap_tpu")
OUT_DIR = ROOT / "out"


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    root: Path = ROOT


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, seed: int, device: torch.device,
              root: Path = ROOT) -> Cell:
    wl = load_json(root / "workloads" / f"{name}.json")
    return Cell(name, wl, load_json(root / "configs" / f"{wl['config']}.json"),
                load_json(root / "traffic" / f"{wl['traffic']}.json"),
                int(seed), device, root)


def load_driver(name: str):
    return importlib.import_module(f"{__package__}.drivers.{name}")


def load_metrics(root: Path = ROOT) -> dict:
    """{metric name: module} of every ``metrics/*.py``."""
    out = {}
    for path in sorted((root / "metrics").glob("*.py")):
        if path.name.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(
            "perfbench_metric_" + path.stem.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def banned_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    each compared whole (``multimodal_umap_tpu_torch`` is not
    ``multimodal_umap_tpu``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(BANNED))


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=False, timeout=30)
        line = res.stdout.strip().splitlines()[0]
        name, limit = (s.strip() for s in line.split(",", 1))
        return {"name": name, "power_limit": limit}
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return {}


@dataclasses.dataclass
class RunView:
    """What a per-layer reader reads: the cell, each fit's record and the
    traced fit's summary (None in an untraced run)."""

    cell: Cell
    fits: list
    trace: T.TraceSummary | None

    @property
    def untraced(self) -> list:
        plain = [f for f in self.fits if not f.traced]
        return plain or list(self.fits)

    def median(self, fn) -> float | None:
        vals = [v for v in (fn(f) for f in self.untraced) if v is not None]
        return statistics.median(vals) if vals else None


def _finite(v):
    """JSON has no inf or nan: an unreadable number prints as 1e300."""
    if isinstance(v, float) and not math.isfinite(v):
        return 1e300
    return v


def run(cell: Cell, seconds: float, traced: bool, t_start: float) -> int:
    """Runs the cell; prints the result line (and the compared numbers on
    standard error). Returns the exit code."""
    driver = load_driver(cell.traffic["driver"])
    state = driver.setup(cell)
    setup_s = time.perf_counter() - t_start
    result = driver.window(cell, state, seconds, traced)
    device = {"platform": "gpu" if cell.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(cell.device)
                       if cell.device.type == "cuda" else "cpu"),
              "count": cell.workload["chips"],
              "memory_peak_bytes": int(result["memory_peak_bytes"])}
    line: dict = {}
    info: dict = {}
    if traced:
        t0 = time.perf_counter()
        summary = (T.summarize(result["profile"]) if result["profile"]
                   is not None else None)
        info["trace_read_s"] = time.perf_counter() - t0
        view = RunView(cell, result["fits"], summary)
        metrics = {}
        for name, mod in load_metrics(cell.root).items():
            v = mod.read(view)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": mod.UNIT}
        if summary is not None and summary.fit_window is not None:
            lo, hi = summary.fit_window
            device["busy_s"] = summary.busy_ns(lo, hi) / 1e9
            device["window_s"] = (hi - lo) / 1e9
            line["breakdown"] = T.breakdown(summary)
            _write_trace_note(cell, line["breakdown"], metrics)
    else:
        metrics = {name: {"value": float(v), "unit": unit}
                   for name, (v, unit) in result["metrics"].items()}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    info.update(card=card(), fits=len(result["fits"]),
                fit_seconds=[f.seconds for f in result["fits"]], setup_s=setup_s,
                build_s=state.build_s, **state.setup_parts)
    numbers, extra = driver.check(cell, state, result)
    correct, checks = verdict(numbers, cell.config["limits"])
    info.update(extra)
    # Last, once the readers and the reference have run too.
    found = banned_modules()
    if found:
        print(f"perfbench: modules loaded that the benchmark may not load: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    print("perfbench: " + json.dumps({k: _finite(v) for k, v in info.items()}),
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    out = {"correct": correct, "attempted": result["attempted"],
           "failed": result["failed"], "metrics": metrics, "device": device,
           **line, "build_s": state.build_s,
           "checks": {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                      for k, c in checks.items()}}
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


def _write_trace_note(cell: Cell, brk: dict, metrics: dict) -> None:
    """A small record of the traced run in the ignored ``out/``."""
    OUT_DIR.mkdir(exist_ok=True)
    path = OUT_DIR / f"{cell.name}.seed{cell.seed}.trace.json"
    path.write_text(json.dumps({"breakdown": brk, "metrics": metrics},
                               indent=1))
