"""The traced fit: ``torch.profiler`` over one whole fit, read into arrays.

Only what the per-layer readers use is kept: every device operation
(kernels, copies, sets) with its interval, each kernel's name and the host
time of the launch it correlates to, the host ranges of the program's
``PhaseTimer`` phases (``record_function``), and the host's operator
intervals, which label the device's idle gaps. Events are read from the
profiler's raw results, without building its per-event Python objects.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses

import numpy as np
import torch

FIT_RANGE = "perfbench/fit"
_DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCHES = ("cuda_runtime", "cuda_driver")
# Host ranges of ``record_function``: the program's phases and the fit's.
_RANGES = ("fit/", "transform/", "invert/", "cli/", "perfbench/")


def _kind(e) -> str:
    """The event's kineto activity type; from its device and name where
    this PyTorch's events do not carry it."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return at()
    name = e.name()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        if name.startswith(_RANGES):
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if name.startswith(_RANGES):
        return "user_annotation"
    if name.startswith("cu") and e.correlation_id():
        return "cuda_runtime"
    return "cpu_op"


@dataclasses.dataclass
class TraceSummary:
    names: list[str]  # kernel name table
    k_name: np.ndarray  # (K,) index into names
    k_start: np.ndarray  # (K,) ns
    k_end: np.ndarray
    k_launch: np.ndarray  # (K,) host ns of the correlated launch, or -1
    d_start: np.ndarray  # every device op, sorted by start
    d_end: np.ndarray
    ranges: dict  # host range name -> list of (start_ns, end_ns)
    cpu_ops: list  # (start_ns, end_ns, name), sorted by start

    @property
    def fit_window(self) -> tuple[int, int] | None:
        r = self.ranges.get(FIT_RANGE)
        return r[0] if r else None

    def busy_ns(self, lo: int, hi: int) -> int:
        """Length of the union of device-op intervals within [lo, hi]."""
        s = np.clip(self.d_start, lo, hi)
        e = np.clip(self.d_end, lo, hi)
        return int(union_length(s, e))

    def kernel_ns(self, match, lo: int, hi: int) -> int:
        """Summed duration of kernels whose name satisfies ``match`` and
        that start in [lo, hi]."""
        sel = np.array([bool(match(n)) for n in self.names], dtype=bool)
        if not sel.any():
            return 0
        m = sel[self.k_name] & (self.k_start >= lo) & (self.k_start <= hi)
        return int((self.k_end[m] - self.k_start[m]).sum())


def union_length(start: np.ndarray, end: np.ndarray) -> float:
    """Length covered by the union of intervals [start_i, end_i]."""
    if start.size == 0:
        return 0.0
    order = np.argsort(start, kind="stable")
    s = start[order].astype(np.float64)
    e = np.maximum.accumulate(end[order].astype(np.float64))
    # an interval adds what lies past every earlier interval's end
    prev = np.concatenate([[-np.inf], e[:-1]])
    return float(np.clip(e - np.maximum(s, prev), 0.0, None).sum())


def idle_gaps(start: np.ndarray, end: np.ndarray, lo: int, hi: int
              ) -> list[tuple[int, int]]:
    """The intervals of [lo, hi] that no device op covers."""
    order = np.argsort(start, kind="stable")
    gaps, cur = [], lo
    for s, e in zip(start[order].tolist(), end[order].tolist()):
        if e <= cur:
            continue
        if s > cur:
            gaps.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        gaps.append((cur, hi))
    return [(a, b) for a, b in gaps if b > a]


@contextlib.contextmanager
def traced_fit():
    """Profiles the block as one fit under the range :data:`FIT_RANGE`;
    yields the profiler, stopped when the block ends (read it with
    :func:`summarize` once the window has closed)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(FIT_RANGE):
            yield prof


def summarize(prof) -> TraceSummary:
    names, index = [], {}
    k_name, k_start, k_end, k_corr = [], [], [], []
    d_start, d_end = [], []
    ranges: dict = {}
    launch: dict = {}
    cpu_ops = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind in _DEVICE_OPS:
            s, d = e.start_ns(), e.duration_ns()
            d_start.append(s)
            d_end.append(s + d)
            if kind == "kernel":
                name = e.name()
                i = index.get(name)
                if i is None:
                    i = index[name] = len(names)
                    names.append(name)
                k_name.append(i)
                k_start.append(s)
                k_end.append(s + d)
                k_corr.append(e.correlation_id())
        elif kind in _LAUNCHES:
            launch[e.correlation_id()] = e.start_ns()
        elif kind == "user_annotation":
            ranges.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
        elif kind == "cpu_op":
            cpu_ops.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.name()))
    cpu_ops.sort()
    return TraceSummary(
        names=names, k_name=np.array(k_name, dtype=np.int64),
        k_start=np.array(k_start, dtype=np.int64),
        k_end=np.array(k_end, dtype=np.int64),
        k_launch=np.array([launch.get(c, -1) for c in k_corr],
                          dtype=np.int64),
        d_start=np.array(d_start, dtype=np.int64),
        d_end=np.array(d_end, dtype=np.int64),
        ranges=ranges, cpu_ops=cpu_ops)


def _innermost(cpu_ops: list, starts: list, t: int) -> str | None:
    """Name of the latest-starting host op that contains time ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    best = None
    # host ops nest, so the innermost is the latest start that still
    # covers t; scan back over a bounded stretch
    for j in range(i, max(i - 4096, -1), -1):
        s, e, name = cpu_ops[j]
        if e >= t:
            best = name
            break
    return best


def phase_at(ranges: dict, t: int) -> str:
    for name, spans in ranges.items():
        if name == FIT_RANGE or not name.startswith(("fit/", "transform/",
                                                     "invert/")):
            continue
        if any(s <= t <= e for s, e in spans):
            return name
    return "outside phases"


def breakdown(summary: TraceSummary, top: int = 10) -> dict:
    """The device ops that took most time in the traced fit, and its
    longest idle gaps labelled by phase and the host op running then."""
    win = summary.fit_window
    if win is None:
        return {}
    lo, hi = win
    m = (summary.k_start >= lo) & (summary.k_start <= hi)
    tot = np.bincount(summary.k_name[m],
                      weights=(summary.k_end[m] - summary.k_start[m]),
                      minlength=len(summary.names))
    order = np.argsort(-tot)[:top]
    ops = [[summary.names[i][:160], float(tot[i]) / 1e9] for i in order
           if tot[i] > 0]
    gaps = idle_gaps(summary.d_start, summary.d_end, lo, hi)
    gaps.sort(key=lambda g: g[0] - g[1])
    starts = [c[0] for c in summary.cpu_ops]
    out = []
    for a, b in gaps[:top]:
        mid = (a + b) // 2
        host = _innermost(summary.cpu_ops, starts, mid) or "no host op"
        out.append([f"{phase_at(summary.ranges, mid)}: {host}"[:160],
                    (b - a) / 1e9])
    return {"device_ops": ops, "idle_gaps": out}
