"""Per-phase wall times.

Each pipeline phase (graph build, layout, transform) runs under a
``torch.profiler.record_function`` range so profiler traces are
attributable, and its wall time is collected for a phase report. On a
CUDA device the phase end synchronizes the device, so a phase's time
covers its kernels and not only their enqueue, and records the device's
peak allocated bytes so far (``torch.cuda.max_memory_allocated``: since
the process started or the caller last reset the peak) in
``peak_bytes``.
"""

from __future__ import annotations

import contextlib
import time

import torch


class PhaseTimer:
    """Collects named phase wall-times; emits a report dict."""

    def __init__(self, device: torch.device | str = "cpu") -> None:
        self.device = torch.device(device)
        self.phases: dict[str, float] = {}
        self.peak_bytes: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                    self.peak_bytes[name] = torch.cuda.max_memory_allocated(
                        self.device)
                self.phases[name] = (
                    self.phases.get(name, 0.0) + time.perf_counter() - t0
                )

    def report(self) -> dict[str, float]:
        return dict(sorted(self.phases.items(), key=lambda kv: -kv[1]))
