"""Per-phase wall times, the spans inside a phase, and the sections of a
layout epoch.

Each pipeline phase (graph build, layout, transform) runs under a
``torch.profiler.record_function`` range so profiler traces are
attributable, and its wall time is collected for a phase report. On a
CUDA device the phase end synchronizes the device, so a phase's time
covers its kernels and not only their enqueue, and records the device's
peak allocated bytes so far (``torch.cuda.max_memory_allocated``: since
the process started or the caller last reset the peak) in
``peak_bytes``.

Inside a phase, :func:`span` times a step of it under a nested name
(``fit/graph_0/knn``, ``fit/layout/capture``): a ``record_function``
range of that name and, on CUDA, a pair of timing events on the current
stream, read once the phase has synchronized -- a span never syncs. Its
seconds land in :attr:`PhaseTimer.phases` beside the phase's, summed
over calls. Outside any phase a span is only the range.

While a ``torch.profiler`` is active, the layout also times the sections
of its epoch (:class:`Sections`: draws, the modality terms' forward,
InfoNCE's forward and backward, the rest of the backward, Adam) from
events at their borders, which a captured epoch holds as event-record
nodes; the phase stores each section's seconds over all epochs as
``<phase>/epochs/<section>``. Reading them: ``model.timer.report()``
after a fit gives the phases, the graph stage's spans (``knn``,
``sigma``, ``union``, ``spectral``) and the layout's (``prepare``,
``warmup``, ``capture``, ``epochs``); under ``torch.profiler.profile``
it gives the epoch's sections too.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import time

import torch


@dataclasses.dataclass(frozen=True)
class _Scope:
    """The innermost open phase or span: its full name, the phase's
    device, and the phase's readings to resolve after its sync (callables
    returning {full name: seconds})."""

    name: str
    device: torch.device
    pending: list


_ACTIVE: contextvars.ContextVar[_Scope | None] = contextvars.ContextVar(
    "prof_active_scope", default=None)


def _stamp(device: torch.device, external: bool = False):
    """A point in time: on CUDA a timing event recorded on the current
    stream (``external``: an event-record node when captured in a CUDA
    graph), on the CPU the host clock."""
    if device.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True, external=external)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _elapsed(start, end) -> float:
    """Seconds between two :func:`_stamp` s (events: once both ran)."""
    if isinstance(start, float):
        return end - start
    return start.elapsed_time(end) / 1e3


class PhaseTimer:
    """Collects named phase wall-times; emits a report dict."""

    def __init__(self, device: torch.device | str = "cpu") -> None:
        self.device = torch.device(device)
        self.phases: dict[str, float] = {}
        self.peak_bytes: dict[str, int] = {}

    def _add(self, name: str, seconds: float) -> None:
        self.phases[name] = self.phases.get(name, 0.0) + seconds

    @contextlib.contextmanager
    def phase(self, name: str):
        pending: list = []
        with torch.profiler.record_function(name):
            token = _ACTIVE.set(_Scope(name, self.device, pending))
            t0 = time.perf_counter()
            ok = False
            try:
                yield
                ok = True
            finally:
                _ACTIVE.reset(token)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                    self.peak_bytes[name] = torch.cuda.max_memory_allocated(
                        self.device)
                self._add(name, time.perf_counter() - t0)
                # The events of a phase that raised may never have run.
                for resolve in pending if ok else ():
                    for k, v in resolve().items():
                        self._add(k, v)

    def report(self) -> dict[str, float]:
        return dict(sorted(self.phases.items(), key=lambda kv: -kv[1]))


@contextlib.contextmanager
def span(sub: str):
    """Times the block as ``<innermost open phase or span>/<sub>`` (see
    the module docstring); outside a phase, only a ``record_function``
    range named ``sub``."""
    scope = _ACTIVE.get()
    name = sub if scope is None else f"{scope.name}/{sub}"
    with torch.profiler.record_function(name):
        if scope is None:
            yield
            return
        start = _stamp(scope.device)
        token = _ACTIVE.set(dataclasses.replace(scope, name=name))
        try:
            yield
        finally:
            _ACTIVE.reset(token)
            end = _stamp(scope.device)
            scope.pending.append(lambda: {name: _elapsed(start, end)})


def defer(resolve) -> None:
    """Has the active phase add ``resolve()``'s {sub: seconds}, each as
    ``<innermost open span>/<sub>``, once its sync has run (no phase:
    nothing)."""
    scope = _ACTIVE.get()
    if scope is not None:
        scope.pending.append(lambda: {f"{scope.name}/{k}": v
                                      for k, v in resolve().items()})


class Sections:
    """The sections of a layout epoch, timed from a stamp at each border
    (:func:`_stamp`). :meth:`start` opens the next section where the
    call runs; :meth:`through` passes tensors through an identity whose
    forward opens one section and whose backward opens another;
    :meth:`stop` ends the epoch's last. Each started-to-stopped pass is
    one epoch; a captured pass (``captured``, set by the runner that
    captures it: its events are nodes of the CUDA graph) counts
    ``replays`` times, on the last replay's times."""

    def __init__(self, device: torch.device, captured: bool = False):
        self.device, self.captured = device, captured
        self.passes: list[list] = []
        self.open = False
        self.replays = 0

    def start(self, name: str | None) -> None:
        if not self.open:
            self.passes.append([])
            self.open = True
        self.passes[-1].append((name, _stamp(self.device, self.captured)))

    def stop(self) -> None:
        self.start(None)
        self.open = False

    def through(self, tensors, fwd: str, bwd: str) -> tuple:
        return _Border.apply(self, fwd, bwd, *tensors)

    def seconds(self) -> dict[str, float]:
        out: dict[str, float] = {}
        times = self.replays if self.captured else 1
        for stamps in self.passes:
            for (name, a), (_, b) in zip(stamps, stamps[1:]):
                out[name] = out.get(name, 0.0) + times * _elapsed(a, b)
        return out


def traced_sections(device: torch.device) -> Sections | None:
    """A :class:`Sections` only while a ``torch.profiler`` is active and a
    phase is open (else None: nothing is marked); the caller hands its
    ``seconds`` to :func:`defer`."""
    if _ACTIVE.get() is None or not torch.autograd._profiler_enabled():
        return None
    return Sections(device)


class _Border(torch.autograd.Function):
    """Identity on its tensors (views: no kernel) that opens a section
    in the forward and another in the backward."""

    @staticmethod
    def forward(ctx, sections, fwd, bwd, *xs):
        ctx.sections, ctx.bwd = sections, bwd
        ctx.set_materialize_grads(False)
        sections.start(fwd)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.sections.start(ctx.bwd)
        return (None, None, None, *grads)
