"""Seconds the device idles during the traced fit layout's set-up: each
host window of the program's ranges ``fit/layout/prepare``, ``warmup``
and ``capture`` less the union of device operations inside it
(``TraceSummary.busy_ns``), summed: the device waiting on the host's
preparation and capture, on the profiler's one clock."""

UNIT = "s"
SPANS = ("fit/layout/prepare", "fit/layout/warmup", "fit/layout/capture")


def read(view):
    tr = view.trace
    if tr is None:
        return None
    windows = [w for name in SPANS for w in tr.ranges.get(name, ())]
    if not windows:
        return None
    return sum((hi - lo) - tr.busy_ns(lo, hi) for lo, hi in windows) / 1e9
