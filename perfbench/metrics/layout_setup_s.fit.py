"""Seconds of a fit layout's set-up: the program's spans
``fit/layout/prepare`` (Adam's state, the reverse index with its host
syncs, the epoch's buffers), ``fit/layout/warmup`` (the eager epochs
before the capture, undone) and ``fit/layout/capture`` (the epoch's
CUDA-graph capture), median over the window's untraced fits."""

UNIT = "s"
SPANS = ("fit/layout/prepare", "fit/layout/warmup", "fit/layout/capture")


def read(view):
    return view.median(lambda f: sum(
        f.phases.get(k, 0.0) for k in SPANS) or None)
