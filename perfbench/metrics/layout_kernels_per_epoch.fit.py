"""Kernel executions of the traced fit's layout stage a layout epoch: the
kernels whose launch (by the profiler's correlation) lies inside the
program's ``fit/layout`` range, over the fit's epochs. A count: it includes
the capture's warm-up epochs and the one-off set-up of the stage."""

import numpy as np

UNIT = "kernels/epoch"


def read(view):
    tr = view.trace
    spans = None if tr is None else tr.ranges.get("fit/layout")
    if not spans:
        return None
    lo, hi = spans[0]
    when = np.where(tr.k_launch >= 0, tr.k_launch, tr.k_start)
    count = int(((when >= lo) & (when <= hi)).sum())
    if count == 0:
        return None
    return count / view.cell.config["program"]["train_epochs"]
