"""The device's idle share of the traced fit: 100 minus the union of the
device operations' intervals (kernels, copies, sets) over the fit's wall
window, in percent. The union, not the sum: overlapping operations count
once."""

UNIT = "%"


def read(view):
    tr = view.trace
    if tr is None or tr.fit_window is None:
        return None
    lo, hi = tr.fit_window
    if hi <= lo or tr.d_start.size == 0:
        return None
    return 100.0 * (1.0 - tr.busy_ns(lo, hi) / (hi - lo))
