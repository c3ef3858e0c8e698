"""Milliseconds a layout epoch spends in the modality terms: the traced
fit's sections ``fit/layout/epochs/modality_fwd`` (the coefficients and
window bookkeeping, K2 / K3's forward) and ``modality_bwd`` (the rest of
the backward, K2 / K3's backward kernels included): each section's
seconds over all epochs (``models/layout.py``'s ``EPOCH_SECTIONS``, timed
from border events that the captured epoch holds while a profiler runs),
over the fit's epochs."""

UNIT = "ms"
SECTIONS = ("modality_fwd", "modality_bwd")


def read(view):
    traced = [f for f in view.fits if f.traced]
    names = [f"fit/layout/epochs/{s}" for s in SECTIONS]
    if not traced or not all(n in traced[0].phases for n in names):
        return None
    epochs = view.cell.config["program"]["train_epochs"]
    return 1e3 * sum(traced[0].phases[n] for n in names) / epochs
