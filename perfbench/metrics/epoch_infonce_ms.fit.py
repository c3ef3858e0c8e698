"""Milliseconds a layout epoch spends in InfoNCE: the traced fit's
sections ``fit/layout/epochs/infonce_fwd`` (from the input marker to the
terms' output) and ``infonce_bwd`` (from that output, the loss's last adds
and the backward's seed included, to the input marker's backward): each
section's seconds over all epochs (``models/layout.py``'s
``EPOCH_SECTIONS``, timed from border events that the captured epoch
holds while a profiler runs), over the fit's epochs."""

UNIT = "ms"
SECTIONS = ("infonce_fwd", "infonce_bwd")


def read(view):
    traced = [f for f in view.fits if f.traced]
    names = [f"fit/layout/epochs/{s}" for s in SECTIONS]
    if not traced or not all(n in traced[0].phases for n in names):
        return None
    epochs = view.cell.config["program"]["train_epochs"]
    return 1e3 * sum(traced[0].phases[n] for n in names) / epochs
