"""The InfoNCE kernels' share of their roofline in the traced fit
(``csrc/infonce.cu``): the bytes the modality pairs' kernels must move at
the least, counted from shapes by :func:`pair_bytes` for each of the
m (m - 1) / 2 pairs of the m = ``len(dims)`` modalities, at 3.35 TB/s
(H100 SXM HBM3), over the device time of the kernels named ``infonce_*``.
Bytes bound these kernels; most gathered rows come from L2, so the share
reads far under 100 %."""

UNIT = "%"
PEAK_BYTES = 3.35e12


def pair_bytes(num, d, n_neg) -> float:
    """One pair's bytes an epoch. Forward: both (num, d) f32 tables, each
    direction's int64 id vector and roll vector (n_neg + 2 int64) read
    once, the loss written; backward: the tables, id and roll vectors read
    once more and both gradients written. 0.0149 ms at 3.35 TB/s at 31,783
    rows and 0.0554 ms (about 186 MB) at 118,287, d 64 and n_neg 8."""
    table, ids, rolls = 4.0 * num * d, 8.0 * num, 8.0 * (n_neg + 2)
    fwd = 2 * table + 2 * ids + 2 * rolls + 8.0
    bwd = 4 * table + 2 * ids + 2 * rolls
    return fwd + bwd


def epoch_bytes(num, d, n_neg, modalities) -> float:
    """Every pair's bytes an epoch."""
    return modalities * (modalities - 1) / 2 * pair_bytes(num, d, n_neg)


def _is_infonce(name: str) -> bool:
    return "infonce_" in name


def read(view):
    tr = view.trace
    if tr is None or tr.fit_window is None:
        return None
    ns = tr.kernel_ns(_is_infonce, *tr.fit_window)
    if ns <= 0:
        return None
    c = view.cell.config
    p = c["program"]
    total = p["train_epochs"] * epoch_bytes(
        c["n_pairs"], p["out_dim"], c["infonce"]["n_neg"], len(c["dims"]))
    return 100.0 * total / PEAK_BYTES / (ns / 1e9)
