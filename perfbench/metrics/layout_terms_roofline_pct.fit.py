"""The layout-term kernels' share of their roofline in the traced fit
(``csrc/layout_terms.cu``): the bytes their four passes need a fit, counted
from shapes by :func:`term_bytes` (each input read once, each output written
once), at 3.35 TB/s (H100 SXM HBM3), over the device time of the kernels
named ``fit_attr*`` and ``fit_rep*``. Bytes bound these passes."""

UNIT = "%"
PEAK_BYTES = 3.35e12


def term_bytes(n, k, d, num_rep) -> float:
    """One modality's bytes a layout epoch. Attraction forward: the table,
    the (N, k) int32 ids and f32 coefficients, one f32 partial a row;
    backward: the table, ids, coefficients, the int32 CSR of the transposed
    ids (offsets and ids), the loss gradient, the gradient table.
    Repulsion forward: the table, the int64 permutation, the offsets, the
    per-row coefficients, one partial a row; backward: the table, the
    permutation and its inverse, the offsets, the coefficients, the loss
    gradient, the gradient table."""
    table = 4.0 * n * d
    ids = coef = 4.0 * n * k
    attr_fwd = table + ids + coef + 4.0 * n
    attr_bwd = table + ids + coef + 4.0 * (n + 1) + ids + 4.0 + table
    rep_fwd = table + 8.0 * n + 8.0 * num_rep + 4.0 * n + 4.0 * n
    rep_bwd = table + 16.0 * n + 8.0 * num_rep + 4.0 * n + 4.0 + table
    return attr_fwd + attr_bwd + rep_fwd + rep_bwd


def _is_term(name: str) -> bool:
    return "fit_attr" in name or "fit_rep" in name


def read(view):
    tr = view.trace
    if tr is None or tr.fit_window is None:
        return None
    ns = tr.kernel_ns(_is_term, *tr.fit_window)
    if ns <= 0:
        return None
    c = view.cell.config
    p = c["program"]
    total = p["train_epochs"] * len(c["dims"]) * term_bytes(
        c["n_pairs"], p["k_neighbors"], p["out_dim"], p["num_rep"])
    return 100.0 * total / PEAK_BYTES / (ns / 1e9)
