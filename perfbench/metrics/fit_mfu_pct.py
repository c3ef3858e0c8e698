"""The whole fit's share of the card's dense bf16 peak (989 TFLOP/s, H100
SXM at 700 W; the card's power limit is printed beside the result): the
operations the fit needs, counted from the configuration's shapes by
:func:`fit_flops`, over the fit's wall time (median over the window's
untraced fits)."""

UNIT = "%"
PEAK_FLOPS = 989e12


def fit_flops(n, dims, k, out_dim, num_rep, n_neg, epochs) -> float:
    """kNN panels 2 N^2 D per modality; per layout epoch each modality's
    N k attraction and N num_rep repulsion pairs at 3 out_dim operations
    (difference, square, sum) and, per direction of each modality pair, N
    (n_neg + 2) InfoNCE similarities at 2 out_dim; the layout x3 with its
    backward, x epochs."""
    m = len(dims)
    knn = sum(2.0 * n * n * d for d in dims)
    pair_ops = 3.0 * out_dim
    attr = m * n * k * pair_ops
    rep = m * n * num_rep * pair_ops
    infonce = (m * (m - 1) // 2) * 2 * n * (n_neg + 2) * 2.0 * out_dim
    return knn + epochs * 3.0 * (attr + rep + infonce)


def read(view):
    wall = view.median(lambda f: f.seconds)
    if not wall:
        return None
    c = view.cell.config
    p = c["program"]
    ops = fit_flops(c["n_pairs"], c["dims"], p["k_neighbors"], p["out_dim"],
                    p["num_rep"], c["infonce"]["n_neg"], p["train_epochs"])
    return 100.0 * ops / wall / PEAK_FLOPS
