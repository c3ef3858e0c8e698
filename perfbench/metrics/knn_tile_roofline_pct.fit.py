"""The kNN tile kernel's share of its roofline in the traced fit
(``csrc/knn_tile.cu``): the distance panels' operations, 2 N^2 D per
modality (:func:`panel_flops`), at the dense bf16 peak of 989 TFLOP/s, over
the device time of the kernels named ``knn_tile*`` and the norm pre-pass
``*rownorm*``. Operations bound these panels (about 2,000 operations a
byte at D = 4,096)."""

UNIT = "%"
PEAK_FLOPS = 989e12


def panel_flops(n, dims) -> float:
    return sum(2.0 * n * n * d for d in dims)


def _is_knn(name: str) -> bool:
    return "knn_tile" in name or "rownorm" in name


def read(view):
    tr = view.trace
    if tr is None or tr.fit_window is None:
        return None
    ns = tr.kernel_ns(_is_knn, *tr.fit_window)
    if ns <= 0:
        return None
    c = view.cell.config
    return 100.0 * panel_flops(c["n_pairs"], c["dims"]) / PEAK_FLOPS / (
        ns / 1e9)
