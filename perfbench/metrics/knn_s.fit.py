"""Seconds of a fit's kNN searches: the program's spans
``fit/graph_<i>/knn`` (``ops/knn.py``'s ``knn``: the norm pre-pass, the
tile kernels, the merge and the exact re-score), summed over modalities,
median over the window's untraced fits."""

import re

UNIT = "s"
_SPAN = re.compile(r"fit/graph_\d+/knn$")


def read(view):
    return view.median(lambda f: sum(
        v for k, v in f.phases.items() if _SPAN.match(k)) or None)
