"""Seconds of a fit's spectral initialisation: the program's spans
``fit/graph_<i>/spectral``, summed over modalities, median over the
window's untraced fits."""

import re

UNIT = "s"
_SPAN = re.compile(r"fit/graph_\d+/spectral$")


def read(view):
    return view.median(lambda f: sum(
        v for k, v in f.phases.items() if _SPAN.match(k)) or None)
