"""Seconds of a fit's fuzzy graph: the program's spans
``fit/graph_<i>/sigma`` (the bandwidth solve and the memberships) and
``fit/graph_<i>/union`` (the reverse-edge lookup and the symmetrized
views), summed over modalities, median over the window's untraced
fits."""

import re

UNIT = "s"
_SPAN = re.compile(r"fit/graph_\d+/(sigma|union)$")


def read(view):
    return view.median(lambda f: sum(
        v for k, v in f.phases.items() if _SPAN.match(k)) or None)
