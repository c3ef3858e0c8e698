"""Seconds of a fit's graph stage: kNN, fuzzy weights, symmetrization and
spectral init of every modality (the program's ``PhaseTimer`` phases
``fit/graph_<i>``, summed within a fit), median over the window's untraced
fits."""

import re

UNIT = "s"
_PHASE = re.compile(r"fit/graph_\d+$")


def read(view):
    return view.median(lambda f: sum(
        v for k, v in f.phases.items() if _PHASE.match(k)) or None)
