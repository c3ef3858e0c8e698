"""Seconds of a fit's layout stage (the program's ``PhaseTimer`` phase
``fit/layout``: the layout epochs, their capture and warm-up), median over
the window's untraced fits."""

UNIT = "s"


def read(view):
    return view.median(lambda f: f.phases.get("fit/layout"))
