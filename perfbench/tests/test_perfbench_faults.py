"""The comparison fails a run whose timed path is broken, and its control.

A CPU-sized cell (``tests/cells``) runs the harness past its look for a
chip: the program's fit on the CPU, the window, the reference. A sound run
is correct; each fault the cell can have makes ``correct`` false: every
layout step returning the state unchanged, half of the rows left out of the
loss, a neighbour id altered and an embedding row altered where they are
produced, the spectral initialisation all zeros or cut short. The control (the reference in bfloat16 in the program's place)
fails too. One chip holds the cell, so no exchange between chips exists to
leave out.
"""

import json
from pathlib import Path

import pytest
import torch

from perfbench import harness, readings

CELLS = Path(__file__).parent / "cells"
CPU = torch.device("cpu")


def _run(capsys, seed=3):
    cell = harness.load_cell("tiny.fit", seed, CPU, CELLS)
    assert harness.run(cell, 0.0, False, 0.0) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return json.loads(out)


def test_sound_run_is_correct(capsys):
    res = _run(capsys)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault, number", [("unchanged", "pair_cos_gap"),
                                           ("half", "pair_cos_gap")])
def test_broken_layout_is_not_correct(capsys, fault, number):
    with readings.planted(fault):
        res = _run(capsys)
    assert not res["correct"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


@pytest.mark.parametrize("fault, number", [
    ("spectral_zero", "spectral_orth_err"),
    ("spectral_short", "spectral_rayleigh_gap")])
def test_broken_spectral_init_is_not_correct(capsys, fault, number):
    with readings.planted(fault):
        res = _run(capsys)
    assert not res["correct"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


@pytest.mark.parametrize("what, number", [("id", "knn_dist_gap"),
                                          ("row", "pair_cos_worst")])
def test_altered_answer_is_not_correct(monkeypatch, capsys, what, number):
    from perfbench.drivers import fit_loop

    host_outputs = fit_loop._host_outputs

    def altered(model, inits):
        out = host_outputs(model, inits)
        if what == "id":
            cols = out[0]["cols"].clone()
            cols[0] = (int(cols[0]) + cols.shape[0] // 4) % out[0]["num_rows"]
            out[0]["cols"] = cols
        else:
            e = out[1]["embed"].clone()
            e[5] = -e[5]
            out[1]["embed"] = e
        return out

    monkeypatch.setattr(fit_loop, "_host_outputs", altered)
    res = _run(capsys)
    assert not res["correct"]
    assert res["checks"][number]["value"] > res["checks"][number]["limit"]


def test_control_in_bfloat16_is_not_correct():
    from perfbench import data as D
    from perfbench.judge import judge, reference_modality, verdict

    cell = harness.load_cell("tiny.fit", 4, CPU, CELLS)
    cfg = cell.config
    tables, _ = D.clustered_tables(cfg["n_pairs"], cfg["dims"],
                                   cfg["n_clusters"], cfg["cluster_scale"],
                                   cfg["noise_scale"], 4, CPU, torch.float32)
    k = cfg["program"]["k_neighbors"]
    refs = [reference_modality(t, k) for t in tables]
    ctrl = readings.control_outputs(tables, k, cfg["program"]["out_dim"])
    numbers, _ = judge([ctrl], refs, cfg["program"] | {
        "infonce": cfg["infonce"]}, 4)
    ok, checks = verdict(numbers, cfg["limits"])
    assert not ok
    assert numbers["knn_dist_gap"] > cfg["limits"]["knn_dist_gap"]
    assert numbers["rho_rel_err"] > cfg["limits"]["rho_rel_err"]
