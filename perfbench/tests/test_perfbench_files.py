"""Every file the harness finds by name loads, follows the benchmark's
naming rules and agrees with BENCHMARK.json; a new cell or metric is only
new files."""

import json
import re
import shutil

import pytest
import torch

from perfbench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _names(kind):
    return sorted(p.name[:-len(".json")] for p in (ROOT / kind).glob("*.json"))


@pytest.mark.parametrize("cell", _names("workloads"))
def test_workload_file_loads_and_matches_benchmark(cell):
    c = harness.load_cell(cell, 7, torch.device("cpu"))
    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    assert NAME.match(cell)
    assert {k: entry[k] for k in ("config", "traffic", "chips", "why")} == {
        "config": c.workload["config"], "traffic": c.workload["traffic"],
        "chips": c.workload["chips"], "why": c.workload["why"]}
    assert c.workload["chips"] in (1, 4)
    assert 1 <= len(c.workload["why"]) <= 200
    assert harness.load_driver(c.traffic["driver"]).window


@pytest.mark.parametrize("config", _names("configs"))
def test_config_file_loads_and_matches_benchmark(config):
    cfg = harness.load_json(ROOT / "configs" / f"{config}.json")
    entry = {c["name"]: c for c in BENCH["configs"]}[config]
    assert NAME.match(config) and cfg["name"] == config
    assert entry["file"] == f"perfbench/configs/{config}.json"
    assert entry["source"] == cfg["source"] and len(cfg["source"]) <= 200
    assert entry["reduced"] == cfg["reduced"]
    assert all(NAME.match(k) for k in cfg["reduced"])
    assert set(cfg["limits"]) == {
        "knn_dist_gap", "rho_rel_err", "sigma_rel_err", "weight_abs_err",
        "spectral_null_resid", "spectral_orth_err", "spectral_rayleigh_gap",
        "loss_ratio", "pair_cos_gap", "pair_cos_worst"}


@pytest.mark.parametrize("metric", sorted(harness.load_metrics()))
def test_metric_file_loads_and_matches_benchmark(metric):
    mod = harness.load_metrics()[metric]
    entry = {m["name"]: m for m in BENCH["per_layer"]}[metric]
    assert NAME.match(metric) and UNIT.match(mod.UNIT)
    assert entry["unit"] == mod.UNIT
    assert entry["moves"] in {m["name"] for m in BENCH["end_to_end"]}


def test_benchmark_names_units_and_lines():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for c in BENCH["workloads"]:
        assert NAME.match(c["name"]) and NAME.match(c["traffic"])
        assert "\n" not in c["why"] and "\t" not in c["why"]
    assert {m["name"] for m in BENCH["per_layer"]} == set(
        harness.load_metrics())
    assert {w["name"] for w in BENCH["workloads"]} == set(
        _names("workloads"))
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert len((ROOT.parent / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_new_cell_and_metric_are_new_files_only(tmp_path):
    root = tmp_path / "perfbench"
    for kind in ("configs", "traffic"):
        shutil.copytree(ROOT / kind, root / kind)
    (root / "workloads").mkdir()
    (root / "workloads" / "flickr30k.extra.json").write_text(json.dumps({
        "config": "flickr30k", "traffic": "fit_back_to_back", "chips": 1,
        "why": "a throwaway cell"}))
    (root / "metrics").mkdir()
    (root / "metrics" / "extra_s.fit.py").write_text(
        "UNIT = 's'\n\ndef read(view):\n    return None\n")
    cell = harness.load_cell("flickr30k.extra", 3, torch.device("cpu"), root)
    assert cell.config["n_pairs"] == 31783
    assert harness.load_driver(cell.traffic["driver"]).setup
    assert list(harness.load_metrics(root)) == ["extra_s.fit"]
