"""Without a card the benchmark fails and prints no result; it never falls
back to the CPU."""

import os
import shutil
import subprocess
import sys

from perfbench import harness

CHECKOUT = harness.ROOT.parent


def _run(cwd, workload="flickr30k.fit"):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_fails_without_a_result():
    res = _run(CHECKOUT)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_unknown_cell_fails():
    res = _run(CHECKOUT, "no_such.cell")
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_benchmark_alone_fails(tmp_path):
    shutil.copytree(harness.ROOT, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    res = _run(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""
