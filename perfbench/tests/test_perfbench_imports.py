"""What the benchmark may load: no JAX and no JAX package, compared by
whole top-level names; the reference imports nothing of the program."""

import ast
import shutil
import sys
import types
from pathlib import Path

import torch

from perfbench import harness

ROOT = harness.ROOT
CELLS = Path(__file__).parent / "cells"


def test_top_level_check_catches_the_jax_package_not_the_port(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.BANNED:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "multimodal_umap_tpu_torch",
                        types.ModuleType("multimodal_umap_tpu_torch"))
    monkeypatch.setitem(sys.modules, "multimodal_umap_tpu_torch.ops",
                        types.ModuleType("multimodal_umap_tpu_torch.ops"))
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "multimodal_umap_tpu.ops",
                        types.ModuleType("multimodal_umap_tpu.ops"))
    assert harness.banned_modules() == ["multimodal_umap_tpu"]
    monkeypatch.setitem(sys.modules, "jaxlib",
                        types.ModuleType("jaxlib"))
    assert harness.banned_modules() == ["jaxlib", "multimodal_umap_tpu"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_and_the_reference_none_of_the_program():
    for path in ROOT.rglob("*.py"):
        assert not _imports(path) & set(harness.BANNED), path
    for path in (ROOT / "reference").rglob("*.py"):
        assert "multimodal_umap_tpu_torch" not in _imports(path), path
        assert "multimodal_umap_tpu_torch" not in path.read_text(), path


def test_a_reader_that_loads_the_jax_package_fails_the_run(
        tmp_path, monkeypatch, capsys):
    # the check runs after the per-layer readers and the reference: a
    # reader that imports the JAX package (here a stub of it) ends the run
    # with no result
    root = tmp_path / "cells"
    shutil.copytree(CELLS, root)
    (root / "metrics").mkdir()
    (root / "metrics" / "leaky_s.fit.py").write_text(
        "import multimodal_umap_tpu\n\nUNIT = 's'\n\n\n"
        "def read(view):\n    return None\n")
    stub = tmp_path / "stub" / "multimodal_umap_tpu"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    for name in list(sys.modules):
        if name.split(".")[0] in harness.BANNED:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.syspath_prepend(str(stub.parent))
    try:
        cell = harness.load_cell("tiny.fit", 3, torch.device("cpu"), root)
        assert harness.run(cell, 0.0, True, 0.0) == 3
    finally:
        sys.modules.pop("multimodal_umap_tpu", None)
    out = capsys.readouterr()
    assert '"correct"' not in out.out
    assert "multimodal_umap_tpu" in out.err.strip().splitlines()[-1]
