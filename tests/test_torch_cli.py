"""PyTorch port: the CLI (``main_torch.py``) end to end on the CPU, in
process -- tests/test_cli.py's runs of ``main.py`` (synthetic end to end,
``--load_pretrained yes`` round trip, the resilience flags, here with
``--feature_dtype bfloat16``), ``main_torch.py`` against ``main.py`` on
the same arguments and on a checkpoint the JAX package fitted and wrote,
the flag surface against ``main.py``'s, and the refusals
(``--mesh_devices`` other than the world size, real data without a
cache).

Metrics against ``main.py``'s are held to the end-to-end tests' bands
(tests/test_torch_e2e.py): cosine >= JAX's - 0.03, kNN accuracy >= 0.9 x
JAX's; each side re-embeds with its own random draws, so the values are
statistical. Data splits and the recon app's 16 pairs are equal exactly.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import main_torch  # noqa: E402

from multimodal_umap_tpu.data.synthetic import (  # noqa: E402
    clustered_modalities as j_clustered,
)
from multimodal_umap_tpu.models.mixture import (  # noqa: E402
    MultimodalUMAP as JModel,
)

torch.set_num_threads(1)

SMALL = ["--synthetic", "--device", "cpu", "--k_neighbors", "5",
         "--out_dim", "4", "--train_epochs", "10", "--test_epochs", "5",
         "--num_rep", "2", "--batch_size", "64"]


def _run_main_py(args, cwd):
    """``main.py`` (the JAX package) on the CPU in a subprocess, as
    tests/test_cli.py runs it."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, str(ROOT / "main.py"), *args],
                         capture_output=True, text=True, timeout=540,
                         cwd=cwd, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _metrics(log_dir):
    with open(os.path.join(log_dir, "metrics.json")) as f:
        return json.load(f)


def _assert_metrics_in_band(ours, theirs, k_test):
    knn = f"knn_accuracy@{k_test}"
    assert ours["cosine_similarity"] >= theirs["cosine_similarity"] - 0.03
    assert ours[knn] >= 0.9 * theirs[knn], (ours, theirs)
    for key in ("knn_engine", "spectral_method", "mesh_devices"):
        assert ours[key] == theirs[key]


def test_cli_synthetic_end_to_end(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    save_path = str(tmp_path / "models" / "run.npz")
    log_dir = str(tmp_path / "logs")
    model = main_torch.main([
        "--synthetic", "--device", "cpu", "--n_samples", "128",
        "--k_neighbors", "6", "--out_dim", "4", "--train_epochs", "30",
        "--test_epochs", "10", "--num_rep", "2", "--batch_size", "64",
        "--save_path", save_path, "--log_dir", log_dir])
    out = capsys.readouterr().out
    assert "Average cross-modal cosine similarity:" in out
    assert "Average 1-NN accuracy:" in out
    assert "Reconstruction loss from text to image:" in out
    assert os.path.exists(save_path)
    logs = os.listdir(log_dir)
    for phase in ("fit", "transform", "invert"):
        assert any(f.startswith(phase) and f.endswith(".jsonl") for f in logs)
    with open(os.path.join(log_dir, sorted(logs)[0])) as f:
        assert set(json.loads(f.readline())) == {"epoch", "loss"}
    with open(os.path.join(log_dir, "metrics.json")) as f:
        metrics = json.load(f)
    assert set(metrics) == {"cosine_similarity", "knn_accuracy@1",
                            "knn_engine", "spectral_method", "mesh_devices"}
    assert (metrics["knn_engine"], metrics["mesh_devices"]) == ("xla", 1)
    assert np.isfinite(metrics["cosine_similarity"])
    # The recon app without VAE weights: the offline latent dump.
    assert os.path.exists(tmp_path / "results" / "recon_latents.npz")
    assert {"fit/layout", "cli/save", "cli/similarity_test",
            "cli/knn_test", "cli/crossmodal_recon"} <= set(model.timer.report())


def test_cli_load_pretrained_roundtrip(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    base = SMALL + ["--n_samples", "96", "--crossmodal", "no",
                    "--save_path", str(tmp_path / "models" / "run.npz")]
    first = main_torch.main(base)
    capsys.readouterr()
    second = main_torch.main(base + ["--load_pretrained", "yes"])
    assert "Average cross-modal cosine similarity:" in capsys.readouterr().out
    assert "fit/layout" not in second.timer.report()
    for a, b in zip(first.embeds, second.embeds):
        assert torch.equal(a, b)


def test_cli_resilience_flags(tmp_path, monkeypatch, capsys):
    """--graph_cache / --progress_path / --feature_dtype bfloat16 reach
    fit: snapshots appear, the archive keeps the tables bf16, and a second
    identical run resumes from the cache and the snapshot."""
    monkeypatch.chdir(tmp_path)
    cache = str(tmp_path / "graphs.npz")
    prog = str(tmp_path / "prog.npz")
    save = str(tmp_path / "m.npz")
    base = SMALL + ["--n_samples", "96", "--crossmodal", "no",
                    "--save_path", save, "--graph_cache", cache,
                    "--progress_path", prog, "--feature_dtype", "bfloat16",
                    "--knn_engine", "approx", "--mesh_devices", "1"]
    first = main_torch.main(base)
    assert os.path.exists(cache) and os.path.exists(prog)
    assert all(d.dtype == torch.bfloat16 for d in first.data)
    with np.load(save) as z:
        meta = json.loads(str(z["meta"]))
    assert meta["bf16_keys"] == ["data_0", "data_1"]
    assert meta["knn_engine"] == "approx"
    capsys.readouterr()
    second = main_torch.main(base + ["--resume"])
    assert "Average cross-modal cosine similarity:" in capsys.readouterr().out
    assert "fit/graph_0" not in second.timer.report()
    assert len(second.loss_history["fit"]) == 0  # resumed at the last epoch


def test_cli_matches_main_py(tmp_path, monkeypatch, capsys):
    """``main_torch.py --device cpu`` and ``main.py`` on the same small
    synthetic arguments: equal train tables in the archives, equal recon
    app pairs (the offline dumps' originals), metrics in band."""
    args = ["--synthetic", "--n_samples", "400", "--k_neighbors", "6",
            "--out_dim", "4", "--train_epochs", "30", "--test_epochs", "10",
            "--num_rep", "2", "--batch_size", "64", "--k_test", "5",
            "--mesh_devices", "1", "--save_path", "m.npz",
            "--log_dir", "logs"]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    _run_main_py(args, jax_dir)
    monkeypatch.chdir(port_dir)
    main_torch.main(args + ["--device", "cpu"])
    capsys.readouterr()
    _assert_metrics_in_band(_metrics(port_dir / "logs"),
                            _metrics(jax_dir / "logs"), 5)
    with np.load(port_dir / "m.npz") as ours, np.load(jax_dir / "m.npz") as theirs:
        for key in ("data_0", "data_1"):
            np.testing.assert_array_equal(ours[key], theirs[key])
    dump = "results/recon_latents.npz"
    with np.load(port_dir / dump) as ours, np.load(jax_dir / dump) as theirs:
        assert ours["original"].shape == (16, 4, 32, 32)
        np.testing.assert_array_equal(ours["original"], theirs["original"])


def test_cli_loads_a_jax_checkpoint(tmp_path, monkeypatch, capsys):
    """A model the JAX package fitted (bf16 tables, 768/4096 dims as the
    CLI's synthetic data) and saved is evaluated by ``main_torch.py`` and
    by ``main.py``: metrics in band."""
    monkeypatch.chdir(tmp_path)
    data = j_clustered(96, dims=(768, 4096), seed=0, centers_seed=0)
    jmodel = JModel(5, 4, 0.1, num_encoders=2, seed=0,
                    feature_dtype="bfloat16")
    jmodel.fit([data["texts"], data["images"]], epochs=30, num_rep=2,
               lr=0.05, batch_size=64)
    path = str(tmp_path / "jax.npz")
    jmodel.save_state_dict(path)
    evaluate = ["--n_samples", "96", "--crossmodal", "no",
                "--load_pretrained", "yes", "--save_path", path,
                "--k_test", "5", "--mesh_devices", "1"]
    model = main_torch.main(SMALL + evaluate + ["--log_dir", "port_logs"])
    out = capsys.readouterr().out
    assert "Average cross-modal cosine similarity:" in out
    _run_main_py(SMALL[:1] + SMALL[3:] + evaluate + ["--log_dir", "jax_logs"],
                 tmp_path)
    _assert_metrics_in_band(_metrics("port_logs"), _metrics("jax_logs"), 5)
    assert model.feature_dtype == "bfloat16"
    for i in range(2):
        np.testing.assert_array_equal(model.embeds[i].numpy(),
                                      np.asarray(jmodel.embeds[i]))
        np.testing.assert_array_equal(
            model.data[i].float().numpy(),
            np.asarray(jmodel.data[i], dtype=np.float32))


def test_cli_flags_match_main_py(monkeypatch):
    """Every flag of main.py, with its default; ``--device`` is the only
    addition."""
    import main

    monkeypatch.setattr(sys, "argv", ["main.py"])
    theirs = vars(main.init_parser())
    ours = vars(main_torch.init_parser().parse_args([]))
    assert ours.pop("device") == "cuda"
    assert ours == theirs


def test_cli_refusals(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit):
        main_torch.main(SMALL + ["--mesh_devices", "4"])
    assert "world size is 1" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="synthetic"):
        main_torch.main(["--device", "cpu"])  # no cached flickr30k features
