"""Cross-modal UMAP mixture experiments -- CLI of the PyTorch port.

The counterpart of ``main.py`` for ``multimodal_umap_tpu_torch``: the same
flags, defaults, prints, ``--log_dir`` loss logs and ``metrics.json``,
and the same 16 recon-app pairs. Differences:

  --device          torch device, default ``cuda`` (``cpu`` for CPU runs);
  --mesh_devices    the data-parallel mesh is one process per rank: run
                    the script under ``torchrun`` (or any launcher that
                    sets ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
                    ``MASTER_ADDR`` and ``MASTER_PORT``); 0 means the
                    world size, 1 no mesh, and a value other than the
                    world size is refused. Ranks run NCCL on
                    ``cuda:LOCAL_RANK`` or gloo with ``--device cpu``;
                    only rank 0 prints and writes;

and there is no compile cache and no eval prewarm (PyTorch compiles
nothing at run time). ``main(argv)`` runs in process and returns the
fitted (or loaded) model; under a mesh it uses a process group that is
already initialised, or initialises one from the environment.

    python main_torch.py --synthetic --n_samples 2000
    python main_torch.py --synthetic --device cpu --n_samples 128 ...
    torchrun --nproc_per_node 4 main_torch.py --mesh_devices 4 --synthetic
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from multimodal_umap_tpu_torch import Config, MultimodalUMAP
from multimodal_umap_tpu_torch.app import crossmodal_recon
from multimodal_umap_tpu_torch.data import clustered_modalities, load_data
from multimodal_umap_tpu_torch.eval.validation import (
    knn_test,
    similarity_test,
    train,
)
from multimodal_umap_tpu_torch.ops.knn import resolve_engine
from multimodal_umap_tpu_torch.parallel import create_mesh
from multimodal_umap_tpu_torch.utils.device import resolve_device
from multimodal_umap_tpu_torch.utils.logging import write_loss_log


def init_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Cross-modal UMAP Mixture Model Experiments (PyTorch)")
    parser.add_argument("--k_neighbors", type=int, default=15,
                        help="Number of neighbors for UMAP")
    parser.add_argument("--out_dim", type=int, default=64,
                        help="Output embedding dimension")
    parser.add_argument("--min_dist", type=float, default=0.1,
                        help="Minimum distance for UMAP")

    parser.add_argument("--train_epochs", type=int, default=600,
                        help="Number of training epochs")
    parser.add_argument("--num_rep", type=int, default=8,
                        help="Number of repulsive points for UMAP")
    parser.add_argument("--lr", type=float, default=0.01,
                        help="Learning rate")
    parser.add_argument("--alpha", type=float, default=1.0,
                        help="Cross-modal alignment weight")
    parser.add_argument("--batch_size", type=int, default=256,
                        help="Batch size")
    parser.add_argument("--log_dir", type=str, default=None,
                        help="Directory to log training losses")

    parser.add_argument("--test_epochs", type=int, default=120,
                        help="Number of testing epochs")
    parser.add_argument("--k_test", type=int, default=1,
                        help="Number of neighbors for k-NN test")
    parser.add_argument("--crossmodal", type=str, default="yes",
                        choices=["yes", "no"],
                        help="Whether to save cross-modal reconstructions")

    parser.add_argument("--load_pretrained", type=str, default="no",
                        choices=["yes", "no"],
                        help="Whether to load a pretrained model")
    parser.add_argument("--save_path", type=str,
                        default="models/flickr30k.npz",
                        help="Path to save the trained model")

    parser.add_argument("--synthetic", action="store_true",
                        help="Use synthetic clustered data (offline)")
    parser.add_argument("--n_samples", type=int, default=2000,
                        help="Synthetic dataset size")
    parser.add_argument("--mesh_devices", type=int, default=0,
                        help="Data-parallel mesh size: the launcher's world "
                             "size (0 = the world size, 1 = no mesh)")
    parser.add_argument("--seed", type=int, default=0, help="PRNG seed")
    parser.add_argument("--spectral", type=str, default="auto",
                        choices=["auto", "dense", "lobpcg", "chebyshev"],
                        help="Spectral initializer (ops/spectral.py)")
    parser.add_argument("--knn_engine", type=str, default="auto",
                        choices=["auto", "bf16", "xla", "pallas",
                                 "approx", "stream"],
                        help="kNN engine (ops/knn.py; auto = device "
                             "default: bf16 on CUDA, xla on the CPU)")
    parser.add_argument("--feature_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="Feature-table storage dtype (bfloat16 "
                             "halves device memory; exact re-scored "
                             "distances)")
    parser.add_argument("--progress_path", type=str, default=None,
                        help="Preemption-recovery snapshot file (npz); "
                             "combine with --resume to continue a run")
    parser.add_argument("--resume", action="store_true",
                        help="Resume fit from --progress_path")
    parser.add_argument("--graph_cache", type=str, default=None,
                        help="Graph-stage snapshot: a retried fit skips "
                             "the kNN sweep + spectral init")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (cuda by default; cpu runs "
                             "the kernels' plain versions)")
    return parser


def _world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _mesh(size: int, device: str):
    """The mesh of ``size`` ranks (None for 1): the initialised process
    group, or one initialised from the launcher's environment (NCCL on
    ``cuda:LOCAL_RANK``, gloo on the CPU)."""
    if size == 1:
        return None, resolve_device(device)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return create_mesh(size, dev), dev


def main(argv: list[str] | None = None) -> MultimodalUMAP:
    parser = init_parser()
    args = parser.parse_args(argv)
    world = _world_size()
    if args.mesh_devices not in (0, world):
        parser.error(f"--mesh_devices {args.mesh_devices}: the mesh is one "
                     f"process per rank and the world size is {world} "
                     "(launch that many processes, e.g. torchrun "
                     f"--nproc_per_node {args.mesh_devices})")
    mesh, device = _mesh(args.mesh_devices or world, args.device)
    main_rank = mesh is None or mesh.rank == 0
    cfg = Config(
        k_neighbors=args.k_neighbors,
        out_dim=args.out_dim,
        min_dist=args.min_dist,
        train_epochs=args.train_epochs,
        num_rep=args.num_rep,
        lr=args.lr,
        alpha=args.alpha,
        batch_size=args.batch_size,
        test_epochs=args.test_epochs,
        log_dir=args.log_dir,
        seed=args.seed,
        spectral_method=args.spectral,
        knn_engine=None if args.knn_engine == "auto" else args.knn_engine,
        feature_dtype=args.feature_dtype,
        progress_path=args.progress_path,
        resume=args.resume,
        graph_cache_path=args.graph_cache,
    )

    if args.synthetic:
        n_test = max(16, args.n_samples // 10)
        train_split = clustered_modalities(
            args.n_samples, dims=(768, 4096), seed=args.seed,
            centers_seed=args.seed)
        # Same cluster geometry, fresh samples: the test split must lie
        # on the train manifold for out-of-sample eval to be meaningful.
        test_split = clustered_modalities(
            n_test, dims=(768, 4096), seed=args.seed + 1,
            centers_seed=args.seed)
    else:
        train_split = load_data(split="train", mesh=mesh)
        test_split = load_data(split="test", mesh=mesh)

    log_dir = cfg.log_dir if main_rank else None
    if args.load_pretrained == "yes":
        model = MultimodalUMAP.load_state_dict(args.save_path, device=device)
    else:
        model = train(train_split, cfg, device=device, verbose=main_rank,
                      mesh=mesh)
        write_loss_log(log_dir, "fit", model.loss_history["fit"])

    # The CLI's own steps are timed beside the model's phases.
    timer = model.timer
    # A model on the mesh saves collectively (rank 0 writes); a loaded
    # one is every rank's own.
    on_mesh = model.mesh is not None
    if args.save_path is not None and (main_rank or on_mesh):
        with timer.phase("cli/save"):
            model.save_state_dict(args.save_path)

    with timer.phase("cli/similarity_test"):
        sim = similarity_test(test_split, cfg, model=model,
                              return_values=True, quiet=not main_rank)
    write_loss_log(log_dir, "transform",
                   model.loss_history.get("transform", []))
    with timer.phase("cli/knn_test"):
        acc = knn_test(test_split, cfg, k=args.k_test, model=model,
                       return_values=True, quiet=not main_rank)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "metrics.json"), "w") as f:
            json.dump({"cosine_similarity": sim,
                       f"knn_accuracy@{args.k_test}": acc,
                       "knn_engine": resolve_engine(cfg.knn_engine, device),
                       "spectral_method": cfg.spectral_method,
                       "mesh_devices": 1 if mesh is None else mesh.size},
                      f, indent=2)

    if args.crossmodal == "yes" and (main_rank or on_mesh):
        rng = np.random.default_rng(args.seed)
        keys = list(test_split)
        indices = rng.permutation(test_split[keys[0]].shape[0])[:16]
        samples = [np.asarray(test_split[k])[indices] for k in keys]
        with timer.phase("cli/crossmodal_recon"):
            crossmodal_recon(samples, cfg, model=model)
        write_loss_log(log_dir, "invert",
                       model.loss_history.get("invert", []))
    return model


if __name__ == "__main__":
    main()
