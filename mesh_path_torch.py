"""The PyTorch port's data-parallel mesh on one CUDA GPU.

    python3 mesh_path_torch.py

``chip_smoke.py``'s ``mesh_path`` phase, in two parts at the main path's
full width (31,744 training + 1,024 test pairs, D = 768 / 4,096, the
``Config`` defaults). One card cannot hold two NCCL ranks (NCCL refuses
a duplicate device), so:

(a) :func:`nccl_world1` -- in process, a NCCL process group of world
    size 1: ``knn_ring`` against ``knn`` on both training tables (fit
    graph, self excluded) and on the test images against the training
    images (ids tie-aware, distances rtol 1e-5); the destination-sharded
    Laplacian apply against the single-device one on one block (rel
    1e-6), its Chebyshev init's null-space columns in the exact null
    space (principal cosines > 0.99) at the single-device block energy
    (1 %); the sharded layout engine's functions called directly
    (``sharded_compatible`` is False at one rank, as in JAX) for 20 fit
    epochs against ``train_layout`` on the same draws (losses rtol 1e-5,
    embeddings rtol 2e-3 / atol 2e-4; at one rank they are bit-equal,
    ``bit_equal``); the recorded collectives of one
    fit epoch (one table all-gather and one reduce-scatter per modality,
    no table-sized all-reduce) and of a 4-epoch transform chunk (the
    reference table gathered once, nothing table-sized per epoch);
(b) :func:`gloo_two_ranks` -- two spawned ranks, both on ``cuda:0``, over
    gloo (collectives through host memory, ``Mesh.host_staging``): the
    library path ``train(..., mesh=)`` (600 epochs) -> ``similarity_test``
    -> ``knn_test`` (k=5) -> ``embed_and_recon`` of 16 test texts, with
    the tile kernel's launches counted and every launch signature of
    rank 0 held against its plain version (and timed) after the path.

Each part returns one JSON-able dict and its failures; ``chip_smoke.py``
prints the line and fails on any. Imports nothing of JAX.
"""

from __future__ import annotations

import datetime
import faulthandler
import json
import multiprocessing
import os
import sys
import time
import uuid

import numpy as np
import torch
import torch.distributed as dist

N_TRAIN, N_TEST, DIMS, K = 31_744, 1_024, (768, 4096), 15
N_RECON = 16
LAYOUT_EPOCHS = 20
RANKS = 2
TIMEOUT_S = 600
STACK_DUMP_LEAD_S = 30  # ranks dump their stacks this long before it


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _data(n_train: int = N_TRAIN, n_test: int = N_TEST):
    """The main path's data (chip_smoke.py: seed 0, centers_seed 1)."""
    from multimodal_umap_tpu_torch.data.synthetic import clustered_modalities

    data = clustered_modalities(n_train + n_test, dims=DIMS, seed=0,
                                centers_seed=1)
    return ({k: v[:n_train] for k, v in data.items()},
            {k: v[n_train:] for k, v in data.items()})


def _knn_match(d_a, i_a, d_b, i_b):
    """Distances within rtol 1e-5 position by position, ids tie-aware
    (chip_smoke.tie_aware_match on the Euclidean distances)."""
    import chip_smoke as CS

    return CS.tie_aware_match(d_a, i_a, d_b, i_b, 0.0, 1e-5)


def _table_ops(summary, table_bytes):
    """Counts of table-sized ops by kind."""
    out = {}
    for kind, _, b in summary["ops"]:
        if b >= table_bytes:
            out[kind] = out.get(kind, 0) + 1
    return out


def nccl_world1(train_np, test_np, dev, out_dir, backend: str = "nccl"
                ) -> tuple[dict, list]:
    """Part (a); returns (the JSON line, failures). ``backend`` "gloo"
    rehearses it on the CPU."""
    import chip_smoke as CS
    from multimodal_umap_tpu_torch import Config
    from multimodal_umap_tpu_torch.models import layout as PL
    from multimodal_umap_tpu_torch.models.curve import get_ab_coeffs
    from multimodal_umap_tpu_torch.models.encoder import ModalityEncoder
    from multimodal_umap_tpu_torch.models.layout import (
        fit_task,
        make_optimizer,
        query_task,
        sharded_compatible,
        train_layout,
    )
    from multimodal_umap_tpu_torch.ops import knn_tile as KT
    from multimodal_umap_tpu_torch.ops import spectral as S
    from multimodal_umap_tpu_torch.ops.knn import knn
    from multimodal_umap_tpu_torch.ops.knn_stream import knn_ring
    from multimodal_umap_tpu_torch.parallel import (
        collective_summary,
        create_mesh,
        recording,
    )

    fails = []
    store = os.path.abspath(os.path.join(out_dir,
                                         f"nccl_store_{uuid.uuid4().hex[:8]}"))
    dist.init_process_group(backend, init_method=f"file://{store}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(minutes=5))
    try:
        mesh = create_mesh(1, dev)
        cfg = Config()
        a, b = get_ab_coeffs(cfg.min_dist)
        tables = [torch.from_numpy(train_np[key]).to(dev) for key in train_np]
        n_train = tables[0].shape[0]
        line = {"part": "nccl_world1", "backend": mesh.backend,
                "world_size": mesh.size, "n_train": n_train,
                "n_test": len(test_np["texts"]), "dims": list(DIMS), "k": K}
        test_images = torch.from_numpy(test_np["images"]).to(dev)

        # ring kNN against the single-device kNN
        ring_launches = norm_launches = 0
        knn_lines = []
        for name, q, r, ex in (("fit D=768", tables[0], tables[0], True),
                               ("fit D=4096", tables[1], tables[1], True),
                               ("query D=4096", test_images, tables[1],
                                False)):
            _sync()
            CS.reset_counts(KT)
            t0 = time.perf_counter()
            d_r, i_r = knn_ring(q, r, K, mesh, exclude_self=ex)
            _sync()
            t_ring = time.perf_counter() - t0
            ring_launches += CS.tile_launches(KT)
            norm_launches += KT.ROW_NORM_LAUNCHES
            t0 = time.perf_counter()
            d_k, i_k = knn(q, r, K, exclude_self=ex)
            _sync()
            cmp = _knn_match(d_r, i_r, d_k, i_k)
            knn_lines.append({"case": name, "ring_seconds": t_ring,
                              "knn_seconds": time.perf_counter() - t0, **cmp})
            if not (cmp["values_ok"] and cmp["ids_ok"]):
                fails.append(f"knn_ring {name} disagrees with knn")
        line["knn_ring_vs_knn"] = knn_lines
        line["ring_tile_launches"] = ring_launches
        line["ring_norm_launches"] = norm_launches

        # graphs, single device; the dest-sharded filter against the
        # single-device one on the text graph
        graphs, denses, inits = [], [], []
        for x in tables:
            graph, dense, init = ModalityEncoder(K, cfg.out_dim).fit_graph(x)
            graphs.append(graph)
            denses.append(dense)
            inits.append(init)
        # The graph's 32 clusters are disconnected and its 33rd-65th
        # eigenvalues lie close together, so two runs' whole 64-column
        # blocks need not share a span (chip_smoke.py, engine_checks):
        # the apply is held against the single-device one on one block,
        # and the filter's null-space columns against the exact null
        # space, its block energy against the single-device filter's.
        dest = S.dest_shard_graph(graphs[0], mesh)
        gen = torch.Generator(device=dev).manual_seed(1)
        block = torch.randn(n_train, cfg.out_dim + 9, device=dev,
                            generator=gen)
        lap, mesh_lap = S._Laplacian(graphs[0]), S._MeshLaplacian(dest)
        want = lap(block)
        apply_err = float((mesh_lap(block) - want).abs().max()
                          / want.abs().max())
        t0 = time.perf_counter()
        mesh_init = S._spectral_chebyshev(dest, cfg.out_dim)
        _sync()
        t_mesh_init = time.perf_counter() - t0
        null = CS.exact_null_space(graphs[0])
        n_null = null.shape[1] - 1

        def energy(x):
            q, _ = torch.linalg.qr(x)
            return float((q * lap(q)).sum())

        line["spectral"] = {
            "seconds": t_mesh_init, "apply_rel_err": apply_err,
            "null_space_dim": null.shape[1],
            "null_cosine_min": {
                "mesh": float(CS.subspace_cosines(mesh_init[:, :n_null],
                                                  null).min()),
                "single": float(CS.subspace_cosines(inits[0][:, :n_null],
                                                    null).min())},
            "energy": {"mesh": energy(mesh_init),
                       "single": energy(inits[0])},
            "whole_block_cosine_min": float(
                CS.subspace_cosines(mesh_init, inits[0]).min())}
        sp = line["spectral"]
        if apply_err > 1e-6:
            fails.append(f"dest-sharded apply differs by {apply_err}")
        if min(sp["null_cosine_min"].values()) <= 0.99:
            fails.append("dest-sharded Chebyshev leaves the null space")
        if abs(sp["energy"]["mesh"] - sp["energy"]["single"]) > \
                0.01 * sp["energy"]["single"]:
            fails.append("dest-sharded Chebyshev energy not within 1 %")

        # the sharded engine against train_layout on the same draws
        tasks, statics = zip(*(fit_task(d, cfg.batch_size) for d in denses))
        line["sharded_compatible_at_1"] = sharded_compatible(
            inits, tasks, statics, mesh)
        if line["sharded_compatible_at_1"]:
            fails.append("sharded_compatible is True at one rank")
        kw = dict(num_rep=cfg.num_rep, alpha=cfg.alpha)

        def mesh_epochs(params, opt, tasks, statics, mode, seed, start,
                        take):
            """Epochs [start, start + take) of the mesh engine called
            directly (``train_layout`` takes it past one rank only): the
            loss made with the mesh, run eagerly on the (seed, epoch)
            draws."""
            alpha = cfg.alpha if mode == "fit" else 0.0
            loss_fn = PL.make_loss_fn(statics, mode=mode, num_rep=cfg.num_rep,
                                      alpha=alpha,
                                      batch_size=cfg.batch_size, mesh=mesh)
            inputs = PL._EpochInputs(tasks, statics, mode=mode,
                                     num_rep=cfg.num_rep, alpha=alpha,
                                     seed=seed, device=dev,
                                     first_epoch=start)
            with PL._eager_chunk_runner(params, opt, loss_fn, tasks, a, b,
                                        inputs, start, mesh=mesh) as run:
                return run(start, take)

        def single_run():
            return train_layout(inits, tasks, statics, mode="fit",
                                epochs=LAYOUT_EPOCHS, lr=cfg.lr, a=a, b=b,
                                seed=cfg.seed, batch_size=cfg.batch_size,
                                **kw)

        single, hist_s = single_run()
        # the single-device engine's own spread between two runs on the
        # card (0 unless a kernel of the epoch sums in atomic order: the
        # fit terms' kernels do not); the second is timed
        t0 = time.perf_counter()
        again, _ = single_run()
        _sync()
        t_single = time.perf_counter() - t0
        params = [e.detach().clone().requires_grad_(True) for e in inits]
        opt = make_optimizer(params, cfg.lr)  # train_layout's update
        # a direct caller of the runner builds the attraction kernel's
        # reverse index itself (train_layout does it for its own runs)
        sharded_tasks = PL.with_reverse_index(tasks, statics)
        CS.reset_counts(KT)  # the sharded engine's own term launches
        t0 = time.perf_counter()
        hist_m = mesh_epochs(params, opt, sharded_tasks, statics, "fit",
                             cfg.seed, 0, LAYOUT_EPOCHS)
        _sync()
        t_mesh = time.perf_counter() - t0
        line["layout_term_launches"] = CS.term_launches()
        line["infonce_launches"] = CS.infonce_launches()

        def excess(xs, ys, rtol, atol):
            return max(float(((x.detach() - y).abs() - rtol * y.abs()
                              - atol).max()) for x, y in zip(xs, ys))

        line["layout"] = {
            "epochs": LAYOUT_EPOCHS, "single_seconds": t_single,
            "sharded_seconds": t_mesh,
            "max_abs_err": max(float((p.detach() - e).abs().max())
                               for p, e in zip(params, single)),
            "bit_equal": all(torch.equal(p.detach(), e)
                             for p, e in zip(params, single)),
            "single_vs_single_max_abs_err": max(
                float((x - y).abs().max()) for x, y in zip(again, single)),
            "within_rtol_1e-4_atol_1e-5": excess(params, single, 1e-4,
                                                 1e-5) <= 0,
            "within_rtol_2e-3_atol_2e-4": excess(params, single, 2e-3,
                                                 2e-4) <= 0,
            "loss_rel_err": float(((hist_m.cpu() - hist_s).abs()
                                   / hist_s.abs()).max())}
        # At one rank the sharded fit loss builds the single-device terms
        # in the same order, so the runs are expected bit-equal
        # ("bit_equal"). A summation-order difference would grow from
        # epoch to epoch (Adam moves each row by about lr, its own size),
        # so the check is the JAX package's sharded-vs-single tolerance
        # (tests/test_sharding.py), the losses to rtol 1e-5; and
        # bit-equality itself is held.
        if not line["layout"]["bit_equal"]:
            fails.append("sharded layout engine at one rank is not "
                         "bit-equal to train_layout")
        if not line["layout"]["within_rtol_2e-3_atol_2e-4"]:
            fails.append("sharded layout engine disagrees with train_layout")
        if line["layout"]["loss_rel_err"] > 1e-5:
            fails.append("sharded layout losses disagree with train_layout")

        # recorded collectives: one fit epoch, one 4-epoch transform chunk
        table = n_train * cfg.out_dim * 4
        with recording() as ops:
            mesh_epochs(params, opt, sharded_tasks, statics, "fit", cfg.seed,
                        LAYOUT_EPOCHS, 1)
        fit_s = collective_summary(ops)
        enc = ModalityEncoder(K, cfg.out_dim)
        nbrs, weights, q_init = enc.transform_graph(
            torch.from_numpy(test_np["texts"]).to(dev), tables[0], single[0])
        task, static = query_task(nbrs, weights, cfg.batch_size,
                                  ref=single[0])
        q_par = [q_init.clone().requires_grad_(True)]
        q_opt = make_optimizer(q_par, cfg.lr)
        with recording() as ops:
            mesh_epochs(q_par, q_opt, (task,), (static,), "transform",
                        cfg.seed + 1, 0, 4)
        tr_s = collective_summary(ops)
        line["collectives"] = {
            "table_bytes": table,
            "fit_epoch": {"by_kind": fit_s["by_kind"],
                          "total_bytes": fit_s["total_bytes"],
                          "table_sized": _table_ops(fit_s, table),
                          "ops": fit_s["ops"]},
            "transform_chunk_4_epochs": {
                "by_kind": tr_s["by_kind"], "total_bytes": tr_s["total_bytes"],
                "table_sized": _table_ops(tr_s, table)}}
        m = len(tables)
        fit_big = _table_ops(fit_s, table)
        rs = [op for op in fit_s["ops"] if op[0] == "reduce-scatter"]
        if (fit_big.get("all-gather") != m or len(rs) != m
                or fit_big.get("all-reduce")
                or fit_s["total_bytes"] >= 3 * m * table):
            fails.append(f"fit epoch collectives: {fit_s['by_kind']}")
        if _table_ops(tr_s, table) != {"all-gather": 1}:
            fails.append(f"transform chunk collectives: {tr_s['by_kind']}")
    finally:
        dist.destroy_process_group()
    return line, fails


def _rank_main(rank: int, world: int, store: str, out: str, device: str,
               sizes: tuple, cfg_kw: dict) -> None:
    """One rank of part (b): writes ``out.<rank>.json``. Every rank's
    stacks go to ``out.<rank>.stack`` shortly before the parent's
    deadline, so a hang reports where each rank waits."""
    # The ranks share this host: gloo's pairs connect over the loopback
    # device, not the address the host name resolves to (a lookup, and
    # a route, that a sealed machine need not offer).
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    stack = None
    try:
        stack = open(f"{out}.{rank}.stack", "w")
        faulthandler.dump_traceback_later(TIMEOUT_S - STACK_DUMP_LEAD_S,
                                          file=stack)
        _rank_body(rank, world, store, out, device, sizes, cfg_kw)
    except BaseException:
        import traceback

        with open(f"{out}.{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        faulthandler.cancel_dump_traceback_later()
        if stack is not None:
            stack.close()


def _rank_body(rank: int, world: int, store: str, out: str, device: str,
               sizes: tuple, cfg_kw: dict) -> None:
    import chip_smoke as CS
    from multimodal_umap_tpu_torch import Config
    from multimodal_umap_tpu_torch.eval.validation import (
        embed_and_recon,
        knn_test,
        similarity_test,
        train,
    )
    from multimodal_umap_tpu_torch.ops import knn_tile as KT
    from multimodal_umap_tpu_torch.parallel import (
        collective_summary,
        create_mesh,
        recording,
    )

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(minutes=10))
    mesh = create_mesh(world, dev)
    n_train, n_test = sizes
    train_np, test_np = _data(n_train, n_test)
    cfg = Config(**cfg_kw)

    # Keep the first launch's inputs of each tile-kernel signature (the
    # counts stay the wrapper's own).
    census = {}
    wrapper = KT.knn_tile

    def observed(q, r, tile_k, *, exclude_self=False, row_offset=0,
                 q_sq=None, r_sq=None):
        key = (q.shape[0], r.shape[0], q.shape[1], str(q.dtype), tile_k,
               exclude_self)
        if key not in census:
            census[key] = {"q": q.clone(), "r": r.clone(),
                           "row_offset": row_offset, "launches": 0}
        census[key]["launches"] += 1
        return wrapper(q, r, tile_k, exclude_self=exclude_self,
                       row_offset=row_offset, q_sq=q_sq, r_sq=r_sq)

    phases = {}
    _sync()
    dist.barrier()
    CS.reset_counts(KT)
    KT.knn_tile = observed
    try:
        t0 = time.perf_counter()
        with recording() as train_ops:
            model = train(train_np, cfg, mesh=mesh)
        _sync()
        phases["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cosine = similarity_test(test_np, cfg, model, return_values=True,
                                 quiet=True)
        phases["similarity_test"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        knn5 = knn_test(test_np, cfg, k=5, model=model, return_values=True,
                        quiet=True)
        phases["knn_test"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        recon = embed_and_recon(model, [test_np["texts"][:N_RECON]], [0],
                                [1], cfg)[0].cpu().numpy()
        _sync()
        phases["embed_and_recon"] = time.perf_counter() - t0
    finally:
        KT.knn_tile = wrapper
    launches = {"knn_tile_bf16": KT.KNN_TILE_BF16_LAUNCHES,
                "knn_tile_f32": KT.KNN_TILE_F32_LAUNCHES,
                "knn_rownorm": KT.ROW_NORM_LAUNCHES, **CS.term_launches(),
                **CS.infonce_launches()}
    by_shape = {}
    for kind, shape, nbytes in train_ops:
        entry = by_shape.setdefault(f"{kind} {shape}", [0, 0])
        entry[0] += 1
        entry[1] += nbytes
    train_s = collective_summary(train_ops)
    result = {
        "rank": rank, "backend": mesh.backend,
        "host_staging": mesh.host_staging, "sharded": model.sharded,
        "local_rows": [int(d.shape[0]) for d in model.data],
        "embeds_finite": all(bool(torch.isfinite(e).all())
                             for e in model.embeds),
        "phase_seconds": phases, "model_phase_seconds": model.timer.report(),
        "fit_loss_first_last": [float(model.loss_history["fit"][0]),
                                float(model.loss_history["fit"][-1])],
        "cosine": cosine, "knn5": knn5,
        "recon_shape": list(recon.shape),
        "recon_mse": float(np.mean((recon - test_np["images"][:N_RECON])
                                   ** 2)),
        "train_collectives": {"by_kind": train_s["by_kind"],
                              "total_bytes": train_s["total_bytes"],
                              "by_kind_shape": by_shape},
        "launches": launches,
        "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if dev.type == "cuda" else None),
    }
    # After the path: rank 0 holds every signature against the plain
    # version and times it while rank 1 waits.
    dist.barrier()
    if rank == 0:
        sigs = []
        for (nq, n, d, dt, tk, ex), v in census.items():
            bf16 = dt == str(torch.bfloat16)
            q, r, off = v["q"], v["r"], v["row_offset"]
            qs, rs = ((KT.row_norms_sq(q), KT.row_norms_sq(r)) if bf16
                      else (None, None))
            got = KT.knn_tile(q, r, tk, exclude_self=ex, row_offset=off,
                              q_sq=qs, r_sq=rs)
            _sync()
            want = KT.knn_tile_plain(q, r, tk, exclude_self=ex, row_offset=off)
            cmp = CS.tie_aware_match(*got, *want, CS.sq_scale(q, r),
                                     CS.RTOL[bf16])
            del got, want
            b_ms, b_by = CS.bound_ms(nq, n, d, tk, bf16)
            times = {"ms": None, "plain_ms": None, "library_ms": None}
            if dev.type == "cuda":  # (a CPU rehearsal compares only)
                times = {
                    "ms": CS.cuda_ms(lambda: KT.knn_tile(
                        q, r, tk, exclude_self=ex, row_offset=off, q_sq=qs,
                        r_sq=rs), 10),
                    "plain_ms": CS.cuda_ms(lambda: KT.knn_tile_plain(
                        q, r, tk, exclude_self=ex, row_offset=off), 3),
                    "library_ms": CS.cuda_ms(lambda: CS.library_tile_topk(
                        q, r, tk, KT.TILE_C, exclude_self=ex,
                        row_offset=off), 10)}
            sigs.append({
                "Q": nq, "N": n, "D": d, "mode": "bf16" if bf16 else "f32",
                "tile_k": tk, "exclude_self": ex, "row_offset": off,
                "launches": v["launches"], "bound_ms": b_ms, "bound_by": b_by,
                **times, "vs_plain": cmp})
        result["signatures"] = sigs
    dist.barrier()
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()


def gloo_two_ranks(out_dir, device: str = "cuda:0",
                   sizes: tuple = (N_TRAIN, N_TEST),
                   cfg_kw: dict | None = None) -> tuple[dict, list, dict]:
    """Part (b); returns (the JSON line, failures, the launches summed
    over the ranks). ``device``, ``sizes`` (train, test pairs) and
    ``cfg_kw`` (``Config`` fields) cut it for a rehearsal on the CPU."""
    os.makedirs(out_dir, exist_ok=True)
    tag = uuid.uuid4().hex[:8]
    store = os.path.abspath(os.path.join(out_dir, f"gloo_store_{tag}"))
    out = os.path.abspath(os.path.join(out_dir, f"gloo_rank_{tag}"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, RANKS, store, out, device, sizes,
                               cfg_kw or {}))
             for r in range(RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    seconds = time.perf_counter() - t0
    def tail(path, n=2000):
        return open(path).read()[-n:] if os.path.exists(path) else ""

    fails = [f"rank {r} hung past {TIMEOUT_S} s; its error: "
             f"{tail(f'{out}.{r}.err')!r}; its stacks: "
             f"{tail(f'{out}.{r}.stack', 3000)!r}" for r in hung]
    fails += [f"rank {r} exited {p.exitcode}: " + tail(f"{out}.{r}.err")
              for r, p in enumerate(procs) if p.exitcode and r not in hung]
    if fails:
        return {"part": "gloo_two_ranks", "seconds": seconds}, fails, {}
    ranks = []
    for r in range(RANKS):
        with open(f"{out}.{r}.json") as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    launches = {k: sum(x["launches"][k] for x in ranks)
                for k in r0["launches"]}
    line = {"part": "gloo_two_ranks", "backend": r0["backend"],
            "ranks_per_card": RANKS, "host_staging": r0["host_staging"],
            "n_train": sizes[0], "n_test": sizes[1], "dims": list(DIMS),
            "seconds_with_spawn": seconds,
            "launches_by_rank": [x["launches"] for x in ranks],
            **{k: r0[k] for k in r0 if k not in ("launches", "rank")},
            "cosine_by_rank": [x["cosine"] for x in ranks],
            "knn5_by_rank": [x["knn5"] for x in ranks]}
    for x in ranks:
        if not (x["sharded"] and x["embeds_finite"]
                and x["local_rows"] == [sizes[0] // RANKS] * 2):
            fails.append(f"rank {x['rank']}: not sharded, wrong local rows "
                         "or non-finite embeddings")
        if x["cosine"] != r0["cosine"] or x["knn5"] != r0["knn5"]:
            fails.append("ranks disagree on the metrics")
    if not all(s["vs_plain"]["values_ok"] and s["vs_plain"]["ids_ok"]
               for s in r0["signatures"]):
        fails.append("tile kernel disagrees with plain at a ring-step "
                     "signature")
    import chip_smoke as CS

    if not all(launches[k] > 0 for k in ("knn_tile_bf16", "knn_rownorm",
                                         *CS.TERM_KERNELS)):
        fails.append(f"the mesh path left a kernel unlaunched: {launches}")
    return line, fails, launches


def run(train_np, test_np, dev, out_dir, main_cosine: float | None):
    """Both parts: (the phase's JSON line, failures, launches by part:
    the tile kernel's, and the layout-term and InfoNCE kernels' of each
    part)."""
    import chip_smoke as CS

    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    a_line, fails = nccl_world1(train_np, test_np, dev, out_dir)
    a_line["seconds"] = time.perf_counter() - t0
    b_line, b_fails, b_launches = gloo_two_ranks(out_dir)
    fails += b_fails
    cos = b_line.get("cosine")
    if cos is not None:
        if cos < 0.99:
            fails.append(f"mesh path cosine {cos} < 0.99")
        if main_cosine is not None and abs(cos - main_cosine) > 0.005:
            fails.append(f"mesh path cosine {cos} not within 0.005 of the "
                         f"main path's {main_cosine}")
    line = {"phase": "mesh_path", "nccl_world1": a_line,
            "gloo_two_ranks": b_line, "failures": fails}
    launches = {"nccl_world1": a_line.get("ring_tile_launches", 0),
                "gloo_two_ranks": b_launches,
                "nccl_world1_layout_terms": a_line.get(
                    "layout_term_launches", dict.fromkeys(CS.TERM_COUNTS, 0)),
                "gloo_two_ranks_layout_terms": {
                    k: b_launches.get(k, 0) for k in CS.TERM_COUNTS},
                "nccl_world1_infonce": a_line.get(
                    "infonce_launches",
                    dict.fromkeys(CS.infonce_launches(), 0)),
                "gloo_two_ranks_infonce": {
                    k: b_launches.get(k, 0) for k in CS.infonce_launches()}}
    return line, fails, launches


def main() -> None:
    if not torch.cuda.is_available():
        print("mesh_path_torch: needs a CUDA GPU", file=sys.stderr)
        raise SystemExit(2)
    from multimodal_umap_tpu_torch.ops import knn_tile as KT

    t0 = time.perf_counter()
    KT.build()
    print(json.dumps({"build_seconds": time.perf_counter() - t0,
                      "nvcc_seconds": KT.BUILD_SECONDS}), flush=True)
    train_np, test_np = _data()
    line, fails, _ = run(train_np, test_np, torch.device("cuda"),
                         os.path.join("chip_smoke_out", "mesh"), None)
    print(json.dumps(line), flush=True)
    if fails:
        raise SystemExit("mesh_path FAILED: " + "; ".join(fails))


if __name__ == "__main__":
    main()
