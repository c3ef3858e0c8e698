"""Spawned gloo ranks for the port's mesh tests (not collected itself).

:func:`run_ranks` starts P processes (``torch.multiprocessing``'s spawn
context), each with one torch thread, a gloo process group that meets
through a ``file://`` store in the test's ``tmp_path`` (no TCP port: six
xdist workers spawn at once) and a CPU :class:`Mesh`; each calls one of
the ``*_rank`` functions below and sends its result back through a file.
A rank that fails sends its traceback; a rank that hangs is killed at the
spawn's ``timeout``, which also bounds ``init_process_group``, so a fault
fails its test instead of stalling the suite.

The rank functions import only torch and the port: the spawned
interpreters never load JAX.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing
import os
import time
import traceback
import uuid

import numpy as np
import torch

DEFAULT_TIMEOUT = 60.0


def _entry(fn, rank: int, world: int, store: str, out: str, args,
           timeout: float) -> None:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from multimodal_umap_tpu_torch.parallel import create_mesh

    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        result = fn(create_mesh(world, "cpu"), *args)
        torch.save(result, f"{out}.{rank}.pt")
        # No rank closes its connections while a peer's are still being
        # set up (a rank that makes no collective can finish first).
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(f"{out}.{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world: int, tmp_path, *args,
              timeout: float = DEFAULT_TIMEOUT, meanwhile=None):
    """``fn(mesh, *args)`` on ``world`` spawned gloo ranks; returns each
    rank's result, in rank order. Raises on a failed or hung rank.
    ``meanwhile()``, called in this process while the ranks run, makes
    the return (ranks' results, its result)."""
    ctx = multiprocessing.get_context("spawn")
    tag = uuid.uuid4().hex[:8]
    store = os.path.join(tmp_path, f"store_{tag}")
    out = os.path.join(tmp_path, f"rank_{tag}")
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, store, out, args, timeout),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    aside = None if meanwhile is None else meanwhile()
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = [open(f"{out}.{r}.err").read() for r in range(world)
            if os.path.exists(f"{out}.{r}.err")]
    if errs:
        raise RuntimeError("a rank failed:\n" + "\n".join(errs))
    if hung:
        raise TimeoutError(f"ranks {hung} still running after {timeout} s")
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if bad:
        raise RuntimeError(f"ranks exited with codes {bad}")
    results = [torch.load(f"{out}.{r}.pt", weights_only=False)
               for r in range(world)]
    return results if meanwhile is None else (results, aside)


# ---- rank functions (each runs on every rank; results come back) ----

def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return x


def knn_ring_rank(mesh, cases):
    """``knn_ring`` on each case's whole tables (dicts with q, r (None:
    the queries themselves), k, exclude_self, bf16, num_valid_cols,
    stored ("float32" | "bfloat16")); this rank's (d, i) and the ring's
    collective summary."""
    from multimodal_umap_tpu_torch.ops.knn_stream import knn_ring
    from multimodal_umap_tpu_torch.parallel import (
        collective_summary,
        recording,
    )

    out = []
    for c in cases:
        dtype = getattr(torch, c.get("stored", "float32"))
        q = torch.as_tensor(c["q"]).to(dtype)
        r = q if c.get("r") is None else torch.as_tensor(c["r"]).to(dtype)
        with recording() as ops:
            d, i = knn_ring(q, r, c["k"], mesh,
                            exclude_self=c.get("exclude_self", False),
                            bf16=c.get("bf16"),
                            num_valid_cols=c.get("num_valid_cols"))
        out.append({"d": _np(d), "i": _np(i),
                    "summary": collective_summary(ops)})
    return out


def knn_ring_refuses_rank(mesh, x):
    """The ring's refusal of rows that do not divide the mesh."""
    from multimodal_umap_tpu_torch.ops.knn_stream import knn_ring

    try:
        knn_ring(torch.as_tensor(x), torch.as_tensor(x), 3, mesh)
    except ValueError as exc:
        return str(exc)
    return None


def fit_graph_rank(mesh, x, k, out_dim, stored="float32"):
    """``ModalityEncoder.fit_graph`` on this rank's rows of ``x``."""
    from multimodal_umap_tpu_torch.models.encoder import ModalityEncoder
    from multimodal_umap_tpu_torch.parallel import ShardingPlan

    enc = ModalityEncoder(k, out_dim)
    feats = ShardingPlan(mesh).shard(x).to(getattr(torch, stored))
    graph, dense, init = enc.fit_graph(feats, mesh=mesh)
    return {"nbrs": _np(dense.nbrs), "weights": _np(dense.weights),
            "bwd_valid": _np(dense.bwd_valid), "edge_w": _np(graph.weights),
            "edge_valid": _np(graph.valid), "init": _np(init),
            "sigmas": _np(enc.sigmas), "rhos": _np(enc.rhos)}


def _tasks(plan, tasks_np, inits_np):
    from multimodal_umap_tpu_torch.models.layout import LayoutTask
    from multimodal_umap_tpu_torch.parallel import shard_task

    def t(x, dtype=None):
        return None if x is None else torch.as_tensor(x, dtype=dtype)

    tasks, inits = [], []
    for tn, e in zip(tasks_np, inits_np):
        task = LayoutTask(nbrs=t(tn["nbrs"], torch.long),
                          weights=t(tn["weights"], torch.float32),
                          bwd_valid=t(tn.get("bwd_valid")),
                          ref=t(tn.get("ref"), torch.float32),
                          sigmas=t(tn.get("sigmas"), torch.float32),
                          rhos=t(tn.get("rhos"), torch.float32))
        task, init = shard_task(plan, task, t(e, torch.float32))
        tasks.append(task)
        inits.append(init)
    return tasks, inits


def layout_rank(mesh, mode, tasks_np, statics, inits_np, draws_list, kw,
                ref_gather_bytes=None):
    """``train_layout(..., mesh=)`` on this rank's rows of whole tasks,
    with the given per-epoch draws; the whole embeddings, the history,
    and whether the sharded engine ran."""
    from multimodal_umap_tpu_torch.models.layout import (
        sharded_compatible,
        train_layout,
    )
    from multimodal_umap_tpu_torch.parallel import ShardingPlan
    from multimodal_umap_tpu_torch.parallel.collectives import (
        all_gather_tensor,
    )

    if ref_gather_bytes is not None:
        os.environ["MMUMAP_REF_GATHER_BYTES"] = str(ref_gather_bytes)
    tasks, inits = _tasks(ShardingPlan(mesh), tasks_np, inits_np)
    embeds, hist = train_layout(
        inits, tasks, statics, mode=mode,
        draws=None if draws_list is None else draws_list.__getitem__,
        mesh=mesh, **kw)
    return {"embeds": [_np(all_gather_tensor(e, mesh)) for e in embeds],
            "hist": _np(hist),
            "sharded": sharded_compatible(inits, tasks, statics, mesh)}


def layout_engines_rank(mesh, mode, tasks_np, statics, inits_np, kw):
    """:func:`layout_rank` with the reference tables gathered ("full",
    the default threshold) and then kept sharded ("ring": threshold 0)."""
    full = layout_rank(mesh, mode, tasks_np, statics, inits_np, None, kw)
    ring = layout_rank(mesh, mode, tasks_np, statics, inits_np, None, kw, 0)
    return {"full": full, "ring": ring}


def _mesh_epochs(mesh, params, tasks, statics, mode, epochs, *, num_rep,
                 alpha, batch_size, lr, a, b, seed, ring=False):
    """Epochs [0, epochs) of the mesh engine called directly
    (``train_layout`` takes it only past one rank): the loss made with the
    mesh, run by the eager runner with it on the (seed, epoch) draws; the
    history summed over the ranks."""
    from multimodal_umap_tpu_torch.models import layout as PL

    if mode == "fit":
        tasks = PL.with_reverse_index(tasks, statics)
    loss_fn = PL.make_loss_fn(statics, mode=mode, num_rep=num_rep,
                              alpha=alpha, batch_size=batch_size, mesh=mesh)
    inputs = PL._EpochInputs(tasks, statics, mode=mode, num_rep=num_rep,
                             alpha=alpha, seed=seed,
                             device=params[0].device)
    with PL._eager_chunk_runner(
            params, PL.make_optimizer(params, lr), loss_fn, tasks, a, b,
            inputs, 0, mesh=mesh, ring=ring) as run_chunk:
        return run_chunk(0, epochs)


def sharded_vs_single_rank(mesh, tasks_np, statics, inits_np, kw):
    """The mesh engine called directly (at one rank ``train_layout`` takes
    the single-device runner) beside ``train_layout`` on the same (seed,
    epoch) draws: both embeddings and histories."""
    from multimodal_umap_tpu_torch.models.layout import train_layout
    from multimodal_umap_tpu_torch.parallel import ShardingPlan

    tasks, inits = _tasks(ShardingPlan(mesh), tasks_np, inits_np)
    single, s_hist = train_layout(inits, tasks, statics, mode="fit", **kw)
    params = [e.detach().clone().requires_grad_(True) for e in inits]
    hist = _mesh_epochs(mesh, params, tasks, statics, "fit", kw["epochs"],
                        **{k: kw[k] for k in ("num_rep", "alpha",
                                              "batch_size", "lr", "a", "b",
                                              "seed")})
    return {"single": [_np(e) for e in single], "single_hist": _np(s_hist),
            "sharded": [_np(p) for p in params], "sharded_hist": _np(hist)}


def term_calls_rank(mesh, task_np, n, k, d, num_rep, seed):
    """The fit loss made on the mesh (this rank's rows) beside the
    single-device one on the same draws, with every call of the attraction
    and repulsion functions (``ops.layout_terms``) recorded: per engine
    the loss, the gradient of the whole table and each call's row range,
    coefficients and term value."""
    from multimodal_umap_tpu_torch.models import layout as PL
    from multimodal_umap_tpu_torch.ops import layout_terms as LT
    from multimodal_umap_tpu_torch.parallel import ShardingPlan, shard_task
    from multimodal_umap_tpu_torch.parallel.collectives import (
        all_gather_rows,
    )

    gen = torch.Generator().manual_seed(seed)
    embed = torch.randn(n, d, generator=gen)
    task, static = PL.fit_task(_dense(task_np, n), 32)
    draws = PL.draw_epoch(PL.epoch_rng(seed, 0, torch.device("cpu")), [task],
                          [static], mode="fit", num_rep=num_rep,
                          alpha=0.0).modality[0]
    rolls = torch.tensor(PL._fit_rolls(draws, static, num_rep))
    calls = []

    def recorded(name, fn):
        def run(*args, **kwargs):
            value = fn(*args, **kwargs)
            calls.append({"term": name, "row0": kwargs.get("row0", 0),
                          "coef": _np(args[2] if name == "attr" else args[4]),
                          "table_rows": args[0].shape[0],
                          "value": _np(value)})
            return value
        return run

    saved = (LT.fit_attraction, LT.fit_repulsion)
    LT.fit_attraction = recorded("attr", saved[0])
    LT.fit_repulsion = recorded("rep", saved[1])
    kw = dict(a=1.577, b=0.8951, num_rep=num_rep, batch_size=32)
    try:
        e = embed.clone().requires_grad_(True)
        loss = PL._fit_modality_loss(e, task, static, draws, rolls=rolls,
                                     deterministic=False, **kw)
        loss.backward()
        single = {"loss": _np(loss), "grad": _np(e.grad), "calls": calls[:]}
        calls.clear()
        plan = ShardingPlan(mesh)
        l_task, local = shard_task(plan, task, embed)
        local = local.clone().requires_grad_(True)
        full = all_gather_rows(local, mesh)
        loss = PL._fit_modality_loss(
            full, l_task, static, draws, rolls=rolls, deterministic=False,
            row0=mesh.rank * local.shape[0], mesh=mesh, **kw)
        loss.backward()
        sharded = {"loss": _np(loss), "grad": _np(local.grad),
                   "calls": calls[:]}
    finally:
        LT.fit_attraction, LT.fit_repulsion = saved
    return {"single": single, "sharded": sharded}


def _dense(task_np, n):
    from multimodal_umap_tpu_torch.ops.graph import DenseSymGraph

    return DenseSymGraph(nbrs=torch.as_tensor(task_np["nbrs"]),
                         weights=torch.as_tensor(task_np["weights"]),
                         bwd_valid=torch.as_tensor(task_np["bwd_valid"]),
                         num_rows=n)


def collectives_rank(mesh, n, k, d, q):
    """Recorded collectives of one fit epoch, of a 4-epoch transform
    chunk (full and ring), of a 3-epoch invert ring chunk, of the ring
    kNN (f32 and bf16 tables) and of one mesh Laplacian apply, on random
    tables of n rows (fit), q queries, width d."""
    from multimodal_umap_tpu_torch.models.encoder import ModalityEncoder
    from multimodal_umap_tpu_torch.models.layout import fit_task, query_task
    from multimodal_umap_tpu_torch.ops import spectral as S
    from multimodal_umap_tpu_torch.ops.graph import symmetrize_dense
    from multimodal_umap_tpu_torch.ops.knn_stream import knn_ring
    from multimodal_umap_tpu_torch.parallel import (
        ShardingPlan,
        collective_summary,
        recording,
        shard_task,
    )

    plan = ShardingPlan(mesh)
    rng = np.random.default_rng(0)
    out = {}
    a, b = 1.577, 0.8951

    def run(tasks, statics, params, mode, epochs, ref_gather="full",
            num_rep=4):
        params = [p.clone().requires_grad_(True) for p in params]
        with recording() as ops:
            _mesh_epochs(mesh, params, tasks, statics, mode, epochs,
                         num_rep=num_rep, alpha=1.0 if mode == "fit" else 0.0,
                         batch_size=128, lr=0.01, a=a, b=b, seed=0,
                         ring=ref_gather == "ring")
        return collective_summary(ops)

    tasks, statics, params = [], [], []
    for _ in range(2):
        nbrs = torch.as_tensor(rng.integers(0, n, size=(n, k)))
        w = torch.as_tensor(rng.uniform(0.1, 1.0, size=(n, k)),
                            dtype=torch.float32)
        task, static = fit_task(symmetrize_dense(nbrs, w), 128)
        task, init = shard_task(plan, task, torch.as_tensor(
            rng.normal(size=(n, d)), dtype=torch.float32))
        tasks.append(task)
        statics.append(static)
        params.append(init)
    out["fit_epoch"] = run(tasks, statics, params, "fit", 1)

    ref = rng.normal(size=(n, d)).astype(np.float32)
    sig = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    rho = rng.uniform(0.0, 0.5, size=n).astype(np.float32)
    for mode, ref_gather, epochs in (("transform", "full", 4),
                                     ("transform", "ring", 3),
                                     ("invert", "ring", 3)):
        nbrs = torch.as_tensor(rng.integers(0, n, size=(q, k)))
        w = torch.as_tensor(rng.uniform(0.1, 1.0, size=(q, k)),
                            dtype=torch.float32)
        extra = ({} if mode == "transform" else
                 {"sigmas": torch.as_tensor(sig),
                  "rhos": torch.as_tensor(rho)})
        task, static = query_task(nbrs, w, 128, ref=torch.as_tensor(ref),
                                  **extra)
        task, init = shard_task(plan, task, torch.as_tensor(
            rng.normal(size=(q, d)), dtype=torch.float32))
        out[f"{mode}_{ref_gather}_{epochs}"] = run(
            [task], [static], [init], mode, epochs, ref_gather)

    x = rng.normal(size=(n, d)).astype(np.float32)
    for name, dtype in (("ring_f32", torch.float32),
                        ("ring_bf16", torch.bfloat16)):
        xt = torch.as_tensor(x).to(dtype)
        with recording() as ops:
            knn_ring(xt, xt, k, mesh, exclude_self=True,
                     bf16=dtype == torch.bfloat16)
        out[name] = collective_summary(ops)

    enc = ModalityEncoder(k, 8)
    graph, _, _ = enc.fit_graph(plan.shard(x), mesh=mesh)
    lap = S._MeshLaplacian(S.dest_shard_graph(graph, mesh))
    block = torch.as_tensor(rng.normal(size=(n, 17)), dtype=torch.float32)
    with recording() as ops:
        lap(block)
    out["laplacian_apply"] = collective_summary(ops)
    return out


def model_rank(mesh, x0, x1, queries, path, fit_kw, query_kw,
               feature_dtype="float32"):
    """A mesh model fitted on (x0, x1) and saved to ``path``, then
    ``transform`` of ``queries`` (modality 0) and ``inverse_transform``
    of the result to modality 1; plus this rank's placement and the
    transform query graph of the whole (padded) queries."""
    from multimodal_umap_tpu_torch.models.mixture import MultimodalUMAP
    from multimodal_umap_tpu_torch.parallel.collectives import (
        all_gather_tensor,
    )

    model = MultimodalUMAP(8, 4, 0.1, 2, device="cpu", mesh=mesh,
                           feature_dtype=feature_dtype)
    model.fit([x0, x1], **fit_kw)
    model.save_state_dict(path)

    def whole(x):
        return _np(all_gather_tensor(x, mesh) if model.sharded else x)

    q_pad, n_q = model._pad_query(torch.as_tensor(queries))
    nbrs, weights, init = model.encoders[0].transform_graph(
        model._my_rows(q_pad), model.data[0], model.embeds[0],
        mesh=mesh if model.sharded else None)
    weights = model._mask_padded(weights, n_q)
    emb = model.transform([queries], data_indices=[0], **query_kw)
    rec = model.inverse_transform([emb[0]], data_indices=[1], **query_kw)
    return {
        "sharded": model.sharded,
        "data_rows": [int(d.shape[0]) for d in model.data],
        "data_dtypes": [str(d.dtype) for d in model.data],
        "embed_rows": [int(e.shape[0]) for e in model.embeds],
        "embeds": [whole(e) for e in model.embeds],
        "fit_hist": model.loss_history["fit"],
        "q_nbrs": whole(nbrs), "q_weights": whole(weights),
        "q_init": whole(init),
        "transform": _np(emb[0]), "invert": _np(rec[0]),
        "transform_hist": model.loss_history["transform"],
        "invert_hist": model.loss_history["invert"]}


def resume_rank(mesh, x0, x1, snap, kw):
    """A 20-epoch mesh fit snapshotted, resumed to 40, and a 40-epoch fit
    uninterrupted (epoch chunks of 5, every chunk snapshotted)."""
    from multimodal_umap_tpu_torch.models.mixture import MultimodalUMAP
    from multimodal_umap_tpu_torch.parallel.collectives import (
        all_gather_tensor,
    )

    os.environ["MMUMAP_EPOCH_CHUNK"] = "5"
    os.environ["MMUMAP_SNAPSHOT_INTERVAL_S"] = "0"

    def model():
        return MultimodalUMAP(8, 4, 0.1, 2, seed=7, device="cpu", mesh=mesh)

    part = model()
    part.fit([x0, x1], epochs=20, progress_path=snap, **kw)
    resumed = model()
    resumed.fit([x0, x1], epochs=40, progress_path=snap, resume=True, **kw)
    full = model()
    full.fit([x0, x1], epochs=40, **kw)
    return {"resumed": [_np(all_gather_tensor(e, mesh))
                        for e in resumed.embeds],
            "full": [_np(all_gather_tensor(e, mesh)) for e in full.embeds],
            "resumed_rows": [int(e.shape[0]) for e in resumed.embeds],
            "resumed_hist_len": len(resumed.loss_history["fit"]),
            "full_hist": full.loss_history["fit"],
            "resumed_hist": resumed.loss_history["fit"]}


def cli_rank(mesh, workdir, argv):
    """``main_torch.main`` under the mesh's process group, run from
    ``workdir``: first refused with ``--mesh_devices 3``, then run with
    ``argv``. Returns the refusal's message and whether this rank
    printed."""
    import contextlib
    import io

    import main_torch

    os.chdir(workdir)
    err = io.StringIO()
    refused = None
    with contextlib.redirect_stderr(err):
        try:
            main_torch.main(argv[:-2] + ["--mesh_devices", "3"])
        except SystemExit as exc:
            refused = exc.code
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model = main_torch.main(argv)
    return {"refused": refused, "refusal": err.getvalue(),
            "printed": out.getvalue(), "sharded": model.sharded}


def extract_rank(mesh, samples, batch_size):
    """``extract_features(..., mesh=)`` with row-wise stand-in encoders,
    and this rank's calls' batch sizes."""
    from multimodal_umap_tpu_torch.data.flickr30k import (
        Encoders,
        extract_features,
    )

    seen = []

    def texts(batch):
        seen.append(len(batch))
        return np.stack([[len(t), sum(map(ord, t)) % 97] for t in batch]
                        ).astype(np.float32)

    def images(batch):
        return batch.reshape(batch.shape[0], -1)[:, :8].astype(np.float32)

    out = extract_features(samples, Encoders(texts, images),
                           batch_size=batch_size, mesh=mesh)
    return {**out, "batches": seen}


def primitives_rank(mesh):
    """Each collective on rank-dependent values: all_gather_rows with its
    gradient, psum, ring_pass and gather_rows of f32 and bf16 rows."""
    from multimodal_umap_tpu_torch.parallel import collectives as C

    r = mesh.rank
    x = (torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * r
         ).requires_grad_(True)
    full = C.all_gather_rows(x, mesh)
    w = torch.arange(full.numel(), dtype=torch.float32).reshape(full.shape)
    (w * full * (r + 1)).sum().backward()
    bf = (x.detach() / 3).to(torch.bfloat16)
    gathered = C.gather_rows(x, mesh)  # on rank 0, None elsewhere
    gathered_bf16 = C.gather_rows(bf, mesh)
    return {"full": _np(full), "grad": _np(x.grad),
            "psum": _np(C.psum(torch.tensor([1.0 + r]), mesh)),
            "ring": _np(C.ring_pass(x.detach(), mesh)),
            "ring_bf16": C.ring_pass(bf, mesh).view(torch.int16).numpy(),
            "sent_bf16": bf.view(torch.int16).numpy(),
            "gather": None if r else _np(gathered),
            "gather_bf16": (None if r else
                            gathered_bf16.view(torch.int16).numpy())}


def graph_cache_rank(mesh, x0, x1, cache, kw):
    """Two mesh fits with one graph cache: the first builds and saves it
    (rank 0 writes), the second loads it instead of building."""
    from multimodal_umap_tpu_torch.models.mixture import MultimodalUMAP
    from multimodal_umap_tpu_torch.parallel.collectives import (
        all_gather_tensor,
    )

    out = []
    for _ in range(2):
        model = MultimodalUMAP(8, 4, 0.1, 2, device="cpu", mesh=mesh)
        model.fit([x0, x1], graph_cache_path=cache, **kw)
        out.append({"phases": sorted(model.timer.report()),
                    "embeds": [_np(all_gather_tensor(e, mesh))
                               for e in model.embeds],
                    "sigmas": _np(model.encoders[0].sigmas)})
    return out


def profiled_fit_rank(mesh, x0, x1, kw):
    """A mesh fit without and then under an active ``torch.profiler``:
    each time the rank's embeddings, loss history and timer names."""
    from multimodal_umap_tpu_torch.models.mixture import MultimodalUMAP

    out = []
    for profiled in (False, True):
        model = MultimodalUMAP(8, 4, 0.1, 2, device="cpu", mesh=mesh)
        ctx = (torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
            if profiled else contextlib.nullcontext())
        with ctx:
            model.fit([x0, x1], **kw)
        out.append({"phases": sorted(model.timer.phases),
                    "sharded": model.sharded,
                    "embeds": [_np(e) for e in model.embeds],
                    "hist": model.loss_history["fit"]})
    return out
