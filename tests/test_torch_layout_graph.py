"""PyTorch port: the layout epoch's static inputs and its captured CUDA
graph (``models/layout.py::_graph_chunk_runner``, the counterpart of the
JAX package's compiled ``_chunk_runner``). Imports no JAX, so on a GPU
machine without JAX it runs as

    python -m pytest --noconftest tests/test_torch_layout_graph.py -q

On the CPU: ``dynamic_roll`` / ``dynamic_slice`` against ``torch.roll`` /
slicing, forward and backward, bit-equal (pure data movement); the packed
roll vector against the host draws' ints; the eager runner on its static
buffers against a loop of fresh draws, ``torch.roll`` with Python ints and
a plain ``torch.optim.Adam``, bit-equal. On the card (``cuda`` marker):
the captured runner against the eager one for each mode at 2,048 rows
(losses rtol 1e-5 over the first 20 epochs and 1e-4 at each, embeddings
rtol 2e-3 / atol 2e-4: ``index_add_`` atomics may reorder sums, which
Adam's steps grow), resume under capture, and a failing capture that
raises.
"""

import contextlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from layout_graph_torch import eager_runner  # noqa: E402

from multimodal_umap_tpu_torch.models import layout as PL  # noqa: E402
from multimodal_umap_tpu_torch.ops import layout_terms as LT  # noqa: E402
from multimodal_umap_tpu_torch.ops import losses as PLo  # noqa: E402
from multimodal_umap_tpu_torch.ops.graph import DenseSymGraph  # noqa: E402
from multimodal_umap_tpu_torch.ops.scatter_free import (  # noqa: E402
    dynamic_roll,
    dynamic_slice,
)

torch.set_num_threads(1)

A, B = 1.577, 0.8951


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (CUDA graphs have no CPU mode)")


@pytest.mark.parametrize("n", [1, 7, 1024])
@pytest.mark.parametrize("which", ["0", "1", "n-1", "n", "3n+2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int64])
def test_dynamic_roll_is_torch_roll(dtype, which, n):
    off = {"0": 0, "1": 1, "n-1": n - 1, "n": n, "3n+2": 3 * n + 2}[which]
    gen = torch.Generator().manual_seed(n)
    if dtype == torch.int64:
        x = torch.randint(0, 1 << 40, (n,), generator=gen)
        assert torch.equal(dynamic_roll(x, torch.tensor(off)),
                           torch.roll(x, -off, 0))
        return
    x = torch.randn(n, 3, generator=gen, requires_grad=True)
    ct = torch.randn(n, 3, generator=gen)
    got = dynamic_roll(x, torch.tensor(off))
    (g_got,) = torch.autograd.grad(got, x, ct)
    want = torch.roll(x, -off, 0)
    (g_want,) = torch.autograd.grad(want, x, ct)
    assert torch.equal(got, want) and torch.equal(g_got, g_want)


@pytest.mark.parametrize("start,length", [(0, 5), (3, 4), (6, 1), (0, 9)])
def test_dynamic_slice_is_slicing(start, length):
    gen = torch.Generator().manual_seed(start)
    x = torch.randn(9, 2, generator=gen, requires_grad=True)
    ct = torch.randn(length, 2, generator=gen)
    got = dynamic_slice(x, torch.tensor(start), length)
    (g_got,) = torch.autograd.grad(got, x, ct)
    want = x[start:start + length]
    (g_want,) = torch.autograd.grad(want, x, ct)
    assert torch.equal(got, want) and torch.equal(g_got, g_want)


@pytest.mark.parametrize("start,length", [(7, 5), (8, 9), (4, 9)])
def test_dynamic_slice_wraps_as_a_roll(start, length):
    gen = torch.Generator().manual_seed(start)
    x = torch.randn(9, 2, generator=gen, requires_grad=True)
    ct = torch.randn(length, 2, generator=gen)
    got = dynamic_slice(x, torch.tensor(start), length)
    (g_got,) = torch.autograd.grad(got, x, ct)
    want = torch.roll(x, -start, 0)[:length]
    (g_want,) = torch.autograd.grad(want, x, ct)
    assert torch.equal(got, want) and torch.equal(g_got, g_want)


def _fit_graph(n, k, seed):
    rng = np.random.default_rng(seed)
    nbrs = np.stack([rng.choice(np.delete(np.arange(n), i), k, replace=False)
                     for i in range(n)])
    return DenseSymGraph(
        nbrs=torch.from_numpy(nbrs),
        weights=torch.from_numpy(rng.random((n, k)).astype(np.float32)),
        bwd_valid=torch.from_numpy(rng.random((n, k)) < 0.7), num_rows=n)


def _problem(mode, n=300, q=50, dev="cpu", seed=0):
    """(inits, tasks, statics) of a two-modality fit (InfoNCE on) or a
    one-modality transform / invert, from numpy draws."""
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a)).to(dev, dt)

    if mode == "fit":
        dense = [_fit_graph(n, 6, seed + m) for m in range(2)]
        tasks, statics = zip(*(PL.fit_task(
            DenseSymGraph(d.nbrs.to(dev), d.weights.to(dev),
                          d.bwd_valid.to(dev), n), 32) for d in dense))
        inits = [t(rng.normal(size=(n, 4))) for _ in dense]
        return inits, tasks, statics
    task, static = PL.query_task(
        t(rng.integers(0, n, (q, 6)), torch.int64),
        t(rng.random((q, 6))), 16, ref=t(rng.normal(size=(n, 4))),
        sigmas=t(rng.random(n) + 0.5) if mode == "invert" else None,
        rhos=t(rng.random(n)) if mode == "invert" else None)
    return [t(rng.normal(size=(q, 4)))], [task], [static]


KW = dict(num_rep=3, lr=0.05, batch_size=32, a=A, b=B, seed=5)


def _host_rolls(seed, epoch, statics, num_rep, n_neg=8, group=1000):
    """The ints the host generator of (seed, epoch) draws for a fit with
    InfoNCE, in draw order (models/layout.py's draws before the rolls
    became a device vector), made into the loss's roll offsets."""
    host = PL.epoch_rng(seed, epoch, torch.device("cpu")).host
    rolls = []
    for s in statics:
        stride = max(1, s.rep_count // max(num_rep, 1))
        base = int(torch.randint(0, s.rep_count, (), generator=host))
        intra = torch.randint(0, stride, (num_rep,), generator=host).tolist()
        rolls += [(base + r * stride + intra[r]) % s.rep_count
                  for r in range(num_rep)]
    num = min(s.num_rows for s in statics)
    for _ in range(2):
        rot = (0 if num % group == 0 else
               int(torch.randint(0, num, (), generator=host)))
        rolls += [rot] + torch.randint(0, num, (n_neg + 1,),
                                       generator=host).tolist()
    return rolls


@pytest.mark.parametrize("epoch", [0, 1, 17])
def test_packed_rolls_are_the_host_draws(epoch):
    _, tasks, statics = _problem("fit")
    inputs = PL._EpochInputs(tasks, statics, mode="fit", num_rep=3,
                             alpha=0.5, seed=5, device=torch.device("cpu"))
    inputs.set_epoch(epoch)
    want = _host_rolls(5, epoch, statics, 3)
    assert inputs.rolls.dtype == torch.int64
    assert inputs.rolls.tolist() == want
    drawn = PL.draw_epoch(PL.epoch_rng(5, epoch, torch.device("cpu")), tasks,
                          statics, mode="fit", num_rep=3, alpha=0.5)
    assert PL.pack_rolls(drawn, statics, 3) == want


@contextlib.contextmanager
def _int_rolls():
    """Every roll through ``torch.roll`` with a Python int."""
    def roll(x, off):
        return torch.roll(x, -int(off), 0)

    saved = LT.dynamic_roll, PLo.dynamic_roll
    LT.dynamic_roll = PLo.dynamic_roll = roll
    try:
        yield
    finally:
        LT.dynamic_roll, PLo.dynamic_roll = saved


@pytest.mark.parametrize("mode", ["fit", "transform", "invert"])
def test_eager_runner_is_the_int_roll_loop(mode):
    """train_layout on the CPU (the eager runner: static buffers, the
    device roll vector, epoch chunks of 2) against a loop of fresh draws
    per epoch, ``torch.roll`` with Python ints and a plain Adam: bit-equal
    over 5 epochs."""
    inits, tasks, statics = _problem(mode)
    alpha = 0.5 if mode == "fit" else 0.0
    embeds, hist = PL.train_layout(inits, tasks, statics, mode=mode,
                                   epochs=5, alpha=alpha, epoch_chunk=2, **KW)
    params = [e.clone().requires_grad_(True) for e in inits]
    opt = torch.optim.Adam(params, lr=KW["lr"])
    loss_fn = PL.make_loss_fn(statics, mode=mode, num_rep=KW["num_rep"],
                              alpha=alpha, batch_size=KW["batch_size"])
    ref_hist = []
    with _int_rolls():
        for e in range(5):
            draws = PL.draw_epoch(PL.epoch_rng(KW["seed"], e,
                                               torch.device("cpu")),
                                  tasks, statics, mode=mode,
                                  num_rep=KW["num_rep"], alpha=alpha)
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(params, tasks, A, B, draws)
            loss.backward()
            opt.step()
            ref_hist.append(loss.detach())
    assert torch.equal(hist, torch.stack(ref_hist))
    for got, want in zip(embeds, params):
        assert torch.equal(got, want.detach())


def _assert_close_runs(got, want, n_first=20):
    (e_g, h_g), (e_w, h_w) = got, want
    rel = (h_g.double() - h_w.double()).abs() / h_w.double().abs()
    assert float(rel[:n_first].max()) <= 1e-5
    assert float(rel.max()) <= 1e-4
    for g, w in zip(e_g, e_w):
        torch.testing.assert_close(g, w, rtol=2e-3, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["fit", "fit_bounded", "transform",
                                  "invert"])
def test_captured_runner_matches_eager_on_cuda(mode, monkeypatch):
    """``fit_bounded`` captures the memory bounds' checkpointed forms: the
    attraction's slot scan, the per-modality recompute and InfoNCE's row
    blocks."""
    _require_cuda()
    if mode == "fit_bounded":
        mode = "fit"
        monkeypatch.setattr(PL, "_ATTR_SLOT_BYTES", 1)
        monkeypatch.setattr(PL, "_MODALITY_REMAT_ROWS", 1)
        monkeypatch.setattr(PLo, "_INFONCE_BLOCK_ROWS", 512)
    inits, tasks, statics = _problem(mode, n=2048, q=2048, dev="cuda")
    kw = dict(KW, alpha=0.5 if mode == "fit" else 0.0, mode=mode, epochs=40)
    captured = PL.train_layout(inits, tasks, statics, **kw)
    with eager_runner():
        eager = PL.train_layout(inits, tasks, statics, **kw)
    assert all(bool(torch.isfinite(e).all()) for e in captured[0])
    _assert_close_runs(captured, eager)


@pytest.mark.cuda
def test_resume_under_capture_replays_the_run():
    _require_cuda()
    inits, tasks, statics = _problem("fit", n=2048, dev="cuda")
    kw = dict(KW, alpha=0.5, mode="fit")
    whole = PL.train_layout(inits, tasks, statics, epochs=40, **kw)
    snap = {}

    def keep(done, params, optimizer, hist):
        st = PL.adam_state(optimizer, params)
        snap.update(embeds=[p.detach().clone() for p in params],
                    state=PL.AdamState(st.count, [m.clone() for m in st.mu],
                                       [v.clone() for v in st.nu]))

    _, head = PL.train_layout(inits, tasks, statics, epochs=20,
                              chunk_callback=keep, **kw)
    assert snap["state"].count == 20
    embeds, tail = PL.train_layout(snap["embeds"], tasks, statics, epochs=40,
                                   start_epoch=20,
                                   init_opt_state=snap["state"], **kw)
    _assert_close_runs((embeds, torch.cat([head, tail])), whole)


_FAILING_CAPTURE = """
import os
import sys
import torch
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from test_torch_layout_graph import KW, _problem
from multimodal_umap_tpu_torch.models import layout as PL

make = PL.make_loss_fn


def syncing(*args, **kwargs):
    fn = make(*args, **kwargs)

    def loss(*a, **k):
        out = fn(*a, **k)
        float(out.detach())  # a host sync: illegal while capturing
        return out
    return loss


PL.make_loss_fn = syncing
inits, tasks, statics = _problem("transform", dev="cuda")
try:
    PL.train_layout(inits, tasks, statics, mode="transform", epochs=3,
                    alpha=0.0, **KW)
except RuntimeError as e:
    print("raised RuntimeError:", type(e).__name__, str(e)[:200], flush=True)
    os._exit(0)  # skip teardown: the failed capture's state is not reusable
os._exit(1)
"""


@pytest.mark.cuda
def test_failing_capture_raises():
    """A capture that fails (here a host sync inside the epoch) raises:
    train_layout never drops to the eager loop. In a child process: a
    failed capture leaves PyTorch's default CUDA generator in capture
    mode, which would break later tests of this process."""
    _require_cuda()
    here = Path(__file__).resolve()
    code = _FAILING_CAPTURE.format(root=str(here.parents[1]),
                                   tests=str(here.parent))
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "raised RuntimeError" in run.stdout
