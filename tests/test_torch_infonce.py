"""PyTorch port: the fit layout's InfoNCE term (``ops/losses.py``) and its
CUDA kernels (``csrc/infonce.cu``). Imports no JAX, so on a GPU machine
it runs as

    python -m pytest --noconftest tests/test_torch_infonce.py -q

On the CPU: the kernels' algorithm in PyTorch (the forward's saved
coefficients and anchor gradients, the backward's gathers through
``q_inv``) against autograd of the plain ``infonce``, a pair and one
direction (the pair with the other direction's upstream gradient 0),
with ``num`` a multiple of ``group_size`` and not, a rotation,
forced anchor collisions, the plain version's row blocks, n_neg 8 and 3
and D 64, 200 and 7; a CPU pair is the two plain calls and never reaches
the library. On the card (``cuda`` marker): the kernels against the plain
version at the fit's shapes (the 118,287-row case in a child process with
a 120 s limit, so that a kernel that stalls fails instead of hanging the
suite), bit-reproducible over two calls, captured in a CUDA graph with
the draws refilled between replays, counted, and, in a profiled capture
of the fit layout, inside the ``infonce_fwd`` / ``infonce_bwd`` sections.
"""

import ctypes
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from multimodal_umap_tpu_torch.ops import losses as L  # noqa: E402

torch.set_num_threads(1)

T = 0.5  # the layout's temperature


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")


def _draws(num, n_neg, gs, seed, *, rot=None, collide=False):
    """One direction's draws on the CPU. ``collide``: q is the identity
    and two negative columns take the rotation's offset, so every slot
    has those two columns masked."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.arange(num) if collide else torch.randperm(num, generator=gen)
    q_inv = torch.empty_like(q)
    q_inv[q] = torch.arange(num)
    if rot is None:
        rot = 0 if num % gs == 0 else int(torch.randint(1, num, (),
                                                        generator=gen))
    offsets = torch.randint(0, num, (n_neg + 1,), generator=gen).tolist()
    if collide:
        offsets[1] = offsets[4 % (n_neg + 1)] = rot
    return L.InfoNCEDraws(rot=rot, q=q, q_inv=q_inv, offsets=offsets)


def _to(draws, dev):
    return L.InfoNCEDraws(draws.rot, draws.q.to(dev), draws.q_inv.to(dev),
                          draws.offsets)


def _tables(num, d, seed, dev="cpu", extra=0):
    gen = torch.Generator().manual_seed(1000 + seed)
    e = [torch.randn(num + extra * (m == 0), d, generator=gen)
         for m in range(2)]
    return [x.to(dev) for x in e]


def _close(got, want, rtol_of_max):
    tol = rtol_of_max * float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol, f"max error {err:.3e} > {tol:.3e}"


def _autograd(fn, e0, e1, gs=(0.7, 1.3)):
    """(losses, grads) of ``fn(a, b)`` (one loss or a pair) under the
    upstream gradients ``gs``."""
    a = e0.detach().clone().requires_grad_(True)
    b = e1.detach().clone().requires_grad_(True)
    out = fn(a, b)
    out = out if isinstance(out, tuple) else (out,)
    sum(g * o for g, o in zip(gs, out)).backward()
    return [o.detach() for o in out], [a.grad, b.grad]


# ---- the kernels' algorithm on the CPU ----

# (num, D, n_neg, group_size, draw kw, plain block rows or None)
TWIN_CASES = {
    "multiple_d64": (120, 64, 8, 40, {}, None),
    "ragged_rot_d64": (123, 64, 8, 40, {"rot": 17}, None),
    "collide_d64": (97, 64, 8, 30, {"collide": True}, None),
    "blocked_d64": (300, 64, 8, 64, {}, 64),
    "nneg3_d200": (150, 200, 3, 1000, {}, None),
    "nneg3_d7": (61, 7, 3, 16, {"rot": 5}, None),
}


def _twin(e0, e1, dr, rolls, gs, g):
    """(losses, grads) of the twin under the upstream gradients ``g``:
    the forward of each direction, then the backward's gathers."""
    num = min(e0.shape[0], e1.shape[0])
    dirs, losses = [], []
    for k, (a, b) in enumerate([(e0, e1), (e1, e0)]):
        loss, coef, ga = L._infonce_twin_forward(a, b, dr[k].q, rolls[k], T,
                                                 gs)
        losses.append(loss)
        dirs.append(dict(A=a, q_inv=dr[k].q_inv, rolls=rolls[k], coef=coef,
                         ga=ga, g=torch.tensor(g[k])))
    return losses, L._infonce_twin_backward(dirs, num, gs)


@pytest.mark.parametrize("pair", [True, False], ids=["pair", "single"])
@pytest.mark.parametrize("case", list(TWIN_CASES))
def test_twin_is_autograd_of_the_plain_loss(case, pair, monkeypatch):
    num, d, n_neg, gs, kw, block = TWIN_CASES[case]
    if block is not None:
        monkeypatch.setattr(L, "_INFONCE_BLOCK_ROWS", block)
    dr = [_draws(num, n_neg, gs, seed, **kw) for seed in (1, 2)]
    rolls = [torch.tensor(L.infonce_rolls(x)) for x in dr]
    e0, e1 = _tables(num, d, seed=3)
    if pair:
        want = _autograd(lambda a, b: L.infonce_pair(
            dr[0], dr[1], a, b, n_neg=n_neg, group_size=gs), e0, e1)
    else:
        want = _autograd(lambda a, b: L.infonce(
            dr[0], a, b, n_neg=n_neg, group_size=gs), e0, e1)
    if kw.get("collide"):
        assert L._infonce_slots(num, dr[0].q, rolls[0])[1][:, 2].eq(-1).all()
    got = _twin(e0, e1, dr, rolls, gs, (0.7, 1.3) if pair else (0.7, 0.0))
    for g, w in zip(got[0], want[0]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=0.0)
    for g, w in zip(got[1], want[1]):
        _close(g, w, 1e-4)


def test_twin_slots_mirror_the_rolls():
    """The twin's index algebra: slot i's anchor is row (i + rot) % num;
    negative column c reads q[(i + off_c) % num], as ``dynamic_roll``."""
    num = 11
    dr = _draws(num, 3, 4, seed=7, rot=3)
    a, rows = L._infonce_slots(num, dr.q, torch.tensor(L.infonce_rolls(dr)))
    i = torch.arange(num)
    assert torch.equal(a, (i + 3) % num)
    for c, off in enumerate(dr.offsets):
        neg = dr.q[(i + off) % num]
        assert torch.equal(rows[:, c + 1], torch.where(neg == a, -1, neg))


def test_cpu_pair_is_two_plain_calls(monkeypatch):
    """A CPU pair gives the two directions' plain losses bit for bit and
    never loads the kernels."""
    def refuse():
        raise AssertionError("a CPU tensor reached the kernels")

    monkeypatch.setattr(L, "_library", refuse)
    dr = [_draws(90, 8, 40, seed) for seed in (1, 2)]
    e0, e1 = _tables(90, 16, seed=4)
    counts = (L.INFONCE_FWD_LAUNCHES, L.INFONCE_BWD_LAUNCHES)
    got = _autograd(lambda a, b: L.infonce_pair(dr[0], dr[1], a, b,
                                                group_size=40), e0, e1)
    want = _autograd(lambda a, b: (L.infonce(dr[0], a, b, group_size=40),
                                   L.infonce(dr[1], b, a, group_size=40)),
                     e0, e1)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(g, w)
    assert (L.INFONCE_FWD_LAUNCHES, L.INFONCE_BWD_LAUNCHES) == counts


def test_non_cuda_device_raises_without_fallback():
    dr = _draws(8, 2, 4, seed=1)
    e = torch.empty(8, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        L.infonce_pair(dr, dr, e, e, n_neg=2, group_size=4)


# ---- on the card ----

# (num, D, n_neg, group_size, draw kw, extra rows of e0)
CUDA_CASES = {
    "flickr_d64": (31783, 64, 8, 1000, {}, 0),
    "d200": (31744, 200, 8, 1000, {}, 0),
    "collide_d64": (4097, 64, 8, 300, {"collide": True}, 0),
    "nneg3_d7": (3001, 7, 3, 100, {}, 0),
    "nneg12_d64": (5000, 64, 12, 1000, {}, 0),
    "unequal_rows_d64": (2500, 64, 8, 1000, {"rot": 9}, 5),
}


def _cuda_problem(num, d, n_neg, gs, kw, extra=0):
    dr = [_to(_draws(num, n_neg, gs, seed, **kw), "cuda") for seed in (1, 2)]
    rolls = [torch.tensor(L.infonce_rolls(x), device="cuda") for x in dr]
    e0, e1 = _tables(num, d, seed=5, dev="cuda", extra=extra)
    return dr, rolls, e0, e1


def _pair_fn(dr, rolls, n_neg, gs, plain=False):
    if plain:
        return lambda a, b: (
            L.infonce(dr[0], a, b, n_neg, T, gs, rolls=rolls[0]),
            L.infonce(dr[1], b, a, n_neg, T, gs, rolls=rolls[1]))
    return lambda a, b: L.infonce_pair(dr[0], dr[1], a, b, n_neg=n_neg,
                                       temperature=T, group_size=gs,
                                       rolls=tuple(rolls))


def _check_against_plain(num, d, n_neg, gs, kw, extra=0) -> None:
    dr, rolls, e0, e1 = _cuda_problem(num, d, n_neg, gs, kw, extra)
    got = _autograd(_pair_fn(dr, rolls, n_neg, gs), e0, e1)
    want = _autograd(_pair_fn(dr, rolls, n_neg, gs, plain=True), e0, e1)
    torch.cuda.synchronize()
    for g, w in zip(got[0], want[0]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=0.0)
    for g, w in zip(got[1], want[1]):
        _close(g, w, 1e-4)
    # one direction alone: the pair's other loss unused (its upstream
    # gradient 0)
    pair = _pair_fn(dr, rolls, n_neg, gs)
    got = _autograd(lambda a, b: pair(a, b)[0], e0, e1)
    want = _autograd(lambda a, b: L.infonce(dr[0], a, b, n_neg, T, gs,
                                            rolls=rolls[0]), e0, e1)
    torch.testing.assert_close(got[0][0], want[0][0], rtol=1e-5, atol=0.0)
    for g, w in zip(got[1], want[1]):
        _close(g, w, 1e-4)
    if extra:
        assert not got[1][0][num:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_kernels_match_plain_on_cuda(case):
    _require_cuda()
    _check_against_plain(*CUDA_CASES[case])


@pytest.mark.cuda
def test_coco_scale_in_a_child_process():
    """118,287 x 64, forward and backward against the plain version, in a
    child process that must end within 120 s: a kernel whose blocks
    waited on each other would stall there once the grid outgrows the
    blocks the card holds at once."""
    _require_cuda()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, __file__, "118287"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert "ok" in res.stdout and time.perf_counter() - t0 < 120


@pytest.mark.cuda
def test_kernels_are_bit_reproducible():
    _require_cuda()
    dr, rolls, e0, e1 = _cuda_problem(31783, 64, 8, 1000, {})
    fn = _pair_fn(dr, rolls, 8, 1000)
    first, second = (_autograd(fn, e0, e1) for _ in range(2))
    for x, y in zip(first[0] + first[1], second[0] + second[1]):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_captured_replay_equals_eager():
    """Forward and backward captured in a CUDA graph (draws and rolls at
    fixed addresses, read on the device) replay bit-equal to the eager
    call after the draws are refilled in place."""
    _require_cuda()
    num, n_neg, gs = 9000, 8, 1000
    dr, rolls, e0, e1 = _cuda_problem(num, 64, n_neg, gs, {"rot": 11})
    a = e0.clone().requires_grad_(True)
    b = e1.clone().requires_grad_(True)
    fn = _pair_fn(dr, rolls, n_neg, gs)

    def step():
        l0, l1 = fn(a, b)
        (0.7 * l0 + 1.3 * l1).backward()
        return l0, l1

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        step()
    torch.cuda.current_stream().wait_stream(side)
    a.grad = b.grad = None
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    for epoch in range(3):
        new = [_draws(num, n_neg, gs, 10 * epoch + s, rot=3 + epoch)
               for s in (1, 2)]
        for k in range(2):
            dr[k].q.copy_(new[k].q)
            dr[k].q_inv.copy_(new[k].q_inv)
            rolls[k].copy_(torch.tensor(L.infonce_rolls(new[k])))
        with torch.no_grad():
            a.mul_(1.01)
        a.grad.zero_()
        b.grad.zero_()
        graph.replay()
        want = _autograd(fn, a.detach(), b.detach())
        for x, y in zip(out, want[0]):
            assert torch.equal(x.detach(), y)
        assert torch.equal(a.grad, want[1][0])
        assert torch.equal(b.grad, want[1][1])


@pytest.mark.cuda
def test_cuda_tensors_launch_the_counted_kernels(monkeypatch):
    """A pair launches one forward kernel a direction and one backward
    kernel, also where one of its losses goes unused; neither reaches the
    plain version."""
    _require_cuda()

    def refuse(*_, **__):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(L, "infonce", refuse)
    dr, rolls, e0, e1 = _cuda_problem(2000, 64, 8, 1000, {})
    pair = _pair_fn(dr, rolls, 8, 1000)
    for fn, want in ((pair, (2, 1)), (lambda a, b: pair(a, b)[1], (2, 1))):
        before = (L.INFONCE_FWD_LAUNCHES, L.INFONCE_BWD_LAUNCHES)
        _autograd(fn, e0, e1)
        assert (L.INFONCE_FWD_LAUNCHES - before[0],
                L.INFONCE_BWD_LAUNCHES - before[1]) == want


# CUgraphNodeType (cuda.h)
_KERNEL, _EVENT_RECORD = 0, 7


def _graph_nodes(raw_graph: int):
    """(nodes, {node: kind}, {node: kernel name}, edges) of a CUDA graph."""
    cu = ctypes.CDLL("libcuda.so.1")
    g = ctypes.c_void_p(raw_graph)
    n = ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(g, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)) == 0
    m = ctypes.c_size_t(0)
    assert cu.cuGraphGetEdges(g, None, None, ctypes.byref(m)) == 0
    frm, to = (ctypes.c_void_p * m.value)(), (ctypes.c_void_p * m.value)()
    assert cu.cuGraphGetEdges(g, frm, to, ctypes.byref(m)) == 0
    kinds, names = {}, {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)) == 0
        kinds[node] = kind.value
        if kind.value == _KERNEL:
            params = (ctypes.c_void_p * 16)()  # CUDA_KERNEL_NODE_PARAMS_v2
            assert cu.cuGraphKernelNodeGetParams_v2(
                ctypes.c_void_p(node), params) == 0
            name = ctypes.c_char_p()
            # func, or (launched as a CUkernel) kern after the launch shape
            if params[0]:
                err = cu.cuFuncGetName(ctypes.byref(name),
                                       ctypes.c_void_p(params[0]))
            else:
                err = cu.cuKernelGetName(ctypes.byref(name),
                                         ctypes.c_void_p(params[7]))
            assert err == 0, f"no kernel name (CUDA error {err})"
            names[node] = name.value.decode()
    return list(nodes), kinds, names, list(zip(frm, to))


def _reach(start, edges) -> set:
    out, todo = set(), [start]
    nxt = {}
    for f, t in edges:
        nxt.setdefault(f, []).append(t)
    while todo:
        for t in nxt.get(todo.pop(), []):
            if t not in out:
                out.add(t)
                todo.append(t)
    return out


@pytest.mark.cuda
def test_profiled_capture_places_kernels_in_sections(monkeypatch):
    """In the fit layout's epoch captured under a profiler, every InfoNCE
    forward and finishing kernel node follows the ``infonce_fwd`` border
    and precedes the ``infonce_bwd`` border, and the backward kernel node
    lies between that border and ``modality_bwd``'s."""
    _require_cuda()
    from test_torch_layout_graph import KW, _problem

    from multimodal_umap_tpu_torch.models import layout as PL
    from multimodal_umap_tpu_torch.utils.prof import PhaseTimer

    graphs = []

    class Kept(torch.cuda.CUDAGraph):
        def capture_end(self):
            super().capture_end()
            graphs.append(_graph_nodes(self.raw_cuda_graph()))

    monkeypatch.setattr(torch.cuda, "CUDAGraph",
                        lambda: Kept(keep_graph=True))
    inits, tasks, statics = _problem("fit", n=2048, dev="cuda")
    timer = PhaseTimer("cuda")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]), timer.phase("fit/layout"):
        PL.train_layout(inits, tasks, statics, mode="fit", epochs=5,
                        alpha=0.5, **KW)
    assert timer.phases["fit/layout/epochs/infonce_fwd"] > 0
    ((nodes, kinds, names, edges),) = graphs
    border = dict(zip(PL.EPOCH_SECTIONS + ("end",),
                      [v for v in _topo(nodes, edges)
                       if kinds[v] == _EVENT_RECORD]))
    after = {s: _reach(v, edges) for s, v in border.items()}

    def inside(node, sec, nxt):
        return node in after[sec] and node not in after[nxt] and \
            border[nxt] in _reach(node, edges)

    found = {"fwd": 0, "finish": 0, "bwd": 0}
    for node, name in names.items():
        if "infonce_fwd_kernel" in name:
            assert inside(node, "infonce_fwd", "infonce_bwd"), name
            found["fwd"] += 1
        elif "infonce_finish_kernel" in name:
            assert inside(node, "infonce_fwd", "infonce_bwd"), name
            found["finish"] += 1
        elif "infonce_bwd_kernel" in name:
            assert inside(node, "infonce_bwd", "modality_bwd"), name
            found["bwd"] += 1
    assert found == {"fwd": 2, "finish": 1, "bwd": 1}


def _topo(nodes, edges) -> list:
    """The nodes in a topological order (Kahn's, ties in node order)."""
    deg = {v: 0 for v in nodes}
    nxt = {}
    for f, t in edges:
        deg[t] += 1
        nxt.setdefault(f, []).append(t)
    ready = [v for v in nodes if deg[v] == 0]
    out = []
    while ready:
        v = ready.pop(0)
        out.append(v)
        for t in nxt.get(v, []):
            deg[t] -= 1
            if deg[t] == 0:
                ready.append(t)
    return out


if __name__ == "__main__":
    # test_coco_scale_in_a_child_process's child: one case at the given rows
    rows = int(sys.argv[1])
    _check_against_plain(rows, 64, 8, 1000, {})
    torch.cuda.synchronize()
    print("ok", rows)
