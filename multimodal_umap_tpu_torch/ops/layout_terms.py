"""The fit layout's attraction and repulsion: kernel wrappers, plain
versions and the kernels' backward in PyTorch.

Counterpart of the XLA-fused ``_fit_attraction`` and ``_fit_repulsion``
(multimodal_umap_tpu/models/layout.py:252-285, :288-333); no Pallas
kernel stands behind them. The kernels are CUDA C++ for Hopper
(``csrc/layout_terms.cu``, whose header note gives their design and
bound), built in the same ``nvcc`` call as the kNN tile kernel
(``knn_tile.build``) and bound with ``ctypes``. This module keeps:

* :func:`fit_attraction` / :func:`fit_repulsion` -- the wrappers, each a
  ``torch.autograd.Function`` on CUDA tensors (a forward kernel that,
  where the gradient is wanted, also computes each pair's weight once and
  its anchor's part of the gradient, both saved for the backward; a
  backward of a gather that ends every output row, or writes a hub
  chunk's partial row, with one owner each, then for the attraction a
  pass summing the partials in a fixed order: no atomics). A CPU tensor
  takes the plain version; a CUDA tensor launches the kernels or raises
  (never a fallback). Launch counts: ``FWD_LAUNCHES`` (each term's
  forwards that saved the backward's weights and anchor part,
  ``with_grad``, and those that computed the loss alone, ``loss_only``),
  ``FIT_ATTR_BWD_LAUNCHES`` / ``FIT_REP_BWD_LAUNCHES`` (backward calls)
  and ``BWD_PASS_LAUNCHES`` (each backward kernel by name: the gathers,
  the attraction's finishing pass);
* :func:`fit_attraction_plain` / :func:`fit_repulsion_plain` -- the terms
  as autodiff PyTorch (the single-device and sharded engines' own code:
  the attraction's slot scan with recompute past ``slot_bytes``, the
  repulsion's rolls or, for a row range, slices of one permuted copy);
* :func:`reverse_index` -- the transposed index of the neighbour ids (a
  CSR) and its chunk plan (:func:`attr_work_items`), which the
  attraction's backward reads, built once with the fit task;
* :func:`_attr_fwd_twin` / :func:`_rep_fwd_twin` and
  :func:`_attr_grad_gather` / :func:`_rep_grad_gather` -- the kernels'
  forward (loss, weights and anchor parts at once) and backward (the
  gather over the work items, times the loss's gradient) in the kernels'
  own form and index arithmetic, in PyTorch, so that the CPU tests reach
  them.

Every function takes the anchor rows ``[row0, row0 + n_rows)`` of the
table it is given (``n_rows`` the rows of ``nbrs`` / ``rep_coef``): the
whole table on one device, a rank's rows of the gathered table in the
sharded engine; the gradient covers the whole table.
"""

from __future__ import annotations

import ctypes
import typing

import torch
from torch.utils.checkpoint import checkpoint

from . import knn_tile as KT
from .knn_tile import _raise_on, _stream
from . import losses as L
from .scatter_free import dynamic_roll, dynamic_slice, permutation_gather

# Launches of the CUDA kernels in this process (plain-version calls on
# CPU tensors do not count): each term's forwards by instance, its
# backward calls, and every backward kernel by name.
FWD_LAUNCHES = {"fit_attr": {"with_grad": 0, "loss_only": 0},
                "fit_rep": {"with_grad": 0, "loss_only": 0}}
FIT_ATTR_BWD_LAUNCHES = 0
FIT_REP_BWD_LAUNCHES = 0
BWD_PASS_LAUNCHES = {"fit_attr_bwd_kernel": 0,
                     "fit_attr_bwd_finish_kernel": 0,
                     "fit_rep_bwd_kernel": 0}

_CLAMP = 1e-6  # the squared-distance floor of losses.umap_attr / umap_rep

_lib = None


def _library() -> ctypes.CDLL:
    """The kernels' library (one build with the kNN tile kernel)."""
    global _lib
    if _lib is None:
        lib = KT.build()
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.fit_attr_fwd_launch.argtypes = [p] * 6 + [i, i, i, ll, f, f, p]
        lib.fit_attr_bwd_gather_launch.argtypes = [p] * 10 + [ll, i, i, i, i,
                                                              i, ll, p]
        lib.fit_attr_bwd_finish_launch.argtypes = [p] * 5 + [i, i, i, ll, p]
        lib.fit_rep_fwd_launch.argtypes = [p] * 7 + [ll, i, i, i, ll, f, f, p]
        lib.fit_rep_bwd_gather_launch.argtypes = [p] * 6 + [ll, i, i, i, ll,
                                                            p]
        for fn in (lib.fit_attr_fwd_launch, lib.fit_attr_bwd_gather_launch,
                   lib.fit_attr_bwd_finish_launch, lib.fit_rep_fwd_launch,
                   lib.fit_rep_bwd_gather_launch):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


# The most in-edges one work item of the attraction's backward takes (the
# plan's cut, passed to its gather kernel): a row with more is cut into
# chunks of this many, summed in a fixed order.
CHUNK_EDGES = 32


class ReverseIndex(typing.NamedTuple):
    """The transposed index of (n_rows, k) neighbour ids, int32, and the
    attraction backward's chunk plan over it. ``order``: the flat slots
    (i * k + m) sorted stably by target row; ``offsets``: the
    (num_rows + 1,) start of each target row's slots in ``order``. The
    plan: ``multi_row`` (M,) the rows with more than CHUNK_EDGES in-edges,
    ascending; ``multi_first`` (M + 1,) where each one's chunks start in
    the chunk list; ``chunk_multi`` (X,) the ``multi_row`` index of each
    chunk (chunk q is its row's chunk q - multi_first[r], and owns partial
    row q)."""

    order: torch.Tensor
    offsets: torch.Tensor
    multi_row: torch.Tensor
    multi_first: torch.Tensor
    chunk_multi: torch.Tensor


def reverse_index(nbrs: torch.Tensor, num_rows: int) -> ReverseIndex:
    """The CSR of ``nbrs``' in-edges over ``num_rows`` target rows (a
    stable sort and a search) and its chunk plan, whose sizes take two
    host syncs: built once per fit, before any capture. int32 halves what
    the fit layout holds for it (63 MB a modality at 524,288 x 15)."""
    if nbrs.numel() >= 2**31 - CHUNK_EDGES:
        raise ValueError(f"{nbrs.numel()} slots exceed the int32 index")
    keys, order = torch.sort(nbrs.reshape(-1), stable=True)
    offsets = torch.searchsorted(
        keys, torch.arange(num_rows + 1, dtype=keys.dtype, device=keys.device),
        out_int32=True)
    deg = offsets[1:] - offsets[:-1]
    multi_row = torch.nonzero(deg > CHUNK_EDGES).reshape(-1)
    chunks = (deg[multi_row] + CHUNK_EDGES - 1) // CHUNK_EDGES
    multi_first = torch.zeros(multi_row.shape[0] + 1, dtype=torch.int32,
                              device=nbrs.device)
    multi_first[1:] = torch.cumsum(chunks, 0)
    chunk_multi = torch.repeat_interleave(
        torch.arange(multi_row.shape[0], dtype=torch.int32,
                     device=nbrs.device), chunks,
        output_size=int(multi_first[-1]))
    return ReverseIndex(order.to(torch.int32), offsets,
                        multi_row.to(torch.int32), multi_first, chunk_multi)


def attr_work_items(rev: ReverseIndex) -> dict:
    """The work items of the attraction backward's gather as its kernel
    forms them from ``rev``: the rows of at most CHUNK_EDGES in-edges whole
    (their gradient row ended directly), then each chunk q of a longer row
    (its partial row q). Per item: ``row``, the in-edge range [``lo``,
    ``hi``) in ``rev.order`` and ``partial`` (-1: the gradient row)."""
    off = rev.offsets.long()
    n = off.shape[0] - 1
    rows = torch.arange(n, device=off.device)
    whole = rows[off[1:] - off[:-1] <= CHUNK_EDGES]
    r = rev.chunk_multi.long()
    q = torch.arange(r.shape[0], device=off.device)
    t = rev.multi_row.long()[r]
    lo = off[t] + (q - rev.multi_first.long()[r]) * CHUNK_EDGES
    return {
        "row": torch.cat([whole, t]),
        "lo": torch.cat([off[whole], lo]),
        "hi": torch.cat([off[whole + 1], torch.minimum(lo + CHUNK_EDGES,
                                                       off[t + 1])]),
        "partial": torch.cat([torch.full_like(whole, -1), q])}


def _recompute(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` whose residuals are recomputed in the
    backward. Its inputs carry every random draw, so no RNG state is
    kept for the recompute."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kwargs)


def _anchors(embed, row0: int, n_rows: int):
    # The whole table itself when the range is all of it: a slice would
    # add a node between the anchor terms and the table.
    if row0 == 0 and n_rows == embed.shape[0]:
        return embed
    return embed[row0:row0 + n_rows]


def _attr_slot(embed, nbrs_m, coef_m, a, b, row0=0):
    """One neighbour slot's attraction: (n_rows,) ids and coefficients."""
    x = _anchors(embed, row0, nbrs_m.shape[0])
    return (coef_m * L.umap_attr(x, embed[nbrs_m], a, b)).sum()


def fit_attraction_plain(embed, nbrs, coef, a, b, *, row0: int = 0,
                         slot_bytes: int | None = None) -> torch.Tensor:
    """``sum_{i,m} coef[i,m] * umap_attr(x_{row0+i}, x_{nbrs[i,m]})`` in
    autodiff PyTorch: the (n_rows, k, D) gather, whose backward is one
    ``index_add_``; past ``slot_bytes`` of that gather (None: never) the
    k slots one at a time, each recomputed in the backward."""
    n_rows, k = nbrs.shape
    if slot_bytes is not None and n_rows * k * embed.shape[1] * 4 > slot_bytes:
        nbrs_t, coef_t = nbrs.T.contiguous(), coef.T.contiguous()
        loss = embed.new_zeros(())
        for m in range(k):
            loss = loss + _recompute(_attr_slot, embed, nbrs_t[m], coef_t[m],
                                     a, b, row0)
        return loss
    y = embed[nbrs]  # (n_rows, k, D)
    attr = L.umap_attr(_anchors(embed, row0, n_rows)[:, None, :], y, a, b)
    return (coef * attr).sum()


def fit_repulsion_plain(embed, pi, pi_inv, rolls, rep_coef, a, b, *,
                        row0: int = 0) -> torch.Tensor:
    """``sum_i rep_coef[i] * mean_r umap_rep(x_{row0+i},
    x_{pi[(row0 + i + rolls[r]) % N]})`` in autodiff PyTorch: one
    permutation gather, then per round a roll (whole table) or a slice
    (row range) of it, both read at the device offset."""
    n_rows, num_rep = rep_coef.shape[0], rolls.shape[0]
    permuted = permutation_gather(embed, pi, pi_inv)
    rep_sum = torch.zeros(n_rows, dtype=embed.dtype, device=embed.device)
    if row0 == 0 and n_rows == embed.shape[0]:
        for r in range(num_rep):
            rep_sum = rep_sum + L.umap_rep(
                embed, dynamic_roll(permuted, rolls[r]), a, b)
    else:
        x = embed[row0:row0 + n_rows]
        start = torch.tensor(row0, dtype=torch.int64, device=embed.device)
        for r in range(num_rep):
            neg = dynamic_slice(permuted, start + rolls[r], n_rows)
            rep_sum = rep_sum + L.umap_rep(x, neg, a, b)
    return (rep_coef * (rep_sum / num_rep)).sum()


# --- the kernels' forward and backward in their own form, in PyTorch -------

def _attr_dfds(s, a, b):
    return a * b * s ** (b - 1.0) / (1.0 + a * s ** b)


def _rep_dpsids(s, a, b):
    u = a * s ** b
    q = u / (1.0 + u)
    return -(a * b * s ** (b - 1.0)) / ((q + 1e-6) * (1.0 + u) ** 2)


def _attr_fwd_twin(embed, nbrs, coef, a, b, row0: int = 0):
    """The attraction forward kernel where the gradient is wanted: the
    loss (one partial a row, summed); one weight a slot at g = 1,
    (n_rows * k,): 2 coef dfds(s), 0 where coef is 0 or s < 1e-6; and the
    anchor rows' part of the gradient, (n_rows, D): sum_m w (x_i -
    x_nbr)."""
    n_rows = nbrs.shape[0]
    delta = embed[row0:row0 + n_rows, None, :] - embed[nbrs]  # anchor - nbr
    sq = (delta * delta).sum(-1)
    s = sq.clamp_min(_CLAMP)
    live = coef != 0
    partial = torch.where(live, coef * torch.log1p(a * s ** b), 0.0).sum(1)
    w = torch.where(live & (sq >= _CLAMP), 2.0 * coef * _attr_dfds(s, a, b),
                    0.0)
    return partial.sum(), w.reshape(-1), (w[..., None] * delta).sum(1)


def _attr_grad_gather(embed, w, anchor_part, rev: ReverseIndex, grad_out,
                      row0: int = 0) -> torch.Tensor:
    """The attraction backward kernels, from the forward's weights ``w``
    and ``anchor_part`` (:func:`_attr_fwd_twin`): each work item of
    :func:`attr_work_items` subtracts its in-edges, w (x_anchor - x_t) in
    CSR order, from its row's anchor part (a whole row) or from 0 (a
    chunk); a row of several chunks is its anchor part plus its partials
    in chunk order; each row ends times ``grad_out``."""
    n_rows = anchor_part.shape[0]
    k = w.shape[0] // n_rows
    grad = torch.zeros_like(embed)
    grad[row0:row0 + n_rows] = anchor_part
    it = attr_work_items(rev)
    t = it["row"]
    whole = it["partial"] < 0
    xt = embed[t][:, None, :]
    pos = it["lo"][:, None] + torch.arange(CHUNK_EDGES, device=embed.device)
    valid = pos < it["hi"][:, None]
    e_in = rev.order.long()[pos.clamp_max(rev.order.shape[0] - 1)]
    w_in = torch.where(valid, w[e_in], 0.0)
    acc = -(w_in[..., None] * (embed[row0 + e_in // k] - xt)).sum(1)
    grad[t[whole]] = grad[t[whole]] + acc[whole]
    partial = acc[~whole]
    first = rev.multi_first.long()
    if first.shape[0] > 1:  # the finishing pass
        count = first[1:] - first[:-1]
        q = first[:-1, None] + torch.arange(int(count.max()),
                                            device=embed.device)
        inside = q < first[1:, None]
        multi = rev.multi_row.long()
        grad[multi] = grad[multi] + (
            partial[q.clamp_max(partial.shape[0] - 1)]
            * inside[..., None]).sum(1)
    return grad * grad_out


def _rep_fwd_twin(embed, pi, rolls, rep_coef, a, b, row0: int = 0):
    """The repulsion forward kernel where the gradient is wanted: the loss
    (one partial a row, summed); one weight an (anchor, round) at g = 1,
    (n_rows, R): 2 / R rep_coef dpsids(s), 0 where rep_coef is 0 or
    s < 1e-6; and the anchor rows' part of the gradient, (n_rows, D):
    sum_r w (x_i - x_{pi[(i + off_r) % N]})."""
    n, n_rows, r = embed.shape[0], rep_coef.shape[0], rolls.shape[0]
    rows = torch.arange(n_rows, device=embed.device) + row0
    delta = embed[rows][:, None, :] - embed[pi[(rows[:, None] + rolls) % n]]
    sq = (delta * delta).sum(-1)
    s = sq.clamp_min(_CLAMP)
    u = a * s ** b
    c = rep_coef[:, None]
    psi = torch.where(c != 0, -torch.log(u / (1.0 + u) + 1e-6), 0.0)
    partial = rep_coef * (psi.sum(1) / r)
    w = torch.where((c != 0) & (sq >= _CLAMP),
                    2.0 / r * c * _rep_dpsids(s, a, b), 0.0)
    return partial.sum(), w, (w[..., None] * delta).sum(1)


def _rep_grad_gather(embed, pi_inv, rolls, w, anchor_part, grad_out,
                     row0: int = 0) -> torch.Tensor:
    """The repulsion backward kernel, from the forward's weights ``w``
    and ``anchor_part`` (:func:`_rep_fwd_twin`): each row's negative
    part, t is round r's negative of anchor (pi_inv[t] - off_r) mod N,
    -= w (x_anchor - x_t) when that anchor lies in the row range, added
    to its anchor part and times ``grad_out``."""
    n, n_rows = embed.shape[0], w.shape[0]
    ia = (pi_inv[:, None] - rolls) % n  # the anchor whose negative t is
    local = ia - row0
    inside = (local >= 0) & (local < n_rows)
    w_neg = torch.where(inside, w.gather(0, local.clamp(0, n_rows - 1)), 0.0)
    grad = -(w_neg[..., None] * (embed[ia] - embed[:, None, :])).sum(1)
    grad[row0:row0 + n_rows] = anchor_part + grad[row0:row0 + n_rows]
    return grad * grad_out


# --- the wrappers -------------------------------------------------------------

def _check_cuda(embed, ids, n_rows: int, row0: int, a, b, **vectors):
    if embed.device.type != "cuda":
        raise ValueError(f"unsupported device {embed.device}")
    if (embed.dim() != 2 or embed.dtype != torch.float32
            or not embed.is_contiguous()):
        raise ValueError(f"embed must be a contiguous 2-D float32 tensor, "
                         f"got {embed.dtype} {tuple(embed.shape)}")
    n, d = embed.shape
    if not (0 < d and 0 < n < 2**62):
        raise ValueError(f"embed shape {tuple(embed.shape)} out of the "
                         f"kernels' range")
    if not (0 <= row0 and 0 < n_rows < 2**31 and row0 + n_rows <= n):
        raise ValueError(f"row range [{row0}, {row0 + n_rows}) outside the "
                         f"{n} rows")
    if not all(isinstance(v, (int, float)) for v in (a, b)):
        raise TypeError("a and b must be Python numbers (a device tensor "
                        "would sync the host)")
    for name, (v, dtype) in {**ids, **vectors}.items():
        if (v.dtype != dtype or v.device != embed.device
                or not v.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dtype} on "
                             f"{embed.device}, got {v.dtype} on {v.device}")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _wants_grad(embed) -> bool:
    """Whether a term's forward saves its backward's weights and anchor
    part: only where autograd will call the backward."""
    return torch.is_grad_enabled() and embed.requires_grad


def _launch_pass(entry: str, kernel: str, *args) -> None:
    """Launches one backward kernel through its C entry and counts it."""
    _raise_on(getattr(_library(), entry)(*args), kernel)
    BWD_PASS_LAUNCHES[kernel] += 1


def _forward_buffers(embed, n_rows: int, pairs: int, with_grad: bool):
    """(partial, w, grad): one f32 partial a row; where the gradient is
    wanted, the weights of the ``pairs`` pairs and the gradient table
    whose anchor rows the forward writes and whose every row the
    backward's gather ends, both kept with ``save_for_backward`` (so that
    a recomputed forward remakes them); else None and None."""
    partial = torch.empty(n_rows, dtype=torch.float32, device=embed.device)
    if not with_grad:
        return partial, None, None
    return (partial, torch.empty(pairs, dtype=torch.float32,
                                 device=embed.device),
            torch.empty_like(embed))


def _saved_grad(ctx):
    """The forward's saved tensors, its gradient table marked as changed
    in place: the gather ends it there, so that a second backward through
    the same graph raises instead of reading it again."""
    saved = ctx.saved_tensors
    torch.autograd.graph.increment_version(saved[2])
    return saved


class _FitAttraction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, embed, nbrs, coef, order, offsets, multi_row,
                multi_first, chunk_multi, a, b, row0, with_grad):
        n_rows, k = nbrs.shape
        partial, w, grad = _forward_buffers(embed, n_rows, n_rows * k,
                                            with_grad)
        with torch.cuda.device(embed.device):
            err = _library().fit_attr_fwd_launch(
                embed.data_ptr(), nbrs.data_ptr(), coef.data_ptr(),
                partial.data_ptr(), _ptr(w), _ptr(grad), n_rows, k,
                embed.shape[1], row0, a, b, _stream(embed))
        _raise_on(err, "fit_attr_fwd")
        FWD_LAUNCHES["fit_attr"]["with_grad" if with_grad else
                                 "loss_only"] += 1
        if with_grad:
            ctx.save_for_backward(embed, w, grad, order, offsets, multi_row,
                                  multi_first, chunk_multi)
            ctx.consts = (n_rows, k, row0)
        return partial.sum()

    @staticmethod
    def backward(ctx, grad_out):
        global FIT_ATTR_BWD_LAUNCHES
        (embed, w, grad, order, offsets, multi_row, multi_first,
         chunk_multi) = _saved_grad(ctx)
        n_rows, k, row0 = ctx.consts
        n, d = embed.shape
        g = grad_out.to(torch.float32).contiguous()
        # scratch: the hub chunks' partial rows
        partial = torch.empty(chunk_multi.shape[0], d, dtype=torch.float32,
                              device=embed.device)
        s = _stream(embed)
        with torch.cuda.device(embed.device):
            _launch_pass("fit_attr_bwd_gather_launch", "fit_attr_bwd_kernel",
                         embed.data_ptr(), w.data_ptr(), g.data_ptr(),
                         order.data_ptr(), offsets.data_ptr(),
                         multi_row.data_ptr(), multi_first.data_ptr(),
                         chunk_multi.data_ptr(), grad.data_ptr(),
                         partial.data_ptr(), n, chunk_multi.shape[0],
                         CHUNK_EDGES, n_rows, k, d, row0, s)
            FIT_ATTR_BWD_LAUNCHES += 1
            if multi_row.shape[0] > 0:  # rows of several chunks
                _launch_pass("fit_attr_bwd_finish_launch",
                             "fit_attr_bwd_finish_kernel", partial.data_ptr(),
                             multi_row.data_ptr(), multi_first.data_ptr(),
                             g.data_ptr(), grad.data_ptr(),
                             multi_row.shape[0], n_rows, d, row0, s)
        return (grad,) + (None,) * 11


class _FitRepulsion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, embed, pi, pi_inv, rolls, rep_coef, a, b, row0,
                with_grad):
        n_rows, r = rep_coef.shape[0], rolls.shape[0]
        partial, w, grad = _forward_buffers(embed, n_rows, n_rows * r,
                                            with_grad)
        with torch.cuda.device(embed.device):
            err = _library().fit_rep_fwd_launch(
                embed.data_ptr(), pi.data_ptr(), rolls.data_ptr(),
                rep_coef.data_ptr(), partial.data_ptr(), _ptr(w), _ptr(grad),
                embed.shape[0], n_rows, r, embed.shape[1], row0, a, b,
                _stream(embed))
        _raise_on(err, "fit_rep_fwd")
        FWD_LAUNCHES["fit_rep"]["with_grad" if with_grad else
                                "loss_only"] += 1
        if with_grad:
            ctx.save_for_backward(embed, w, grad, pi_inv, rolls)
            ctx.consts = (n_rows, row0)
        return partial.sum()

    @staticmethod
    def backward(ctx, grad_out):
        global FIT_REP_BWD_LAUNCHES
        embed, w, grad, pi_inv, rolls = _saved_grad(ctx)
        n_rows, row0 = ctx.consts
        n, d = embed.shape
        g = grad_out.to(torch.float32).contiguous()
        with torch.cuda.device(embed.device):
            _launch_pass("fit_rep_bwd_gather_launch", "fit_rep_bwd_kernel",
                         embed.data_ptr(), pi_inv.data_ptr(),
                         rolls.data_ptr(), w.data_ptr(), g.data_ptr(),
                         grad.data_ptr(), n, n_rows, rolls.shape[0], d, row0,
                         _stream(embed))
            FIT_REP_BWD_LAUNCHES += 1
        return (grad,) + (None,) * 8


def fit_attraction(embed, nbrs, coef, a, b, *, row0: int = 0,
                   rev: ReverseIndex | None = None,
                   slot_bytes: int | None = None) -> torch.Tensor:
    """The attraction term (:func:`fit_attraction_plain`) over anchor rows
    ``[row0, row0 + n_rows)`` of ``embed`` (N, D): the plain version for
    a CPU tensor (``slot_bytes`` bounds its gather), the fused kernels
    for a CUDA one (f32 ``embed``, int64 ``nbrs``, f32 ``coef``; ``rev``:
    :func:`reverse_index` of ``nbrs`` over the N rows). Returns the 0-d
    loss."""
    if nbrs.dim() != 2 or coef.shape != nbrs.shape:
        raise ValueError(f"nbrs {tuple(nbrs.shape)} and coef "
                         f"{tuple(coef.shape)} must be one (n_rows, k) shape")
    if embed.device.type == "cpu":
        return fit_attraction_plain(embed, nbrs, coef, a, b, row0=row0,
                                    slot_bytes=slot_bytes)
    n = embed.shape[0]
    if rev is None:
        raise ValueError("the kernel needs rev = reverse_index(nbrs, N), "
                         "built once for all epochs (layout.fit_task)")
    _check_cuda(embed, {"nbrs": (nbrs, torch.int64),
                        **{f"rev.{f}": (v, torch.int32)
                           for f, v in rev._asdict().items()}},
                nbrs.shape[0], row0, a, b, coef=(coef, torch.float32))
    if (rev.order.shape != (nbrs.numel(),) or rev.offsets.shape != (n + 1,)
            or rev.multi_first.shape != (rev.multi_row.shape[0] + 1,)):
        raise ValueError("rev is not the reverse index of nbrs over the "
                         f"{n} rows")
    return _FitAttraction.apply(embed, nbrs, coef, *rev, float(a), float(b),
                                int(row0), _wants_grad(embed))


def fit_repulsion(embed, pi, pi_inv, rolls, rep_coef, a, b, *,
                  row0: int = 0) -> torch.Tensor:
    """The repulsion term (:func:`fit_repulsion_plain`) over anchor rows
    ``[row0, row0 + n_rows)`` of ``embed`` (N, D), ``n_rows`` the length
    of ``rep_coef``: the plain version for a CPU tensor, the fused
    kernels for a CUDA one (``pi`` / ``pi_inv`` (N,) int64, ``rolls`` the
    (R,) int64 device vector of round offsets, read by the kernels).
    Returns the 0-d loss."""
    if rolls.dim() != 1 or rolls.shape[0] == 0:
        raise ValueError(f"rolls must hold at least one offset, got "
                         f"{tuple(rolls.shape)}")
    if embed.device.type == "cpu":
        return fit_repulsion_plain(embed, pi, pi_inv, rolls, rep_coef, a, b,
                                   row0=row0)
    n = embed.shape[0]
    if pi.shape != (n,) or pi_inv.shape != (n,) or rep_coef.dim() != 1:
        raise ValueError(f"pi {tuple(pi.shape)}, pi_inv {tuple(pi_inv.shape)}"
                         f" must be ({n},) and rep_coef 1-D")
    _check_cuda(embed, {"pi": (pi, torch.int64), "pi_inv": (pi_inv,
                                                            torch.int64),
                        "rolls": (rolls, torch.int64)},
                rep_coef.shape[0], row0, a, b,
                rep_coef=(rep_coef, torch.float32))
    return _FitRepulsion.apply(embed, pi, pi_inv, rolls, rep_coef, float(a),
                               float(b), int(row0), _wants_grad(embed))
