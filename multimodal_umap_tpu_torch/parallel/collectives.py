"""Every collective the port issues, and a recorder that counts them.

Counterpart of ``multimodal_umap_tpu/parallel/collectives.py``, which
parses compiled HLO for the collectives XLA inserted. Here nothing is
inserted: the mesh code calls these functions, each of which logs its
kind, result shape and result bytes while a :func:`recording` is open,
and :func:`collective_summary` returns the JAX function's dict
(``ops``, ``total_bytes``, ``by_kind``) with the same kinds and the same
byte convention (the op's RESULT: the whole gathered table for an
all-gather, one shard for a reduce-scatter or a ring pass).

* :func:`all_gather_rows` -- all-gather on rows with autograd: its
  backward is one reduce-scatter (sum) of the cotangent, JAX's
  ``all_gather`` / ``psum_scatter`` pair;
* :func:`all_gather_tensor`, :func:`reduce_scatter_rows`, :func:`psum`;
* :func:`ring_pass` -- ``batch_isend_irecv`` of a shard to rank + 1
  (JAX's ``ppermute`` ring);
* :func:`gather_rows` -- rows of every rank to one rank (checkpoints).

Under gloo with CUDA tensors (ranks sharing a card) every collective
copies through host memory; the choice is the mesh's backend
(``Mesh.host_staging``), made before any call. bf16 tensors travel as
their raw bytes (a uint8 view: neither gloo nor NCCL reduces or moves
int16), so a bf16 shard costs 2 bytes an element on the wire.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor

_DTYPE_NAME = {
    torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16",
    torch.float16: "f16", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.uint8: "u8", torch.int8: "s8",
    torch.bool: "pred",
}

_recorded: list | None = None


@contextlib.contextmanager
def recording():
    """Logs every collective issued inside the block into the yielded
    list of (kind, shape string, result bytes)."""
    global _recorded
    _recorded = []
    try:
        yield _recorded
    finally:
        _recorded = None


def _record(kind: str, result: torch.Tensor) -> None:
    if _recorded is not None:
        shape = (f"{_DTYPE_NAME.get(result.dtype, str(result.dtype))}"
                 f"[{','.join(str(s) for s in result.shape)}]")
        _recorded.append((kind, shape, result.numel() * result.element_size()))


def collective_summary(ops) -> dict:
    """The recorded ops as ``{"ops", "total_bytes", "by_kind"}``."""
    by_kind: dict[str, int] = {}
    for kind, _, b in ops:
        by_kind[kind] = by_kind.get(kind, 0) + b
    return {"ops": list(ops), "total_bytes": sum(b for _, _, b in ops),
            "by_kind": by_kind}


def _wire(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as it goes on the wire: contiguous, bf16 as its bytes, on the
    host under host staging."""
    x = x.contiguous()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.uint8)
    return x.cpu() if mesh.host_staging else x


def _unwire(x: torch.Tensor, dtype: torch.dtype, mesh) -> torch.Tensor:
    if dtype == torch.bfloat16:
        x = x.view(torch.bfloat16)
    return x.to(mesh.device) if mesh.host_staging else x


def all_gather_tensor(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``x`` stacked on rows, in rank order (no autograd)."""
    w = _wire(x, mesh)
    out = torch.empty((mesh.size * w.shape[0], *w.shape[1:]), dtype=w.dtype,
                      device=w.device)
    _ALL_GATHER(out, w)
    out = _unwire(out, x.dtype, mesh)
    _record("all-gather", out)
    return out


def _summable(x: torch.Tensor) -> None:
    if x.dtype == torch.bfloat16:  # its bytes travel, its sums would not
        raise TypeError("bf16 tensors are moved, never reduced")


def reduce_scatter_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum over ranks of ``x``, this rank's rows of it."""
    _summable(x)
    w = _wire(x, mesh)
    out = torch.empty((w.shape[0] // mesh.size, *w.shape[1:]), dtype=w.dtype,
                      device=w.device)
    _REDUCE_SCATTER(out, w, op=dist.ReduceOp.SUM)
    out = _unwire(out, x.dtype, mesh)
    _record("reduce-scatter", out)
    return out


def psum(x: torch.Tensor, mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce (default: sum) of ``x`` over the ranks, as a new tensor."""
    _summable(x)
    w = _wire(x, mesh).clone()
    dist.all_reduce(w, op=op)
    out = _unwire(w, x.dtype, mesh)
    _record("all-reduce", out)
    return out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_gather_tensor(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_rows(grad, ctx.mesh), None


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """:func:`all_gather_tensor` whose backward is one reduce-scatter
    (sum) of the gathered table's cotangent."""
    return _AllGatherRows.apply(x, mesh)


def ring_pass(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sends ``x`` to rank + 1 and returns rank - 1's (same shape and
    dtype), around the ring."""
    w = _wire(x, mesh)
    recv = torch.empty_like(w)
    ops = [dist.P2POp(dist.isend, w, (mesh.rank + 1) % mesh.size),
           dist.P2POp(dist.irecv, recv, (mesh.rank - 1) % mesh.size)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = _unwire(recv, x.dtype, mesh)
    _record("collective-permute", out)
    return out


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor | None:
    """Every rank's rows stacked in rank order on rank 0 (on the host);
    None on the other ranks."""
    w = x.detach().contiguous()
    if w.dtype == torch.bfloat16:
        w = w.view(torch.uint8)
    if mesh.backend == "gloo":
        w = w.cpu()
    parts = ([torch.empty_like(w) for _ in range(mesh.size)]
             if mesh.rank == 0 else None)
    dist.gather(w, parts, dst=0)
    if parts is None:
        return None
    out = torch.cat(parts).cpu()
    _record("gather", out)
    return out.view(torch.bfloat16) if x.dtype == torch.bfloat16 else out


def barrier(mesh) -> None:
    del mesh  # the mesh is the default process group
    dist.barrier()
