"""Data-parallel mesh over processes: one rank per device.

Counterpart of ``multimodal_umap_tpu/parallel/mesh.py``. The JAX package
runs one controller over a ``Mesh(("data",))`` of devices and declares
row shardings; here every rank is its own process on
``torch.distributed`` (NCCL for CUDA devices, gloo for the CPU), every
rank calls the same public API with the same host arrays, and each keeps
only its own rows of a row-sharded table on its device -- the rows
``jax.device_put`` with ``P("data", None)`` would give that device.

:class:`Mesh` wraps the initialised process group; :class:`ShardingPlan`
gives a rank its rows; :func:`shard_task` places a layout task. The
collectives themselves live in :mod:`.collectives`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: this process's ``rank`` of ``size``, its
    ``device``, and the process group's ``backend``."""

    rank: int
    size: int
    device: torch.device
    backend: str

    @property
    def host_staging(self) -> bool:
        """True when collectives copy through host memory: gloo on CUDA
        tensors (chosen by backend, never by catching a failure)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def create_mesh(n_devices: int | None = None,
                device: torch.device | str | None = None) -> Mesh:
    """The mesh of the initialised process group, one rank per process.

    ``n_devices`` (default: the world size) must equal the world size:
    more raises, as the JAX package raises past its visible devices, and
    fewer would leave ranks outside the mesh. Under NCCL it may not
    exceed the visible CUDA devices either (NCCL refuses two ranks on one
    card; gloo ranks may share one). ``device`` defaults to the current
    CUDA card."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "create_mesh needs an initialised process group: call "
            "torch.distributed.init_process_group in every rank (or launch "
            "with torchrun)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"requested {n} devices, world size is {world}")
    if n != world:
        raise ValueError(f"requested {n} devices, world size is {world}: "
                         "the mesh holds one rank per process")
    dev = resolve_device(device)
    backend = str(dist.get_backend())
    if (dev.type == "cuda" and backend == "nccl"
            and n > torch.cuda.device_count()):
        raise ValueError(f"requested {n} devices, have "
                         f"{torch.cuda.device_count()} visible")
    return Mesh(rank=dist.get_rank(), size=n, device=dev, backend=backend)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Row placement over the mesh."""

    mesh: Mesh

    def divides(self, num_rows: int) -> bool:
        return num_rows % self.mesh.size == 0

    def row_range(self, num_rows: int) -> tuple[int, int]:
        """This rank's rows [lo, hi) of a table whose rows divide."""
        per = num_rows // self.mesh.size
        return self.mesh.rank * per, (self.mesh.rank + 1) * per

    def shard(self, x) -> torch.Tensor:
        """This rank's rows of ``x`` (array or tensor, the same on every
        rank) on the mesh's device; raises when the rows do not divide."""
        n = x.shape[0]
        if not self.divides(n):
            raise ValueError(f"{n} rows do not divide the "
                             f"{self.mesh.size}-rank mesh")
        lo, hi = self.row_range(n)
        part = x[lo:hi]
        if not isinstance(part, torch.Tensor):
            part = torch.as_tensor(np.asarray(part))
        out = part.to(self.mesh.device)
        # A view of a table already on the device would keep all of it.
        return out.clone() if out.data_ptr() == part.data_ptr() else out

    def rows(self, x) -> torch.Tensor:
        """:meth:`shard`, or the whole table on the device when its rows
        do not divide (the JAX plan's replication fallback: only odd-sized
        fit tables, whose padding would corrupt the self-graph)."""
        if x is None:
            return None
        if self.divides(x.shape[0]):
            return self.shard(x)
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        return x.to(self.mesh.device)


def shard_task(plan: ShardingPlan, task, init_embed: torch.Tensor):
    """A fit :class:`..models.layout.LayoutTask` built on the whole graph
    and its init, cut to this rank's rows: slot arrays and the reference
    table on rows, the (N,) bandwidths whole (per-slot reads stay
    local)."""
    return task._replace(
        nbrs=plan.rows(task.nbrs), weights=plan.rows(task.weights),
        bwd_valid=plan.rows(task.bwd_valid), ref=plan.rows(task.ref),
    ), plan.rows(init_embed)
