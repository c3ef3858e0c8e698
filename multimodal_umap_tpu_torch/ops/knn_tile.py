"""Fused distance panel + per-tile top-k: the kNN kernel and its wrapper.

Replaces the TPU kernel ``_knn_tile_kernel`` / ``knn_pallas``
(multimodal_umap_tpu/ops/knn_pallas.py:48-242). The kernel itself is
CUDA C++ for Hopper (``csrc/knn_tile.cu``, whose header note gives its
design and its bound on the card); this module builds it with ``nvcc``
into the git-ignored ``build/`` directory at first use, binds it with
``ctypes``, and keeps beside it:

* :func:`knn_tile_plain` -- the same tile function in plain PyTorch
  (same candidates, same tie rule: ascending, ties to the lowest column,
  every column at most once);
* :func:`knn_tile` -- the wrapper. A CPU tensor takes the plain version;
  a CUDA tensor launches the kernel or raises (never a fallback). Every
  launch adds one to ``KNN_TILE_LAUNCHES``;
* :func:`knn_tiled` -- the ``knn_pallas`` contract around it: row blocks
  of 8192 queries (bounding the candidate buffer), the exact cross-tile
  merge with ``torch.topk`` and, in bf16 mode, the widened candidate set
  re-scored exactly in f32 with the pad/self masks re-applied.

bf16 mode ranks with single-pass bf16 products (f32 accumulation) and
norms taken from the bf16-rounded values, so the panel is the exact
squared distance of the rounded vectors; the re-score makes returned
distances exact f32. f32 mode keeps full f32 products (never TF32).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

TILE_C = 128  # column tile of the kernel (csrc/knn_tile.cu)
TILE_D = 32  # D slice of the kernel: D is zero-padded to a multiple

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "knn_tile.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

# Launches of the CUDA kernel in this process (plain-version calls on
# CPU tensors do not count).
KNN_TILE_LAUNCHES = 0
# Seconds the last nvcc build took (None: nothing built in this process).
BUILD_SECONDS: float | None = None
BUILD_LOG = ""

_lib = None


def build() -> ctypes.CDLL:
    """Compiles ``csrc/knn_tile.cu`` (once per source content) and
    returns the bound library."""
    global _lib, BUILD_SECONDS, BUILD_LOG
    if _lib is not None:
        return _lib
    tag = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    so = _BUILD_DIR / f"knn_tile_{tag}.so"
    if not so.exists():
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is None:
            raise RuntimeError("nvcc not found: no CUDA toolkit (CUDA_HOME)")
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [
            os.path.join(CUDA_HOME, "bin", "nvcc"),
            "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(tmp), str(_SRC),
        ]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        BUILD_SECONDS = time.perf_counter() - t0
        BUILD_LOG = res.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.knn_tile_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.knn_tile_launch.restype = ctypes.c_int
    _lib = lib
    return lib


def _candidate_width(k: int, n_avail: int) -> int:
    """Candidate-set width of the streamed bf16 engine: >= 2x margin over
    k, rounded up to a multiple of 8, capped at the available references
    (multimodal_umap_tpu/ops/knn.py:85-91)."""
    cand = max(2 * k, k + 16)
    cand = ((cand + 7) // 8) * 8
    return min(cand, n_avail)


def bf16_tile_k(k: int, n_avail: int) -> int:
    """Per-tile candidate width in bf16 mode: ``knn_pallas``'s k + 8,
    raised to the streamed engine's whole candidate width so that a
    cluster of near-duplicates, which all tie after bf16 rounding, is not
    cut at the lowest column ids inside one tile (32 at k=15)."""
    return min(max(k + 8, _candidate_width(k, n_avail)), TILE_C)


def _num_col_tiles(n: int) -> int:
    return -(-n // TILE_C)


def knn_tile_plain(
    q: torch.Tensor,
    r: torch.Tensor,
    tile_k: int,
    *,
    exclude_self: bool = False,
    row_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the tile kernel.

    ``q`` (Q, D) and ``r`` (N, D) share one dtype: bfloat16 (bf16 mode)
    or float32. Returns ((num_col_tiles, Q, tile_k) f32 squared
    distances, same-shape int32 global column ids): per 128-column tile
    the ``tile_k`` smallest entries, ascending, ties to the lowest
    column. Columns >= N and, with ``exclude_self``, column
    ``row_offset + i`` for query row i are +inf.
    """
    qf, rf = q.float(), r.float()
    nq, n = qf.shape[0], rf.shape[0]
    q_sq = (qf * qf).sum(1)
    r_sq = (rf * rf).sum(1)
    panel = ((-2.0 * (qf @ rf.T) + q_sq[:, None]) + r_sq[None, :]).clamp_min(0.0)
    if exclude_self:
        rows = torch.arange(nq, device=qf.device)
        cols = rows + row_offset
        ok = cols < n
        panel[rows[ok], cols[ok]] = float("inf")
    nct = _num_col_tiles(n)
    pad = nct * TILE_C - n
    if pad:
        panel = torch.nn.functional.pad(panel, (0, pad), value=float("inf"))
    vals, idx = torch.sort(panel.view(nq, nct, TILE_C), dim=2, stable=True)
    ids = idx[..., :tile_k] + (
        torch.arange(nct, device=qf.device) * TILE_C)[None, :, None]
    return (vals[..., :tile_k].permute(1, 0, 2).contiguous(),
            ids.to(torch.int32).permute(1, 0, 2).contiguous())


def knn_tile(
    q: torch.Tensor,
    r: torch.Tensor,
    tile_k: int,
    *,
    exclude_self: bool = False,
    row_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The tile function of :func:`knn_tile_plain`: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors."""
    global KNN_TILE_LAUNCHES
    if q.dim() != 2 or r.dim() != 2 or q.shape[1] != r.shape[1]:
        raise ValueError(f"bad shapes {tuple(q.shape)} / {tuple(r.shape)}")
    if q.dtype != r.dtype or q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q and r must share bfloat16 or float32, got "
                         f"{q.dtype} / {r.dtype}")
    if not 0 < tile_k <= TILE_C:
        raise ValueError(f"tile_k={tile_k} must be in [1, {TILE_C}]")
    if q.device != r.device:
        raise ValueError(f"q on {q.device}, r on {r.device}")
    if q.device.type == "cpu":
        return knn_tile_plain(q, r, tile_k, exclude_self=exclude_self,
                              row_offset=row_offset)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")

    nq, d = q.shape
    n = r.shape[0]
    if nq == 0:
        raise ValueError("no query rows")
    if _num_col_tiles(n) > 65535 or max(nq, n, row_offset + nq) >= 2**31:
        raise ValueError(f"shape out of the kernel's range: Q={nq}, N={n}")
    if d % TILE_D:
        pad = TILE_D - d % TILE_D
        q = torch.nn.functional.pad(q, (0, pad))
        r = torch.nn.functional.pad(r, (0, pad))
    q, r = q.contiguous(), r.contiguous()
    if q.data_ptr() % 16 or r.data_ptr() % 16:
        raise ValueError("q and r must be 16-byte aligned")
    lib = build()
    d_out = torch.empty((_num_col_tiles(n), nq, tile_k), dtype=torch.float32,
                        device=q.device)
    i_out = torch.empty_like(d_out, dtype=torch.int32)
    with torch.cuda.device(q.device):
        err = lib.knn_tile_launch(
            q.data_ptr(), r.data_ptr(), d_out.data_ptr(), i_out.data_ptr(),
            nq, n, q.shape[1], tile_k, row_offset, int(exclude_self),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"knn_tile kernel launch failed: CUDA error {err}")
    KNN_TILE_LAUNCHES += 1
    return d_out, i_out


def knn_tiled(
    queries: torch.Tensor,
    references: torch.Tensor,
    k: int,
    *,
    exclude_self: bool = False,
    bf16: bool = False,
    row_block: int = 8192,
    cand: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN through the tile kernel (``knn_pallas``'s contract):
    ((Q, k) ascending Euclidean distances, (Q, k) int32 ids).

    bf16: the per-tile width (:func:`bf16_tile_k`) absorbs in-tile bf16
    misranking, the merged global top-``cand`` (default max(4k, 64))
    absorbs cross-tile misranking; both are re-scored away in exact f32.
    """
    from .knn import _exact_rescore_sq

    q32 = queries.float()
    r32 = references.float()
    num_q, num_r = q32.shape[0], r32.shape[0]
    if k > num_r - (1 if exclude_self else 0):
        raise ValueError(f"k={k} exceeds available references ({num_r})")
    if bf16:
        tile_k = bf16_tile_k(k, num_r - (1 if exclude_self else 0))
        cand = max(4 * k, 64) if cand is None else cand
    else:
        tile_k = k
    if tile_k > TILE_C:
        raise ValueError(f"k={k} exceeds the kernel's tile width {TILE_C}")
    dtype = torch.bfloat16 if bf16 else torch.float32
    qw = q32.to(dtype).contiguous()
    rw = r32.to(dtype).contiguous()

    d_parts, i_parts = [], []
    for s in range(0, num_q, row_block):
        e = min(s + row_block, num_q)
        nq = e - s
        d_c, i_c = knn_tile(qw[s:e], rw, tile_k, exclude_self=exclude_self,
                            row_offset=s)
        width = d_c.shape[0] * tile_k
        cand_d = d_c.permute(1, 0, 2).reshape(nq, width)
        cand_i = i_c.permute(1, 0, 2).reshape(nq, width)
        if not bf16:
            vals, pos = torch.topk(cand_d, k, dim=1, largest=False)
            ids = cand_i.gather(1, pos)
        else:
            _, pos = torch.topk(cand_d, min(cand, width), dim=1,
                                largest=False)
            ids_c = cand_i.gather(1, pos)
            d2 = _exact_rescore_sq(q32[s:e], r32, ids_c.clamp(0, num_r - 1),
                                   chunk=min(512, nq))
            # Exhausted tiles emit +inf entries whose ids can point at
            # padded or self columns; the re-score recomputes finite
            # distances from ids, so the masks are re-applied here.
            invalid = ids_c >= num_r
            if exclude_self:
                rows = torch.arange(s, e, device=ids_c.device)[:, None]
                invalid |= ids_c == rows
            d2 = d2.masked_fill(invalid, float("inf"))
            vals, sel = torch.topk(d2, k, dim=1, largest=False)
            ids = ids_c.gather(1, sel)
        d_parts.append(vals.clamp_min(0.0).sqrt())
        i_parts.append(ids)
    return torch.cat(d_parts), torch.cat(i_parts)
