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
  launch adds one to its mode's count, ``KNN_TILE_BF16_LAUNCHES`` or
  ``KNN_TILE_F32_LAUNCHES``;
* :func:`row_norms_sq` / :func:`row_norms_sq_plain` -- the bf16 mode's
  norm pre-pass (a second kernel in the same source, counted in
  ``ROW_NORM_LAUNCHES``) and its plain version;
* :func:`launch_geometry` -- padded D, tiles, blocks and shared memory
  of a launch, in Python so that the CPU tests reach it;
* :func:`tf32_split_plain` -- the f32 mode's split of each value into a
  TF32 head and its remainder, in plain PyTorch;
* :func:`knn_tiled` -- the ``knn_pallas`` contract around it: row blocks
  of 8192 queries met by the references :data:`COL_BLOCK` columns at a
  time (``knn_streamed``'s blocking: the candidate buffers are one
  chunk's whatever N is), the exact merge of every tile's and chunk's
  candidates with ``torch.topk`` and, in bf16 mode, the widened
  candidate set re-scored exactly in f32 with the pad/self masks
  re-applied.

bf16 mode ranks with single-pass bf16 products (f32 accumulation) and
norms taken from the bf16-rounded values, so the panel is the exact
squared distance of the rounded vectors; the re-score makes returned
distances exact f32 (exact w.r.t. the stored values for bf16-stored
tables, which reach the kernel without an f32 copy). f32 mode returns its
panel's distances without a re-score: its products are split-precision
(3xTF32: hi.hi + hi.lo + lo.hi on the tensor cores, each 16-wide D slice
summed into a round-to-nearest f32 total), within 1e-5 of the cancelled
terms |q|^2 + |r|^2 of the f32 panel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

import torch

TILE_C = 256  # column tile of the kernel and of the output contract
TILE_D = 64  # bf16 D slice of the kernel (one 128-byte TMA box row)
TILE_D_F32 = 16  # f32 D slice (one 64-byte TMA box row)
# D is zero-padded to a multiple of the mode's slice.
# Reference columns per kernel launch in knn_tiled: knn_streamed's default
# col_block (multimodal_umap_tpu/ops/knn_stream.py:304), a multiple of
# TILE_C. Bounds the candidate buffers of a row block independently of N.
COL_BLOCK = 32768

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
# One nvcc call builds every kernel of the port into one library: the kNN
# tile kernel's, the layout terms' (ops/layout_terms.py binds those) and
# InfoNCE's (ops/losses.py).
_SOURCES = (_CSRC / "knn_tile.cu", _CSRC / "layout_terms.cu",
            _CSRC / "infonce.cu")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

# Launches of the CUDA tile kernel in this process, one count per mode
# (``knn_tile_bf16_kernel``, ``knn_tile_f32_kernel``); plain-version
# calls on CPU tensors do not count, nor does the norm pre-pass.
KNN_TILE_BF16_LAUNCHES = 0
KNN_TILE_F32_LAUNCHES = 0
# Launches of the bf16 row-norm pre-pass kernel.
ROW_NORM_LAUNCHES = 0
# Seconds the last nvcc build took (None: nothing built in this process),
# the build's ptxas report (kept beside the library) and the library.
BUILD_SECONDS: float | None = None
BUILD_LOG = ""
SO_PATH: Path | None = None

_lib = None


@dataclass(frozen=True)
class Geometry:
    """Launch geometry of one tile-kernel call (mirrors csrc/knn_tile.cu)."""

    d_pad: int  # D after zero padding
    block_rows: int  # query rows per block
    col_tiles: int  # output column tiles (TILE_C wide)
    blocks: int  # blocks launched
    threads: int  # threads per block
    smem_bytes: int  # dynamic shared memory per block
    stages: int  # D slices in the TMA ring


def launch_geometry(nq: int, n: int, d: int, bf16: bool) -> Geometry:
    """The tile kernel's launch geometry for q (nq, d), r (n, d)."""
    slice_d = TILE_D if bf16 else TILE_D_F32
    d_pad = -(-d // slice_d) * slice_d
    col_tiles = _num_col_tiles(n)
    if bf16:
        # bf16 slices of q and r; full/empty mbarriers
        stages, rows, barriers = 4, 128, 2
        stage_bytes = (rows + TILE_C) * TILE_D * 2
    else:
        # f32 slices of q and r, twice (hi in place, lo); full/ready/empty
        stages, rows, barriers = 5, 64, 3
        stage_bytes = 2 * (rows + TILE_C) * TILE_D_F32 * 4
    # ring + mbarriers + row/column norms + 1 KB alignment
    smem = (stages * stage_bytes + barriers * stages * 8
            + 4 * (rows + TILE_C) + 1024)
    return Geometry(d_pad=d_pad, block_rows=rows, col_tiles=col_tiles,
                    blocks=-(-nq // rows) * col_tiles, threads=384,
                    smem_bytes=smem, stages=stages)


def _nvcc_cmd(cuda_home: str, out: Path) -> list[str]:
    stubs = [p for p in (os.path.join(cuda_home, "lib64", "stubs"),
                         os.path.join(cuda_home, "targets", "x86_64-linux",
                                      "lib", "stubs")) if os.path.isdir(p)]
    return [
        os.path.join(cuda_home, "bin", "nvcc"),
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(out), *map(str, _SOURCES),
        *[f"-L{p}" for p in stubs], "-lcuda",
    ]


def build() -> ctypes.CDLL:
    """Compiles ``csrc/knn_tile.cu``, ``csrc/layout_terms.cu`` and
    ``csrc/infonce.cu`` in one ``nvcc`` call (once per source content and
    nvcc command) and returns the library with the tile kernel's entry
    points bound."""
    global _lib, BUILD_SECONDS, BUILD_LOG, SO_PATH
    if _lib is not None:
        return _lib
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit (CUDA_HOME)")
    h = hashlib.sha1()
    for src in _SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(_nvcc_cmd(CUDA_HOME, Path("x"))).encode())
    so = _BUILD_DIR / f"kernels_{h.hexdigest()[:12]}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        res = subprocess.run(_nvcc_cmd(CUDA_HOME, tmp), capture_output=True,
                             text=True, check=False)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        BUILD_SECONDS = time.perf_counter() - t0
        so.with_suffix(".log").write_text(res.stderr)
        os.replace(tmp, so)
    BUILD_LOG = so.with_suffix(".log").read_text()
    lib = ctypes.CDLL(str(so))
    lib.knn_tile_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.knn_tile_launch.restype = ctypes.c_int
    lib.knn_rownorm_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.knn_rownorm_launch.restype = ctypes.c_int
    lib.knn_tile_smem_bytes.argtypes = [ctypes.c_int]
    lib.knn_tile_smem_bytes.restype = ctypes.c_int
    SO_PATH = so
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
    distances, same-shape int32 global column ids): per ``TILE_C``-column tile
    the ``tile_k`` smallest entries, ascending, ties to the lowest
    column. Columns >= N and, with ``exclude_self``, column
    ``row_offset + i`` for query row i (where it lies in [0, N)) are
    +inf.
    """
    qf, rf = q.float(), r.float()
    nq, n = qf.shape[0], rf.shape[0]
    q_sq = (qf * qf).sum(1)
    r_sq = (rf * rf).sum(1)
    panel = ((-2.0 * (qf @ rf.T) + q_sq[:, None]) + r_sq[None, :]).clamp_min(0.0)
    if exclude_self:
        # row_offset is negative for a column chunk that starts after the
        # query block: those rows' self columns lie outside this r.
        rows = torch.arange(nq, device=qf.device)
        cols = rows + row_offset
        ok = (cols >= 0) & (cols < n)
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


def tf32_split_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the f32 mode's in-kernel split: ``hi`` is each f32
    value rounded to TF32 (10 explicit mantissa bits; the low 13 bits 0)
    to nearest, ties away from zero, as ``cvt.rna.tf32.f32``; ``lo`` =
    x - hi, exact in f32. The kernel feeds the tensor cores hi and
    tf32(lo) (the head of this function applied to lo)."""
    x = x.float().contiguous()
    bits = x.view(torch.int32)
    # Adding half a TF32 ulp to the magnitude bits and truncating rounds
    # to nearest with ties away from zero (the sign bit is apart).
    hi = torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)
    return hi, x - hi


def row_norms_sq_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the norm pre-pass: |x_i|^2 in f32 of the rows of
    ``x`` as they are (bf16-rounded values in bf16 mode)."""
    xf = x.float()
    return (xf * xf).sum(1)


def _pad_d(x: torch.Tensor, d_pad: int) -> torch.Tensor:
    if x.shape[1] != d_pad:
        x = torch.nn.functional.pad(x, (0, d_pad - x.shape[1]))
    return x.contiguous()


def row_norms_sq(x: torch.Tensor) -> torch.Tensor:
    """The norm pre-pass of the bf16 tile kernel: the plain version for a
    CPU tensor, the CUDA kernel (one warp per row) for a CUDA bf16 one."""
    global ROW_NORM_LAUNCHES
    if x.dim() != 2:
        raise ValueError(f"bad shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return row_norms_sq_plain(x)
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError(f"needs a bfloat16 CUDA tensor, got {x.dtype} on "
                         f"{x.device}")
    if x.shape[0] == 0 or x.shape[0] >= 2**31:
        raise ValueError(f"row count {x.shape[0]} out of range")
    x = _pad_d(x, -(-x.shape[1] // 8) * 8)
    if x.data_ptr() % 16:  # the kernel loads 8 bf16 at a time
        raise ValueError("x must be 16-byte aligned")
    lib = build()
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.knn_rownorm_launch(
            x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row-norm kernel launch failed: CUDA error {err}")
    ROW_NORM_LAUNCHES += 1
    return out


def knn_tile(
    q: torch.Tensor,
    r: torch.Tensor,
    tile_k: int,
    *,
    exclude_self: bool = False,
    row_offset: int = 0,
    q_sq: torch.Tensor | None = None,
    r_sq: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The tile function of :func:`knn_tile_plain`: the plain version
    for CPU tensors, the CUDA kernel for CUDA tensors. In bf16 mode the
    kernel reads the rows' squared norms from :func:`row_norms_sq`;
    ``q_sq`` / ``r_sq`` pass ones already computed (f32, one per row)."""
    global KNN_TILE_BF16_LAUNCHES, KNN_TILE_F32_LAUNCHES
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
    if (_num_col_tiles(n) > 65535
            or max(nq, n, abs(row_offset) + nq) >= 2**31):
        raise ValueError(f"shape out of the kernel's range: Q={nq}, N={n}")
    bf16 = q.dtype == torch.bfloat16
    geo = launch_geometry(nq, n, d, bf16)
    q, r = _pad_d(q, geo.d_pad), _pad_d(r, geo.d_pad)
    if q.data_ptr() % 16 or r.data_ptr() % 16:
        raise ValueError("q and r must be 16-byte aligned")
    lib = build()
    if bf16:
        q_sq = row_norms_sq(q) if q_sq is None else q_sq
        r_sq = row_norms_sq(r) if r_sq is None else r_sq
        for name, v, rows in (("q_sq", q_sq, nq), ("r_sq", r_sq, n)):
            if (v.shape != (rows,) or v.dtype != torch.float32
                    or v.device != q.device or not v.is_contiguous()):
                raise ValueError(f"{name} must be ({rows},) contiguous f32 "
                                 f"on {q.device}")
        norm_ptrs = (q_sq.data_ptr(), r_sq.data_ptr())
    else:
        norm_ptrs = (None, None)
    d_out = torch.empty((geo.col_tiles, nq, tile_k), dtype=torch.float32,
                        device=q.device)
    i_out = torch.empty_like(d_out, dtype=torch.int32)
    with torch.cuda.device(q.device):
        err = lib.knn_tile_launch(
            q.data_ptr(), r.data_ptr(), *norm_ptrs, d_out.data_ptr(),
            i_out.data_ptr(), nq, n, geo.d_pad, tile_k, row_offset,
            int(exclude_self), int(bf16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"knn_tile kernel launch failed: CUDA error {err}")
    if bf16:
        KNN_TILE_BF16_LAUNCHES += 1
    else:
        KNN_TILE_F32_LAUNCHES += 1
    return d_out, i_out


def rescore_chunk(cand: int, d: int) -> int:
    """Query rows per chunk of the exact re-score: at most 512, and at most
    2**26 gathered elements (256 MB in f32) per chunk at any D."""
    return max(1, min(512, (1 << 26) // max(1, cand * d)))


def knn_tiled(
    queries: torch.Tensor,
    references: torch.Tensor,
    k: int,
    *,
    exclude_self: bool = False,
    bf16: bool = False,
    row_block: int = 8192,
    col_block: int | None = None,
    cand: int | None = None,
    row_offset: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN through the tile kernel (``knn_pallas``'s contract):
    ((Q, k) ascending Euclidean distances, (Q, k) int32 ids).

    Both axes are blocked, as ``knn_streamed`` blocks them
    (multimodal_umap_tpu/ops/knn_stream.py:133-217): each ``row_block``
    of queries meets the references ``col_block`` columns (default
    :data:`COL_BLOCK`) at a time, one kernel launch per chunk, and each
    chunk's candidates merge into the block's running best, so the
    candidate buffers are those of one (row_block, col_block) chunk
    whatever N is. A chunk's ids are offset by its first column, and its
    self column sits at ``row_offset + s - c0`` (negative for a chunk
    past the block). ``row_offset`` is query row 0's self column among
    ``references`` (0 in fit; a ring step's shard pair sets it). With
    one chunk (N <= ``col_block``) the merge is the unstreamed one, op
    for op.

    bf16: the per-tile width (:func:`bf16_tile_k`) absorbs in-tile bf16
    misranking, the running global top-``cand`` (default max(4k, 64))
    absorbs cross-tile misranking; both are re-scored away in exact f32
    once per row block. f32 mode keeps a running top-k.

    Inputs go to the kernel in its mode's dtype without an f32 copy: a
    bf16-stored table as it is, an f32 one cast (bf16 mode) for ranking
    only. The re-score reads the inputs as given, up-casting the gathered
    rows per chunk, so distances are exact w.r.t. the stored values (an
    f32 query against a bf16 table keeps its f32 values). One table
    passed as both ``queries`` and ``references`` (fit) is cast, padded
    and normed once.
    """
    from .knn import _exact_rescore_sq

    col_block = COL_BLOCK if col_block is None else col_block
    if col_block <= 0 or col_block % TILE_C:
        raise ValueError(f"col_block={col_block} must be a positive "
                         f"multiple of {TILE_C}")
    same = queries is references
    num_q, num_r = queries.shape[0], references.shape[0]
    if k > num_r - (1 if exclude_self else 0):
        raise ValueError(f"k={k} exceeds available references ({num_r})")
    if bf16:
        tile_k = bf16_tile_k(k, num_r - (1 if exclude_self else 0))
        cand = max(4 * k, 64) if cand is None else cand
    else:
        tile_k = k
        cand = k
    if tile_k > TILE_C:
        raise ValueError(f"k={k} exceeds the kernel's tile width {TILE_C}")
    dtype = torch.bfloat16 if bf16 else torch.float32
    rw = references.to(dtype).contiguous()  # no copy when already dtype
    qw = rw if same else queries.to(dtype).contiguous()
    q_sq = r_sq = None
    if qw.is_cuda:  # padded (and in bf16 mode normed) once, not per block
        d_pad = launch_geometry(num_q, num_r, qw.shape[1], bf16).d_pad
        rw = _pad_d(rw, d_pad)
        qw = rw if same else _pad_d(qw, d_pad)
        if bf16:
            r_sq = row_norms_sq(rw)
            q_sq = r_sq if same else row_norms_sq(qw)

    d_parts, i_parts = [], []
    for s in range(0, num_q, row_block):
        e = min(s + row_block, num_q)
        nq = e - s
        best_d = best_i = None
        for c0 in range(0, num_r, col_block):
            c1 = min(c0 + col_block, num_r)
            # A contiguous row slice of the padded table: 16-byte aligned.
            d_c, i_c = knn_tile(
                qw[s:e], rw[c0:c1], tile_k, exclude_self=exclude_self,
                row_offset=row_offset + s - c0,
                q_sq=None if q_sq is None else q_sq[s:e],
                r_sq=None if r_sq is None else r_sq[c0:c1])
            width = d_c.shape[0] * tile_k
            cand_d = d_c.permute(1, 0, 2).reshape(nq, width)
            cand_i = i_c.permute(1, 0, 2).reshape(nq, width)
            del d_c, i_c
            vals, pos = torch.topk(cand_d, min(cand, width), dim=1,
                                   largest=False)
            ids = cand_i.gather(1, pos)
            del cand_d, cand_i  # freed before the next chunk's launch
            if c0:
                ids += c0
            if best_d is not None:
                # merge into the running best, as knn_stream._merge_topk
                vals = torch.cat([best_d, vals], 1)
                ids = torch.cat([best_i, ids], 1)
                vals, pos = torch.topk(vals, min(cand, vals.shape[1]),
                                       dim=1, largest=False)
                ids = ids.gather(1, pos)
            best_d, best_i = vals, ids
        if not bf16:
            vals, ids = best_d, best_i
        else:
            ids_c = best_i
            d2 = _exact_rescore_sq(
                queries[s:e], references, ids_c.clamp(0, num_r - 1),
                chunk=min(rescore_chunk(ids_c.shape[1], queries.shape[1]), nq))
            # Exhausted tiles emit +inf entries whose ids can point at
            # padded or self columns; the re-score recomputes finite
            # distances from ids, so the masks are re-applied here.
            invalid = ids_c >= num_r
            if exclude_self:
                rows = torch.arange(s + row_offset, e + row_offset,
                                    device=ids_c.device)[:, None]
                invalid |= ids_c == rows
            d2 = d2.masked_fill(invalid, float("inf"))
            vals, sel = torch.topk(d2, k, dim=1, largest=False)
            ids = ids_c.gather(1, sel)
        d_parts.append(vals.clamp_min(0.0).sqrt())
        i_parts.append(ids)
    return torch.cat(d_parts), torch.cat(i_parts)
