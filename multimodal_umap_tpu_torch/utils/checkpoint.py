"""Checkpointing: full-model state as a single .npz archive.

Counterpart of ``multimodal_umap_tpu/utils/checkpoint.py`` with the same
schema, so either package reads what the other writes: a ``meta`` JSON
(schema 1: hyperparameters, (a, b), spectral method, kNN engine, graph
shapes, ``bf16_keys``) plus, per modality i, ``sigmas_i``, ``rhos_i``,
``data_i``, ``embeds_i`` and ``graph_i_{rows,cols,weights,valid}``. The
training data is stored, as in the reference, because transform and
invert query it. bf16-stored tables are written as their uint16 bit
patterns and listed in ``bf16_keys``, and restored as bfloat16 on load
(the JAX package's encoding, since npz has no bfloat16).

Also the fit graph-stage cache (``save_graph_cache`` /
``load_graph_cache``) and the feature fingerprint that keys it. Every
file is written to a ``.tmp`` sibling and moved into place with
``os.replace``, so a reader never sees a half-written archive.
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np
import torch

from ..ops.graph import DenseSymGraph, EdgeGraph

_SCHEMA_VERSION = 1
_SCALARS = ("a", "b", "k_neighbors", "out_dim", "min_dist", "num_encoders")


def _np(x) -> np.ndarray:
    """A host numpy copy; a bfloat16 tensor comes back as its uint16 bit
    patterns (numpy has no bfloat16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).cpu().numpy().view(np.uint16)
        return x.cpu().numpy()
    return np.asarray(x)


def _is_bf16(x) -> bool:
    """A bfloat16 tensor, or a numpy array of the ``ml_dtypes`` bfloat16
    type (what ``np.asarray`` of a JAX bf16 array gives)."""
    if isinstance(x, torch.Tensor):
        return x.dtype == torch.bfloat16
    return getattr(getattr(x, "dtype", None), "name", "") == "bfloat16"


def _bf16_from_bits(bits, device: torch.device) -> torch.Tensor:
    """A bfloat16 tensor on ``device`` from uint16 bit patterns (or from an
    ``ml_dtypes`` bfloat16 array, read as its bits)."""
    bits = np.require(bits, requirements=["C", "W"]).view(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16).to(device)


def write_npz(path: str, arrays: dict) -> None:
    """``np.savez`` of ``arrays`` (tensors, arrays or scalars) to exactly
    ``path`` (no suffix added), atomically through ``path + ".tmp"``."""
    dirname = os.path.dirname(path)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{k: _np(v) for k, v in arrays.items()})
    os.replace(tmp, path)


def save_state(path: str, state: dict) -> None:
    """Serializes a mixture-model state dict to ``path`` (npz).

    Expected keys: k_neighbors, out_dim, min_dist, num_encoders, a, b,
    spectral_method, knn_engine, and per-modality lists sigmas, rhos,
    data, graphs (:class:`EdgeGraph`) and embeds (tensors or arrays).
    """
    meta = {
        "schema": _SCHEMA_VERSION,
        "k_neighbors": int(state["k_neighbors"]),
        "out_dim": int(state["out_dim"]),
        "min_dist": float(state["min_dist"]),
        "num_encoders": int(state["num_encoders"]),
        "a": float(state["a"]),
        "b": float(state["b"]),
        "spectral_method": str(state.get("spectral_method", "auto")),
        "knn_engine": str(state.get("knn_engine") or ""),
        "graph_shapes": [[g.num_rows, g.num_cols] for g in state["graphs"]],
    }
    arrays = {}
    for i in range(meta["num_encoders"]):
        for key in ("sigmas", "rhos", "data", "embeds"):
            arrays[f"{key}_{i}"] = state[key][i]
        for f in ("rows", "cols", "weights", "valid"):
            arrays[f"graph_{i}_{f}"] = getattr(state["graphs"][i], f)
    meta["bf16_keys"] = [k for k, v in arrays.items() if _is_bf16(v)]
    write_npz(path, {"meta": json.dumps(meta), **arrays})


def state_from_arrays(arrays, device: torch.device) -> dict:
    """The state dict of :func:`save_state` from its flat arrays (an
    opened archive, or any mapping with the archive's key names; scalars
    come from its ``meta`` JSON or from keys of their own), with every
    array a tensor on ``device``. Feature tables keep their storage
    dtype: the keys in ``meta["bf16_keys"]`` (uint16 bit patterns) and
    bfloat16 arrays come back as bfloat16, everything else as float32."""
    scalars = {k: arrays[k] for k in _SCALARS if k in arrays}
    meta = {}
    if "meta" in arrays:
        meta = json.loads(str(arrays["meta"]))
        scalars.update({k: meta[k] for k in _SCALARS if k in meta})
    bf16_keys = set(meta.get("bf16_keys", ()))
    n = int(scalars["num_encoders"])

    def t(key, dtype):
        a = arrays[key]
        if key in bf16_keys or _is_bf16(a):
            return _bf16_from_bits(a, device)
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    state = {
        "k_neighbors": int(scalars["k_neighbors"]),
        "out_dim": int(scalars["out_dim"]),
        "min_dist": float(scalars["min_dist"]),
        "num_encoders": n,
        "a": float(scalars["a"]),
        "b": float(scalars["b"]),
        # Absent in schema-1 archives written before the knobs.
        "spectral_method": str(meta.get("spectral_method") or "auto"),
        "knn_engine": meta.get("knn_engine") or None,
        "sigmas": [], "rhos": [], "data": [], "embeds": [], "graphs": [],
    }
    for i in range(n):
        for key in ("sigmas", "rhos", "data", "embeds"):
            state[key].append(t(f"{key}_{i}", torch.float32))
        rows = state["data"][-1].shape[0]
        num_rows, num_cols = meta.get("graph_shapes", [[rows, rows]] * n)[i]
        state["graphs"].append(EdgeGraph(
            rows=t(f"graph_{i}_rows", torch.int32),
            cols=t(f"graph_{i}_cols", torch.int32),
            weights=t(f"graph_{i}_weights", torch.float32),
            valid=t(f"graph_{i}_valid", torch.bool),
            num_rows=int(num_rows), num_cols=int(num_cols)))
    return state


def load_state(path: str, device: torch.device) -> dict:
    """Loads a state dict saved by :func:`save_state` (or by the JAX
    package's ``save_state``) onto ``device``."""
    with np.load(path, allow_pickle=False) as z:
        return state_from_arrays(z, device)


def feature_fingerprint(feats, dtype: torch.dtype | None = None) -> int:
    """Content guard for the graph cache: CRC over a strided sample of up
    to 64 rows (always the first and last) plus the table shape. The
    same bytes give the JAX package's fingerprint (a bf16 table's bytes
    are its 2-byte bit patterns in both). ``dtype``: the rows are cast to
    it first (the storage dtype of a table given in another)."""
    n = int(feats.shape[0])
    idx = sorted({0, n - 1, *range(0, n, -(-n // 62))})
    rows = feats[idx]
    if dtype is not None:
        rows = torch.as_tensor(rows).to(dtype)
    rows = np.ascontiguousarray(_np(rows))  # one gather + readback
    crc = zlib.crc32(rows.tobytes())
    shape = ",".join(str(s) for s in feats.shape)
    return zlib.crc32(shape.encode(), crc)


def save_graph_cache(path: str, *, k_neighbors: int, out_dim: int,
                     spectral_method: str, graphs, denses, inits,
                     sigmas, rhos, fingerprints) -> None:
    """Snapshot of fit's graph stage (kNN + fuzzy weights +
    symmetrization + spectral init), so a rerun on the same features
    skips it."""
    m = len(graphs)
    meta = {
        "schema": _SCHEMA_VERSION,
        "kind": "graph_cache",
        "k_neighbors": int(k_neighbors),
        "out_dim": int(out_dim),
        "spectral_method": str(spectral_method),
        "num_encoders": m,
        "graph_shapes": [[g.num_rows, g.num_cols] for g in graphs],
        "fingerprints": [int(f) for f in fingerprints],
    }
    arrays = {"meta": json.dumps(meta)}
    for i in range(m):
        for f in ("rows", "cols", "weights", "valid"):
            arrays[f"graph_{i}_{f}"] = getattr(graphs[i], f)
        for f in ("nbrs", "weights", "bwd_valid"):
            arrays[f"dense_{i}_{f}"] = getattr(denses[i], f)
        arrays[f"init_{i}"] = inits[i]
        arrays[f"sigmas_{i}"] = sigmas[i]
        arrays[f"rhos_{i}"] = rhos[i]
    write_npz(path, arrays)


def load_graph_cache(path: str, *, k_neighbors: int, out_dim: int,
                     spectral_method: str, fingerprints,
                     device: torch.device) -> dict | None:
    """Loads a :func:`save_graph_cache` snapshot onto ``device``, or None
    when the file is absent or was written for other features or
    hyperparameters (the caller then rebuilds and overwrites)."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if (meta.get("kind") != "graph_cache"
                or meta["k_neighbors"] != int(k_neighbors)
                or meta["out_dim"] != int(out_dim)
                # init_i is one spectral method's output: another method
                # rebuilds.
                or meta.get("spectral_method") != str(spectral_method)
                or meta["fingerprints"] != [int(f) for f in fingerprints]):
            return None

        def t(key):
            return torch.as_tensor(z[key], device=device)

        out = {"graphs": [], "denses": [], "inits": [], "sigmas": [],
               "rhos": []}
        for i in range(meta["num_encoders"]):
            num_rows, num_cols = meta["graph_shapes"][i]
            out["graphs"].append(EdgeGraph(
                rows=t(f"graph_{i}_rows"), cols=t(f"graph_{i}_cols"),
                weights=t(f"graph_{i}_weights"), valid=t(f"graph_{i}_valid"),
                num_rows=int(num_rows), num_cols=int(num_cols)))
            out["denses"].append(DenseSymGraph(
                nbrs=t(f"dense_{i}_nbrs"), weights=t(f"dense_{i}_weights"),
                bwd_valid=t(f"dense_{i}_bwd_valid"), num_rows=int(num_rows)))
            out["inits"].append(t(f"init_{i}"))
            out["sigmas"].append(t(f"sigmas_{i}"))
            out["rhos"].append(t(f"rhos_{i}"))
    return out
