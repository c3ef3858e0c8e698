"""PyTorch port: the tile kernel's plain version at the kernel's edge
cases, the launch-geometry helper, the f32 mode's TF32 split and its
three-pass panel, and chip_smoke.py's library yardstick, on the CPU.

The edge cases are chip_smoke.KERNEL_CASES, the ones the kernel is held
to on the card (tests/test_torch_cuda.py). Tolerances: the plain version
against a float64 numpy oracle within 1e-5 of the cancelled-term scale
(f32 expanded form), ids tie-aware; the yardstick against the plain
version exactly, on inputs in {-1, 0, 1} whose bf16 products and norms
are exact integers. The f32 mode's split is exact (hi + lo == x) and
its three-pass panel, products taken exactly in float64, stays within
1e-6 of the cancelled-term scale of a float64 panel: the split's error
budget, before the card's f32 accumulation (held at 1e-5 on the card).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import KERNEL_CASES, case_inputs, library_tile_topk  # noqa: E402

from multimodal_umap_tpu_torch.ops import knn_tile as KT  # noqa: E402

torch.set_num_threads(1)


def _assert_tie_aware(d_a, i_a, d_b, i_b, tol):
    """Rows of ascending squared distances agree within ``tol`` and their
    ids as sets, up to ids at the row's boundary value."""
    k = d_a.shape[-1]
    d_a, d_b = d_a.reshape(-1, k), d_b.reshape(-1, k)
    i_a, i_b = i_a.reshape(-1, k), i_b.reshape(-1, k)
    fin = np.isfinite(d_b)
    assert np.array_equal(np.isfinite(d_a), fin)
    assert np.all(np.abs(d_a - d_b)[fin] <= tol)
    in_b = (i_a[:, :, None] == i_b[:, None, :]).any(-1)
    edge = d_a[:, -1:]
    with np.errstate(invalid="ignore"):  # inf - inf at exhausted rows
        at_edge = (d_a == edge) | (np.abs(d_a - edge) <= tol)
    assert np.all(in_b | at_edge)


@pytest.mark.parametrize("case", KERNEL_CASES, ids=str)
def test_plain_tile_matches_float64_oracle(case):
    gen = torch.Generator().manual_seed(0)
    q, r, tk, ex, off = case_inputs(case, gen, "cpu", torch.float32)
    tk = KT.TILE_C if tk is None else tk
    d, i = KT.knn_tile_plain(q, r, tk, exclude_self=ex, row_offset=off)
    nq, n = q.shape[0], r.shape[0]
    nct = -(-n // KT.TILE_C)
    assert d.shape == i.shape == (nct, nq, tk) and i.dtype == torch.int32
    q64, r64 = q.double().numpy(), r.double().numpy()
    panel = ((q64[:, None, :] - r64[None, :, :]) ** 2).sum(-1)
    if ex:
        rows = np.arange(nq)
        ok = rows + off < n
        panel[rows[ok], rows[ok] + off] = np.inf
    panel = np.pad(panel, ((0, 0), (0, nct * KT.TILE_C - n)),
                   constant_values=np.inf).reshape(nq, nct, KT.TILE_C)
    order = np.argsort(panel, axis=2, kind="stable")[..., :tk]
    want_d = np.take_along_axis(panel, order, 2).transpose(1, 0, 2)
    want_i = (order + np.arange(nct)[None, :, None] * KT.TILE_C).transpose(
        1, 0, 2)
    scale = (q64 ** 2).sum(1).max() + (r64 ** 2).sum(1).max()
    _assert_tie_aware(d.numpy(), i.numpy(), want_d, want_i, 1e-5 * scale)
    dn = d.numpy()
    fin = np.isfinite(dn)
    assert np.all(np.diff(np.where(fin, dn, np.inf), axis=2)[fin[..., 1:]] >= 0)
    ids = i.numpy().reshape(-1, tk)
    assert all(len(set(row)) == tk for row in ids)  # each column once


@pytest.mark.parametrize("case", KERNEL_CASES, ids=str)
def test_library_yardstick_matches_plain(case):
    """chip_smoke.library_tile_topk computes the tile function: the same
    per-tile values and, up to ties at the boundary, the same ids."""
    q_n, n, d, tk, ex, off, dup = case
    rng = np.random.default_rng(7)
    r = rng.integers(-1, 2, size=(n, d)).astype(np.float32)
    if dup:
        r[1::2] = r[0::2][: n // 2]
    q = r[off:off + q_n] if ex else rng.integers(
        -1, 2, size=(q_n, d)).astype(np.float32)
    qb, rb = torch.from_numpy(q).bfloat16(), torch.from_numpy(r).bfloat16()
    tk = KT.TILE_C if tk is None else tk
    d_l, i_l = library_tile_topk(qb, rb, tk, KT.TILE_C, exclude_self=ex,
                                 row_offset=off)
    d_p, i_p = KT.knn_tile_plain(qb, rb, tk, exclude_self=ex, row_offset=off)
    _assert_tie_aware(d_l.permute(1, 0, 2).numpy(),
                      i_l.permute(1, 0, 2).numpy(), d_p.numpy(), i_p.numpy(),
                      0.0)


@pytest.mark.parametrize("nq,n,d,bf16,d_pad,blocks", [
    (8192, 31744, 4096, True, 4096, 64 * 124),
    (7168, 31744, 768, True, 768, 56 * 124),
    (1024, 31744, 4096, True, 4096, 8 * 124),
    (19, 187, 33, True, 64, 1),
    (257, 257, 8, True, 64, 3 * 2),
    (19, 187, 33, False, 48, 1),
    (130, 600, 17, False, 32, 3 * 3),
])
def test_launch_geometry(nq, n, d, bf16, d_pad, blocks):
    geo = KT.launch_geometry(nq, n, d, bf16)
    assert geo.d_pad == d_pad and geo.blocks == blocks
    assert geo.col_tiles == -(-n // KT.TILE_C)
    assert geo.d_pad % (KT.TILE_D if bf16 else KT.TILE_D_F32) == 0
    assert geo.smem_bytes <= 232_448  # Hopper's per-block limit
    if bf16:
        # TMA ring of 4 stages of (128 + 256) rows x 64 bf16
        assert (geo.threads, geo.block_rows, geo.stages) == (384, 128, 4)
        assert geo.smem_bytes >= 4 * (128 + KT.TILE_C) * KT.TILE_D * 2
    else:
        # TMA ring of 5 stages of (64 + 256) rows x 16 f32, hi and lo
        assert (geo.threads, geo.block_rows, geo.stages) == (384, 64, 5)
        assert geo.smem_bytes >= 5 * 2 * (64 + KT.TILE_C) * KT.TILE_D_F32 * 4


def test_plain_row_norms_and_wrapper_padding():
    """The norm pre-pass's plain version is |x|^2 of the values given
    (bf16-rounded in bf16 mode); zero padding of D changes no tile."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(30, 13)).astype(np.float32))
    xb = x.bfloat16()
    np.testing.assert_allclose(KT.row_norms_sq(xb).numpy(),
                               (xb.double() ** 2).sum(1).numpy(), rtol=1e-6)
    padded = KT._pad_d(x, 32)
    assert padded.shape == (30, 32) and padded.is_contiguous()
    d_a, i_a = KT.knn_tile(x, x, 6, exclude_self=True)
    d_b, i_b = KT.knn_tile(padded, padded, 6, exclude_self=True)
    assert torch.equal(i_a, i_b)
    torch.testing.assert_close(d_a, d_b, rtol=1e-6, atol=1e-5)


def _tf32_rna_np(x):
    """numpy cvt.rna.tf32.f32, from the bits: round the magnitude to 10
    explicit mantissa bits, ties away from zero."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    sign, mag = bits & 0x80000000, bits & 0x7FFFFFFF
    return (sign | ((mag + 0x1000) & 0xFFFFE000)).astype(np.uint32).view(
        np.float32)


def test_tf32_split_is_exact_and_rounds_to_nearest_away():
    rng = np.random.default_rng(9)
    x = np.concatenate([
        rng.normal(size=4000) * 10.0 ** rng.integers(-30, 30, size=4000),
        [0.0, -0.0, 1.0, -1.0, 3.4e38, -3.4e38, 1e-40, -1e-40],
    ]).astype(np.float32)
    # ties at half a TF32 ulp, both signs: away from zero
    x = np.concatenate([x, np.array([0x3F801000, 0xBF801000, 0x3F803000],
                                    dtype=np.uint32).view(np.float32)])
    hi, lo = KT.tf32_split_plain(torch.from_numpy(x))
    hi, lo = hi.numpy(), lo.numpy()
    assert np.array_equal(hi + lo, x)  # exact in f32
    assert np.all(hi.view(np.uint32) & 0x1FFF == 0)
    assert np.array_equal(hi, _tf32_rna_np(x))
    # half a TF32 ulp (absolute below the normal range)
    assert np.all(np.abs(lo) <= np.maximum(np.abs(x), 2.0 ** -126) * 2.0 ** -11)
    assert hi[-3] == np.float32(1.0) + np.float32(2.0 ** -10)
    assert hi[-2] == -hi[-3]
    assert hi[-1] == np.float32(1.0) + np.float32(2.0 ** -9)


@pytest.mark.parametrize("d", [64, 768, 4096])
def test_three_pass_tf32_panel_within_split_budget(d):
    """The f32 mode's products, emulated: hi_q.hi_r + hi_q.tf32(lo_r) +
    tf32(lo_q).hi_r, each taken exactly in float64, against the float64
    panel, on every KERNEL_CASES input at D = d."""
    for case in KERNEL_CASES:
        gen = torch.Generator().manual_seed(0)
        q, r, _, _, _ = case_inputs((*case[:2], d, *case[3:]), gen, "cpu",
                                    torch.float32)
        parts = []
        for x in (q, r):
            hi, lo = KT.tf32_split_plain(x)
            parts.append((hi.double().numpy(),
                          _tf32_rna_np(lo.numpy()).astype(np.float64)))
        (qh, ql), (rh, rl) = parts
        q64, r64 = q.double().numpy(), r.double().numpy()
        q_sq, r_sq = (q64 ** 2).sum(1), (r64 ** 2).sum(1)
        dot3 = ql @ rh.T + qh @ rl.T + qh @ rh.T
        panel3 = np.maximum(-2.0 * dot3 + q_sq[:, None] + r_sq[None, :], 0.0)
        exact = np.maximum(-2.0 * (q64 @ r64.T) + q_sq[:, None]
                           + r_sq[None, :], 0.0)
        scale = q_sq.max() + r_sq.max()
        err = np.abs(panel3 - exact).max() / scale
        assert err <= 1e-6, (case, err)
