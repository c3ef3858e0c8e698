"""The frozen operation and byte counts at the two cells' shapes, worked
out by hand."""

from perfbench import harness

METRICS = harness.load_metrics()


def test_fit_flops_at_both_cells():
    f = METRICS["fit_mfu_pct"].fit_flops
    # flickr30k: kNN 2 * 31783^2 * (768 + 4096) = 9,826,827,617,792
    # (31783^2 = 1,010,159,089); an epoch: attraction 2 * 31783 * 15 * 192
    # = 183,070,080, repulsion 2 * 31783 * 8 * 192 = 97,637,376, InfoNCE
    # 2 * 31783 * 10 * 128 = 81,364,480; x3 = 1,086,215,808; x600 =
    # 651,729,484,800.
    assert f(31783, [768, 4096], 15, 64, 8, 8, 600) == (
        9_826_827_617_792 + 651_729_484_800)
    # coco2017: kNN 2 * 118287^2 * 4864 = 136,112,370,181,632 (118287^2 =
    # 13,991,814,369); an epoch x3: 3 * 118287 * (2*15*192 + 2*8*192 +
    # 2*10*128) = 3 * 118287 * 11,392 = 4,042,576,512; x600.
    assert f(118287, [768, 4096], 15, 64, 8, 8, 600) == (
        136_112_370_181_632 + 600 * 4_042_576_512)


def test_knn_panel_flops():
    f = METRICS["knn_tile_roofline_pct.fit"].panel_flops
    assert f(31783, [768, 4096]) == 9_826_827_617_792
    assert f(118287, [768, 4096]) == 136_112_370_181_632


def test_layout_term_bytes():
    f = METRICS["layout_terms_roofline_pct.fit"].term_bytes
    # N = 31783, k = 15, D = 64, 8 rounds: table 8,136,448; ids = coef =
    # 1,906,980. attr fwd 8,136,448 + 2 * 1,906,980 + 127,132 =
    # 12,077,540; attr bwd 2 * 8,136,448 + 3 * 1,906,980 + 127,136 + 4 =
    # 22,120,976; rep fwd 8,136,448 + 254,264 + 64 + 254,264 = 8,645,040;
    # rep bwd 2 * 8,136,448 + 508,528 + 64 + 127,132 + 4 = 16,908,624.
    assert f(31783, 15, 64, 8) == 59_752_180
    # coco2017 (N = 118287): table 30,281,472, ids 7,097,220.
    assert f(118287, 15, 64, 8) == (
        (30_281_472 + 2 * 7_097_220 + 4 * 118287)
        + (2 * 30_281_472 + 3 * 7_097_220 + 4 * 118288 + 4)
        + (30_281_472 + 16 * 118287 + 64)
        + (2 * 30_281_472 + 20 * 118287 + 64 + 4))


def test_roofline_and_mfu_read_the_fit():
    """The readers divide those counts by the kernels' device time and the
    fit's wall time, at the published peaks."""
    from perfbench.tests.test_perfbench_trace import view_of

    view = view_of([("knn_tile_bf16_kernel", 0, 10_000_000_000),
                    ("fit_attr_fwd_kernel<16, 4>", 10_000_000_000,
                     11_000_000_000)], seconds=20.0)
    knn = METRICS["knn_tile_roofline_pct.fit"].read(view)
    assert abs(knn - 100 * 9_826_827_617_792 / 989e12 / 10.0) < 1e-9
    terms = METRICS["layout_terms_roofline_pct.fit"].read(view)
    assert abs(terms - 100 * 600 * 2 * 59_752_180 / 3.35e12 / 1.0) < 1e-9
    mfu = METRICS["fit_mfu_pct"].read(view)
    assert abs(mfu - 100 * (9_826_827_617_792 + 651_729_484_800)
               / 20.0 / 989e12) < 1e-9
