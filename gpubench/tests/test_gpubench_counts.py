"""The frozen operation and byte counts against hand-computed values at two
shapes each."""

from __future__ import annotations

import pytest

from gpubench import harness

MSVD = harness.config("msvd")["model"]
MSVD_DECODE = harness.config("msvd")["decode"]
SMALL = dict(n_frames=2, ctx_dim=4, dim=3, dim_word=2, n_words=5,
             use_spatial=True, n_regions=2, region_dim=3,
             compute_dtype="bfloat16")
SMALL_DECODE = dict(decode_batch=2, beam_size=2, maxlen=3)


def metric(name):
    return harness.load_module("metrics", name)


def test_bound_takes_the_larger_side():
    assert harness.bound_s(3.35e12, 0, "bf16") == pytest.approx(1.0)
    assert harness.bound_s(0, 989e12, "bf16") == pytest.approx(1.0)
    assert harness.bound_s(3.35e9, 67e12, "f32") == pytest.approx(1.0)


def test_decode_flops_by_hand():
    m = metric("decode_mfu")
    # SMALL: h-proj 2*3*(4+1+3) = 48; spatial core 2*2*(12+6) = 72; fused
    # context and its pctx 2*2*3*4 * 2 = 96; temporal 4*2*4 + 2*2*4 = 48;
    # gates 2*(2+3+4)*12 = 216; logits 2*3*2 + 2*4*2 + 2*2*5 = 48
    assert m.row_step_flops(SMALL) == 48 + 72 + 96 + 48 + 216 + 48
    # a video: pctx 2*2*16 = 64, h0 c0 2*4*3*2 = 48, pregion 2*2*2*9 = 72
    assert m.video_flops(SMALL) == 64 + 48 + 72
    assert m.request_flops(SMALL, SMALL_DECODE, 2) == 2 * 184 + 4 * 3 * 528
    # MSVD: the gates product alone 2 * 5010 * 14072 a row step
    gates = 2 * (468 + 3518 + 1024) * 4 * 3518
    assert gates == 141_001_440
    row = m.row_step_flops(MSVD)
    assert row == (2 * 3518 * (1024 + 1 + 1024) + 28 * 49 * (4096 + 2048)
                   + 2 * 28 * 1024 * 1024 * 2 + 4 * 28 * 1024
                   + 2 * 28 * 1024 + gates + 2 * 3518 * 468 + 2 * 1024 * 468
                   + 2 * 468 * 13010)
    req = m.request_flops(MSVD, MSVD_DECODE, 256)
    assert 12.0e12 < req < 12.5e12


def test_train_flops_by_hand():
    m = metric("train_mfu")
    # SMALL, one step: input proj 2*2*12 = 48, h-proj 2*3*(12+4+1+3) = 120,
    # spatial 2*2*18 + 2*2*3*8 = 168, temporal 32 + 16 + ctx@Wc 96,
    # logits 48: forward 528, times 3; data products 2*(64 + 48 + 72)
    assert m.caption_flops(SMALL, 1) == 3 * 528 + 2 * 184
    assert m.caption_flops(SMALL, 2) == 6 * 528 + 2 * 184


def test_roofline_bounds_by_hand():
    d = dict(decode_batch=256, beam_size=5)
    sc = metric("spatial_core_roofline").bound_s(MSVD, d)
    bs = 1280
    n_bytes = (4 * bs * 1024 + 4 * 256 * 28 * 49 * 1024
               + 2 * 256 * 28 * 49 * 1024 + 4 * 1024
               + bs * 28 * (2 * 1024 + 4 * 49))
    assert sc == pytest.approx(n_bytes / 3.35e12)          # bytes-bound
    tail = metric("logit_tail_roofline").bound_s(MSVD, d)
    assert tail == pytest.approx(2 * 1280 * 468 * 13010 / 989e12)
    small = metric("logit_tail_roofline").bound_s(
        dict(dim_word=2, n_words=5), dict(decode_batch=1, beam_size=2))
    assert small == pytest.approx(
        max((2 * 2 * 2 + 2 * 2 * 5 + 4 * 5 + 2 * (2 * 12 + 4)) / 3.35e12,
            2 * 2 * 2 * 5 / 989e12))
    bwd = metric("spatial_bwd_roofline").bound_s(MSVD, 256)
    b, k, r, s = 256, 28, 49, 1024
    n_bytes = (4 * b * s + b * k * r * 2 * s * 2
               + 4 * (2 * b * k * r + b * k * s + s) + 2 * b * k * r * s * 2
               + 4 * (b * s + s + b * k * r) + b * k * s * 2)
    assert bwd == pytest.approx(max(n_bytes / 3.35e12,
                                    b * k * r * 13 * s / 67e12))
