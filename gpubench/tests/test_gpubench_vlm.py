"""The video-language cell (``kimivl.serve.bank``): its operation and byte
counts by hand, its expert readers on known counts, and its driver on the
CPU at a tiny float32 size: the reference agrees with the program, a
traced run reads every per-layer metric the cell lists, and each planted
fault and the float8 control read not correct (against limits for this
size and precision)."""

from __future__ import annotations

import json

import pytest

from conftest import measure
from gpubench import harness, run

CELL = "kimivl.serve.bank"
FULL = harness.config("kimi_vl_a3b")
TINY_VLM = dict(vocab_size=97, hidden_size=64, intermediate_size=80,
                moe_intermediate_size=24, num_hidden_layers=3,
                num_attention_heads=4, num_key_value_heads=4,
                n_shared_experts=1, n_routed_experts=8,
                num_experts_per_tok=2, kv_lora_rank=32, qk_rope_head_dim=8,
                qk_nope_head_dim=16, v_head_dim=16)


TINY_LIMITS = {"mean_score_gap": 1e-3}


def metric(name):
    return harness.load_module("metrics", name)


@pytest.fixture
def vlm(tiny):
    """The benchmark's files at a tiny size, the video-language
    configuration cut to TINY_VLM's widths."""
    path = tiny / "configs" / "kimi_vl_a3b.json"
    c = json.loads(path.read_text())
    c.update(TINY_VLM)
    c["model"].update(compute_dtype="float32", prompt_before=[90, 91, 92],
                      prompt_after=[93, 94])
    c["decode"].update(beam_size=3, maxlen=8, decode_batch=4)
    # the configuration's rule for the residual branches, 1/sqrt(2 x layers)
    c["init"]["branch_scale"] = (2 * TINY_VLM["num_hidden_layers"]) ** -0.5
    c["dataset"].update(test_videos=10, frames_per_video=2,
                        tokens_per_frame=3)
    path.write_text(json.dumps(c))
    path = tiny / "traffic" / "serve_bank_vlm.json"
    t = json.loads(path.read_text())
    t.update(request_videos=4, check_videos=4, warmup_requests=1,
             trace_seconds=0.3, calibration_videos=8)
    path.write_text(json.dumps(t))
    # float32 at this size: the program reads ~1e-6, so the copy's limits
    # are its own (the card's are set for bf16 at the full widths)
    (tiny / "limits" / f"{CELL}.json").write_text(json.dumps(TINY_LIMITS))
    return tiny


def test_the_configuration_is_the_catalog_row():
    m = FULL
    assert m["reduced"] == [] and m["num_hidden_layers"] == 27
    assert (m["n_routed_experts"], m["num_experts_per_tok"]) == (64, 6)
    assert m["vocab_size"] == 163840 and m["kv_lora_rank"] == 512
    assert len(m["model"]["prompt_before"]) == len(
        m["model"]["prompt_after"]) == 8


def test_vlm_flops_by_hand():
    f = metric("vlm_mfu")
    small = dict(hidden_size=2, num_hidden_layers=2, first_k_dense_replace=1,
                 intermediate_size=3, moe_intermediate_size=1,
                 n_routed_experts=4, num_experts_per_tok=2,
                 n_shared_experts=1, num_attention_heads=1, kv_lora_rank=2,
                 qk_nope_head_dim=1, qk_rope_head_dim=1, v_head_dim=1,
                 vocab_size=5,
                 model={"prompt_before": [7], "prompt_after": []},
                 dataset={"frames_per_video": 1, "tokens_per_frame": 2},
                 decode={"beam_size": 2, "maxlen": 2})
    # MLP: dense 6*2*3 = 36; MoE router 2*2*4 = 16, 2 experts 2*6*2*1 =
    # 24, shared 6*2*1 = 12
    assert f.mlp_flops(small) == 36 + 16 + 24 + 12
    # projections: q 2*2*1*2 = 8, latent 2*2*3 = 12, out 2*1*1*2 = 4;
    # prefill kv_b 2*2*1*2 = 8, absorbed W_UK 2*1*1*2 = 4 and W_UV 4
    assert f.proj_flops(small, False) == 8 + 12 + 4 + 8
    assert f.proj_flops(small, True) == 8 + 12 + 4 + 4 + 4
    # prompt 3 tokens, prefill 2: attention 2*1*3*(2*3/2) = 18 a layer
    assert f.prefill_flops(small) == 2 * (88 + 2 * 32) + 2 * 18
    # step t over 3 + t positions: 2*1*3*(3+t) + 2*1*2*(3+t) a layer
    assert f.step_flops(small, 0) == 88 + 2 * (32 + 30) + 2 * 2 * 5
    assert f.request_flops(small, 3) == 3 * (
        f.prefill_flops(small) + 2 * (f.step_flops(small, 0)
                                      + f.step_flops(small, 1)))
    # the full model: a 16-video request's prefill is ~137 TFLOP (the
    # 15.96 B parameters, 2.24 B active a token)
    pre = 16 * f.prefill_flops(FULL)
    assert 1.30e14 < pre < 1.45e14
    # its 2400 beam-row steps, each ~4.5 GFLOP of weights, 0.67 of head
    # and ~1.7 of attention over ~1820 cached positions
    steps = f.request_flops(FULL, 16) - pre
    assert 1.5e13 < steps < 1.8e13


def test_expert_roofline_bound_by_hand():
    f = metric("expert_gemm_roofline")
    c = dict(hidden_size=2048, moe_intermediate_size=1408)
    # a decode call: 480 rows, all 64 experts touched: weights 64 * 3 *
    # 2048 * 1408 * 2 bytes = 1.107 GB, rows 480 * (2048 + 2816 + 1408 +
    # 2048) * 2 = 7.99 MB; by bytes
    n_bytes = 64 * 3 * 2048 * 1408 * 2 + 480 * 8320 * 2
    assert f.bound_s(c, 480, 64) == pytest.approx(n_bytes / 3.35e12)
    # a prefill call: 173472 rows, by operations
    ops = 2 * 173472 * 3 * 2048 * 1408
    assert f.bound_s(c, 173472, 64) == pytest.approx(ops / 989e12)


def test_expert_readers_on_known_counts():
    trace = harness.Trace(0.0, 1e6, [
        ("cutlass_GroupProblemShape_gemm", 0.0, 2000.0),
        ("void at::cuda::detail::prepare_grouped_gemm_data<x>", 0.0, 500.0),
        ("other", 0.0, 9000.0)], [], {
        "expert_rows": [[[4, 0, 2, 2], [1, 1, 1, 1]],
                        [[0, 0, 0, 0], [3, 1, 0, 0]]],
        "expert_touched": [[3, 4], [0, 2]]})
    r = harness.Readings(cell={}, config=dict(hidden_size=2,
                                              moe_intermediate_size=1),
                         traffic={}, trace=trace)
    # layer 0: rows 4, 0, 2, 2 (max 4 over mean 2); layer 1: 4, 2, 1, 1
    assert metric("expert_load_max").read(r) == pytest.approx(2.0)
    f = metric("expert_gemm_roofline")
    least = (f.bound_s(r.config, 8, 3) + f.bound_s(r.config, 4, 4)
             + f.bound_s(r.config, 4, 2))
    assert f.read(r) == pytest.approx(100 * least / 2.5e-3)
    empty = harness.Readings(cell={}, config={}, traffic={})
    assert f.read(empty) is None and metric("expert_load_max").read(
        empty) is None


def test_tiny_cell_is_correct_and_reads_its_metrics(vlm):
    r, metrics, correct = measure(vlm, CELL, trace=True)
    assert correct, r.compared
    assert all(c["value"] < 1e-4 for c in r.compared.values())
    want = {m["name"] for m in harness.metrics_of(harness.benchmark(), CELL,
                                                  "per_layer")}
    # the CPU run has no device trace and no CUDA graphs: no kernel, so
    # no idle share and no roofline, and no step replays
    assert want - set(metrics) <= {"idle_share.serve",
                                   "expert_gemm_roofline",
                                   "decode_graph_share"}
    assert metrics["decode_host_ms_per_step"]["value"] > 0
    assert metrics["expert_load_max"]["value"] >= 1.0
    assert metrics["vlm_mfu"]["value"] > 0
    r, metrics, correct = measure(vlm, CELL)
    assert correct and metrics["captions_per_s"]["value"] > 0


def test_tiny_faults_and_control_are_not_correct(vlm):
    """The calibration's sides at a tiny size: the program within the
    tiny copy's limits, every planted fault and the float8 control beyond
    one of them."""
    ctx = run.Context(harness.cell(harness.benchmark(), CELL), 0, 0.0,
                      False, device="cpu", here=vlm)
    driver = harness.load_module("drivers", "serve_bank_vlm")
    rows = driver.calibrate(ctx, [2**31 + 5], [2**31 + 5])
    limits = harness.limits(CELL, vlm)
    sides = {r["side"]: r for r in rows}
    assert set(sides) == {"program", "float8", *driver.FAULTS}
    for side, r in sides.items():
        over = [k for k in limits if r[k] > limits[k]]
        assert bool(over) == (side != "program"), (side, r)
