"""Kimi-VL-A3B's language model as a captioner (``model/kimi_vl.py``,
``model/mla.py``, ``model/moe.py``, ``kimi_api.py``) on the CPU at a tiny
size, float32, against the plain reference (``gpubench/reference/
kimi_vl.py``, copied to ``tools/kimi_vl_reference.py``): the prefill and
the decode through the caches give the reference's full-forward
log-probabilities; the absorbed decode equals the expanded attention; the
grouped expert products equal the loop; the router chooses, normalises
and scales as worked by hand; the beam decode gives the reference's beam
search; the beams' suffix caches are reordered and the prefix cache is
one per video; the two copies of the reference agree."""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench.reference import kimi_vl as ref
from stvd_torch.config import DecodeConfig
from stvd_torch.data.bank import FeatureBank
from stvd_torch.data.text import EOS_ID, Vocab
from stvd_torch.decode.beam import beam_decode
from stvd_torch.kimi_api import KimiCaptioner
from stvd_torch.model import kimi_vl, mla, moe
from stvd_torch.model.kimi_config import KimiServeConfig, KimiVLConfig

ROOT = Path(__file__).resolve().parents[1]

TINY = dict(vocab_size=97, hidden_size=64, intermediate_size=80,
            moe_intermediate_size=24, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=4,
            n_shared_experts=1, n_routed_experts=8, num_experts_per_tok=2,
            kv_lora_rank=32, qk_rope_head_dim=8, qk_nope_head_dim=16,
            v_head_dim=16, rope_theta=10000.0, compute_dtype="float32",
            prompt_before=(5, 6, 7), prompt_after=(8, 9))
N_VISUAL = 6


def tiny_cfg(**kw) -> KimiVLConfig:
    return KimiVLConfig.from_dict({**TINY, **kw})


def tiny_params(cfg: KimiVLConfig, seed: int = 0, device="cpu") -> dict:
    """Published names, unit-scale activations: weights 1/sqrt(fan-in),
    norms near 1, a correction bias that changes choices, logits of a
    few units."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape in kimi_vl.param_shapes(cfg).items():
        x = torch.randn(shape, generator=g, device=device)
        if name.endswith("norm.weight"):
            x = 1.0 + 0.1 * x
        elif name.endswith("e_score_correction_bias"):
            x = 0.3 * x
        elif name == "lm_head.weight":
            x = x * 3.0 / math.sqrt(shape[1])
        elif name != "model.embed_tokens.weight":
            x = x / math.sqrt(shape[1])
        out[name] = x
    return out


def visual(b: int, cfg: KimiVLConfig, seed: int = 1, padded: bool = True):
    g = torch.Generator().manual_seed(seed)
    frames = torch.randn((b, N_VISUAL, cfg.hidden_size), generator=g)
    mask = torch.ones((b, N_VISUAL))
    if padded:
        mask[1, -2:] = 0.0
    return frames, mask


def ref_model(cfg: KimiVLConfig) -> dict:
    return {f: getattr(cfg, f) for f in TINY if f != "compute_dtype"} | {
        "first_k_dense_replace": cfg.first_k_dense_replace,
        "norm_topk_prob": cfg.norm_topk_prob,
        "routed_scaling_factor": cfg.routed_scaling_factor,
        "rms_norm_eps": cfg.rms_norm_eps}


def test_prefill_then_decode_gives_the_full_forward():
    cfg = tiny_cfg()
    params = tiny_params(cfg)
    packed = kimi_vl.pack(params, cfg, "cpu")
    frames, mask = visual(2, cfg)
    steps = 5
    tokens = torch.randint(2, cfg.vocab_size, (2, steps),
                           generator=torch.Generator().manual_seed(3))
    model = kimi_vl.KimiBeam()
    fixed, (suffix,), _ = model.prologue(
        packed, cfg, {"frames": frames, "frame_mask": mask}, 1, steps, None)
    acts, x = [], fixed.first
    for t in range(steps):
        acts.append(model.activation(fixed, cfg, t, suffix, x))
        x = packed["embed"][tokens[:, t]]
    logits = torch.stack(acts, 1) @ packed["lm_head_t"]
    got = torch.log_softmax(logits, dim=-1)
    want = ref.teacher_logp(params.__getitem__, ref_model(cfg), frames,
                            mask, cfg.prompt_before, cfg.prompt_after,
                            tokens)
    assert torch.allclose(got, want, atol=1e-5, rtol=0)


def test_absorbed_decode_equals_expanded_attention():
    cfg = tiny_cfg()
    lw = kimi_vl.pack(tiny_params(cfg), cfg, "cpu")["layers"][1]["attn"]
    b, k, p, t, slots = 2, 3, 7, 2, 4
    g = torch.Generator().manual_seed(5)
    x = torch.randn((b * k, cfg.hidden_size), generator=g)
    prefix = torch.randn((b, p, cfg.latent_dim), generator=g)
    suffix = torch.randn((b * k, slots, cfg.latent_dim), generator=g)
    bias = torch.zeros((b, p))
    bias[0, 2] = float("-inf")
    cos, sin = mla.rope_tables(p + slots, cfg.qk_rope_head_dim,
                               cfg.rope_theta, "cpu")
    got = mla.mla_decode(x, lw, cfg, cos[p + t], sin[p + t], prefix, bias,
                         suffix, t)

    nh, dn, dr, dv, r = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                         cfg.qk_rope_head_dim, cfg.v_head_dim,
                         cfg.kv_lora_rank)
    q = (x @ lw["q_proj"].t()).view(b * k, nh, dn + dr)
    q = torch.cat([q[..., :dn], mla.apply_rope(q[..., dn:], cos[p + t],
                                               sin[p + t])], -1)
    want = []
    for row in range(b * k):
        cache = torch.cat([prefix[row // k], suffix[row, :t + 1]])
        kv = (cache[:, :r] @ lw["kv_b_proj"].t()).view(-1, nh, dn + dv)
        keys = torch.cat([kv[..., :dn], cache[:, None, r:].expand(
            -1, nh, dr)], -1)
        s = torch.einsum("hd,phd->hp", q[row], keys) / math.sqrt(dn + dr)
        s[:, :p] += bias[row // k]
        o = torch.einsum("hp,phd->hd", torch.softmax(s, -1), kv[..., dn:])
        want.append(o.reshape(-1) @ lw["o_proj"].t())
    assert torch.allclose(got, torch.stack(want), atol=1e-5, rtol=0)
    # the token's own cache row went to slot t
    c, k_pe = (x @ lw["kv_a_proj_with_mqa"].t()).split([r, dr], -1)
    assert torch.allclose(suffix[:, t, :r], mla.rms_norm(
        c, lw["kv_a_layernorm"], cfg.rms_norm_eps), atol=1e-6)


@pytest.mark.parametrize("counts", [[3, 0, 5, 1, 0, 0, 2, 4],
                                    [0, 0, 0, 0, 0, 0, 0, 9]])
def test_grouped_expert_products_equal_the_loop(counts):
    g = torch.Generator().manual_seed(7)
    x = torch.randn((sum(counts), 16), generator=g)
    w = torch.randn((len(counts), 12, 16), generator=g)
    offs = torch.tensor(np.cumsum(counts), dtype=torch.int32)
    grouped = moe.expert_mm(x, w, offs, route="grouped")
    loop = moe.expert_mm(x, w, offs, route="loop")
    rows = np.repeat(np.arange(len(counts)), counts)
    by_row = torch.stack([x[i] @ w[e].t() for i, e in enumerate(rows)])
    assert torch.allclose(grouped, loop, atol=1e-5, rtol=0)
    assert torch.allclose(loop, by_row, atol=1e-5, rtol=0)


def test_router_by_hand():
    """Four experts, top 2: the bias moves the choice from experts (0, 1)
    to (0, 3); the weights are the unbiased scores, normalised, times the
    scale."""
    logits = [2.0, 1.0, 0.0, 0.5]
    gate = torch.tensor([[v] for v in logits])
    bias = torch.tensor([0.0, 0.0, 0.0, 0.2])
    sig = [1.0 / (1.0 + math.exp(-v)) for v in logits]
    assert sig[1] > sig[3] and sig[3] + 0.2 > sig[1]
    w, idx = moe.route(torch.ones((1, 1)), gate, bias, 2, 2.446, True)
    assert idx.tolist() == [[0, 3]]
    want = [2.446 * s / (sig[0] + sig[3] + 1e-20) for s in (sig[0], sig[3])]
    assert torch.allclose(w, torch.tensor([want]), atol=1e-6)
    w, idx = moe.route(torch.ones((1, 1)), gate, torch.zeros(4), 2, 2.446,
                       True)
    assert idx.tolist() == [[0, 1]]
    w, _ = moe.route(torch.ones((1, 1)), gate, bias, 2, 2.446, False)
    assert torch.allclose(w, 2.446 * torch.tensor([[sig[0], sig[3]]]),
                          atol=1e-6)


def captioner(cfg, params, beam=3, maxlen=6, bias=None, bsz=4,
              device="cpu"):
    words = {f"w{i}": i for i in range(2, cfg.vocab_size)}
    serve = KimiServeConfig(model=cfg, decode=DecodeConfig(
        beam_size=beam, maxlen=maxlen, length_norm=0.6, decode_batch=bsz))
    return KimiCaptioner(params, serve, Vocab(words), device=device,
                         logit_bias=bias)


def eos_bias(cfg, kind, device="cpu"):
    if kind == "natural":
        return None
    bias = torch.zeros(cfg.vocab_size, device=device)
    bias[EOS_ID] = -1e9
    return bias


@pytest.mark.parametrize("eos", ["natural", "suppressed"])
def test_beam_decode_equals_the_reference_beam_search(eos):
    cfg = tiny_cfg()
    params = tiny_params(cfg, seed=11)
    bias = eos_bias(cfg, eos)
    cap = captioner(cfg, params, bias=bias)
    frames, mask = visual(4, cfg, seed=12)
    toks, scores = cap._run(cap.params, {"frames": frames,
                                         "frame_mask": mask})
    want_toks, want_scores = ref.beam_search(
        params.__getitem__, ref_model(cfg), frames, mask, cfg.prompt_before,
        cfg.prompt_after, 3, 6, 0.6, bias)
    assert torch.equal(toks, want_toks)
    assert torch.allclose(scores, want_scores, atol=1e-5, rtol=0)


def test_caption_ids_through_the_bank():
    """The bank path (gather, chunks padded with row 0, strings) gives the
    batch decode's captions; a full bank decodes with the causal-only
    prefill to the same tokens."""
    cfg = tiny_cfg()
    params = tiny_params(cfg, seed=21)
    frames, _ = visual(5, cfg, seed=22, padded=False)
    mask = torch.ones(frames.shape[:2])
    cap = captioner(cfg, params)
    cap.attach_bank(FeatureBank(ids=[f"v{i}" for i in range(5)],
                                frames=frames.numpy(),
                                frame_mask=mask.numpy()))
    assert cap._bank_dense
    got = cap.caption_ids(["v3", "v0", "v4", "v1", "v2"])
    toks, _ = cap._run(cap.params, {"frames": frames[[3, 0, 4, 1, 2]],
                                    "frame_mask": mask[:5]})
    want = [" ".join(cap.vocab.decode(t)) for t in toks.numpy()]
    assert got[:4] == want[:4] and len(got) == 5
    dense, _ = cap._run(cap.params, {"frames": frames[[3, 0, 4, 1, 2]],
                                     "frame_mask": mask[:5]}, dense=True)
    assert torch.equal(dense, toks)


class _NotReordered(kimi_vl.KimiBeam):
    """A planted fault: the beams' suffix caches kept in place, not
    reordered with their beams at the select."""

    def prologue(self, params, cfg, batch, k, maxlen, step_fn):
        fixed, (self.suffix,), ki = super().prologue(params, cfg, batch, k,
                                                     maxlen, step_fn)
        return fixed, (), ki

    def step(self, fixed, cfg, step_fn, t, state, prev, B, k, ki):
        vals, idx, _ = super().step(fixed, cfg, step_fn, t, (self.suffix,),
                                    prev, B, k, ki)
        return vals, idx, ()


def test_suffix_reordered_and_prefix_shared():
    cfg = tiny_cfg()
    params = tiny_params(cfg, seed=31)
    packed = kimi_vl.pack(params, cfg, "cpu")
    frames, mask = visual(4, cfg, seed=32)
    batch = {"frames": frames, "frame_mask": mask}
    bias = eos_bias(cfg, "suppressed")
    packed["logit_bias"] = bias
    model = kimi_vl.KimiBeam()
    fixed, (suffix,), _ = model.prologue(packed, cfg, batch, 5, 8, None)
    # one prefix cache a video, whatever the beam count
    assert fixed.prefix.shape == (cfg.num_hidden_layers, 4,
                                  3 + N_VISUAL + 2 - 1, cfg.latent_dim)
    assert suffix.shape[0] == 4 * 5
    good = beam_decode(packed, cfg, batch, 5, 8, 0.6, model=model)
    bad = beam_decode(packed, cfg, batch, 5, 8, 0.6, model=_NotReordered())
    want_toks, want_scores = ref.beam_search(
        params.__getitem__, ref_model(cfg), frames, mask, cfg.prompt_before,
        cfg.prompt_after, 5, 8, 0.6, bias)
    assert torch.equal(good.tokens, want_toks)
    assert torch.allclose(good.norm_scores, want_scores, atol=1e-5)
    assert (bad.norm_scores - want_scores).abs().max() > 1e-3


def test_expert_counter_counts_every_routed_row():
    cfg = tiny_cfg()
    cap = captioner(cfg, tiny_params(cfg, seed=41), beam=3, maxlen=4,
                    bias=eos_bias(cfg, "suppressed"))
    frames, mask = visual(2, cfg, seed=42)
    cap._run(cap.params, {"frames": frames, "frame_mask": mask})
    rows = cap.counter.read()["rows"]
    n = 3 + N_VISUAL + 2 - 1
    top = cfg.num_experts_per_tok
    for layer in range(len(cfg.moe_layers)):
        assert sum(rows[0][layer]) == 2 * n * top
        assert sum(rows[1][layer]) == 2 * 3 * 4 * top
    touched = cap.counter.read()["touched"]
    assert all(1 <= x <= 4 * cfg.n_routed_experts for x in touched[1])
    cap.counter.zero_()
    assert cap.counter.rows.sum() == 0 == cap.counter.touched.sum()


def test_the_two_reference_copies_agree():
    path = ROOT / "tools" / "kimi_vl_reference.py"
    spec = importlib.util.spec_from_file_location("kimi_vl_reference", path)
    tools_ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tools_ref)
    cfg = tiny_cfg()
    params = tiny_params(cfg, seed=51)
    frames, mask = visual(2, cfg, seed=52)
    tokens = torch.randint(2, cfg.vocab_size, (2, 4),
                           generator=torch.Generator().manual_seed(53))
    args = (params.__getitem__, ref_model(cfg), frames, mask,
            cfg.prompt_before, cfg.prompt_after)
    assert torch.equal(ref.teacher_logp(*args, tokens),
                       tools_ref.teacher_logp(*args, tokens))
    a = ref.beam_search(*args, 3, 4, 0.6)
    b = tools_ref.beam_search(*args, 3, 4, 0.6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    imports = {line.split()[1] for line in path.read_text().splitlines()
               if line.startswith(("import ", "from "))}
    assert imports <= {"__future__", "math", "typing", "torch",
                       "torch.nn.functional"}


def test_config_refuses_what_is_not_implemented():
    with pytest.raises(ValueError, match="q_lora_rank"):
        tiny_cfg(q_lora_rank=64)
    with pytest.raises(ValueError, match="rope_scaling"):
        KimiVLConfig.from_dict({**TINY, "rope_scaling": {"type": "yarn"}})
    cfg = KimiVLConfig()
    assert cfg.moe_layers == tuple(range(1, 27))
    assert cfg.latent_dim == 576 and cfg.qk_head_dim == 192


def test_lstm_serving_path_loads_no_new_module():
    """The LSTM's Captioner, beam loop and graphs import nothing of the
    video-language model."""
    import subprocess
    import sys
    code = ("import sys\n"
            "import stvd_torch.api, stvd_torch.decode.graphs\n"
            "new = ('kimi_vl', 'mla', 'moe', 'kimi_api', 'kimi_config')\n"
            "bad = [m for m in sys.modules if m.startswith('stvd_torch')\n"
            "       and m.rsplit('.', 1)[-1] in new]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
