"""Kimi-VL-A3B's captioner on the card: its beam decode replayed from CUDA
graphs equals the eager decode bit for bit at a small size; kernel 2 at
the model's head (dw 2048, V 163840, k 5) against its plain version; the
LSTM's step graphs hold the LSTM's kernels alone.

This file imports no jax, so it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kimi_vl_cuda.py
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from stvd_torch.data.bank import FeatureBank
from stvd_torch.decode import graphs
from stvd_torch.decode.beam import beam_decode
from stvd_torch.model import kernel, kimi_vl, moe

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from test_torch_kimi_vl import (N_VISUAL, captioner, eos_bias,  # noqa: E402
                                tiny_cfg, tiny_params)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("eos", ["natural", "suppressed"])
def test_graphed_equals_eager(cuda, eos):
    """bf16 at a small size (hidden 256, 16 experts top 4, vocab 1024):
    the bank's second request replays the prefill's graph and each step's,
    and gives the eager decode's tokens and scores bit for bit."""
    cfg = tiny_cfg(hidden_size=256, n_routed_experts=16,
                   num_experts_per_tok=4, moe_intermediate_size=64,
                   intermediate_size=512, vocab_size=1024,
                   compute_dtype="bfloat16")
    params = tiny_params(cfg, seed=61, device=cuda)
    cap = captioner(cfg, params, beam=5, maxlen=12,
                    bias=eos_bias(cfg, eos), device=cuda)
    g = torch.Generator().manual_seed(62)
    frames = torch.randn((9, N_VISUAL, cfg.hidden_size), generator=g)
    cap.attach_bank(FeatureBank(ids=[f"v{i}" for i in range(9)],
                                frames=frames.numpy(),
                                frame_mask=np.ones((9, N_VISUAL),
                                                   np.float32)))
    ids = [f"v{i}" for i in (4, 1, 7, 0)]
    first = cap.caption_ids(ids)          # eager, then the capture
    replays = cap.decode_graphs.replayed
    launches = moe.expert_mm.launches
    second = cap.caption_ids(ids)         # replayed
    assert cap.decode_graphs.replayed > replays
    assert moe.expert_mm.launches_by_route["grouped"] > 0
    assert moe.expert_mm.launches > launches
    assert first == second
    rows = torch.tensor([4, 1, 7, 0], device=cuda)
    batch = {k: v.index_select(0, rows) for k, v in cap._resident().items()}
    with torch.inference_mode():
        eager = beam_decode(cap.params, cfg, batch, 5, 12, 0.6,
                            model=cap._beams[True])
        graphed = cap._run(cap.params, batch, dense=True)
    assert torch.equal(graphed[0], eager.tokens)
    assert torch.equal(graphed[1], eager.norm_scores)


@pytest.mark.cuda
def test_logit_tail_at_the_model_head(cuda):
    """Kernel 2 on its wgmma route at (80, 2048) x (2048, 163840), k 5,
    against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(71)
    x = torch.randn((80, 2048), generator=g, device=cuda).bfloat16()
    w = (torch.randn((2048, 163840), generator=g, device=cuda)
         * 3 / 2048 ** 0.5).bfloat16()
    b = torch.zeros(163840, device=cuda)
    b[0] = -1e9
    assert kernel.logit_tail_route(80, 2048, 163840, w.dtype, x.data_ptr(),
                                   w.data_ptr()) == "wgmma"
    vals, idx, lse = kernel.logit_tail(x, w, b, 5)
    pv, pi, pl = kernel._logit_tail_plain(x, w, b, 5)
    assert torch.allclose(vals, pv, atol=2e-3, rtol=0)
    assert torch.allclose(lse, pl, atol=2e-3, rtol=0)
    assert (idx == pi).float().mean() > 0.99
    assert not (idx == 0).any()


@pytest.mark.cuda
def test_lstm_step_graphs_hold_the_lstm_kernels(cuda):
    """An LSTM Captioner's graph set counts the LSTM's wrappers, and its
    step graphs launch the attention core and the logit tail once each;
    the Kimi captioner's counts the tail and the expert products."""
    import test_torch_decode_graphs as lstm
    cap = lstm.captioner(lstm.recipe("msrvtt"), cuda, eos="suppressed")
    cap.caption_ids(cap.bank_ids[:4])
    gs = cap.decode_graphs
    assert gs.wrappers == graphs._WRAPPERS
    (chain,) = [c for c in gs.chains.values() if c is not None]
    for step in chain.steps:
        assert sorted((fn.__name__, n) for fn, _, n in step.launches) == [
            ("attention_core", 1), ("logit_tail", 1)]
    kcap = captioner(tiny_cfg(compute_dtype="bfloat16"),
                     tiny_params(tiny_cfg(), device=cuda), device=cuda)
    assert kcap._new_graphs(kcap.params).wrappers == (kernel.logit_tail,
                                                      moe.expert_mm)
    assert isinstance(kcap.step_fn, kimi_vl.KimiBeam)
