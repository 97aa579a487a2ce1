"""The port's inference API against stvd.api on the same numpy weights.

Captions are compared as strings at float32 on the CPU, where both
Captioners pick their plain step; requests are split into padded
``decode_batch`` chunks on both sides.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stvd import api as japi
from stvd.config import Config, DecodeConfig
from stvd.data.text import Vocab
from stvd_torch import api as tapi
from stvd_torch.data.bank import to_device

from conftest import small_cfg
from test_torch_step import numpy_params

CFG = dataclasses.replace(small_cfg(), n_words=1024, dim_word=128)
VOCAB = Vocab({f"w{i}": i for i in range(2, CFG.n_words)})


def request(n=5, seed=21):
    """Per-video features with frame counts around K (sub- and
    over-sampled by pack_bank)."""
    rng = np.random.RandomState(seed)
    return [rng.randn(int(f), CFG.ctx_dim).astype(np.float32)
            for f in rng.randint(2, 2 * CFG.n_frames, size=n)]


def config(beam):
    return Config(model=CFG, decode=DecodeConfig(beam_size=beam, maxlen=8,
                                                 decode_batch=3))


@pytest.mark.parametrize("beam", [1, 3])
def test_caption_matches_jax_captioner(beam):
    p = numpy_params(CFG, seed=22)
    feats = request()
    ref = japi.Captioner({k: jnp.asarray(v) for k, v in p.items()},
                         config(beam), VOCAB).caption(feats)
    got = tapi.Captioner(p, config(beam), VOCAB,
                           device="cpu").caption(feats)
    assert got == ref
    assert len(got) == len(feats) and any(got)


def test_pack_request_matches_jax():
    cfg = dataclasses.replace(CFG, compute_dtype="bfloat16")
    feats = request()
    ref = japi.pack_request(cfg, feats)
    got = tapi.pack_request(cfg, feats, device="cpu")
    assert got["frames"].dtype == torch.bfloat16
    assert got["frame_mask"].dtype == torch.float32
    for k in ("frames", "frame_mask"):
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(ref[k], np.float32))


def test_pack_request_rejects_unported_streams():
    with pytest.raises(NotImplementedError):
        tapi.pack_request(CFG, request(), motion=request(),
                          device="cpu")


def test_chunked_caption_pads_last_chunk_with_one_valid_frame():
    seen = []

    def run(chunk):
        seen.append({k: v.clone() for k, v in chunk.items()})
        return torch.zeros((chunk["frames"].shape[0], 4), dtype=torch.int64)

    batch = tapi.pack_request(CFG, request(n=5), device="cpu")
    out = tapi.chunked_caption(run, batch, 3, VOCAB)
    assert out == [""] * 5
    assert [c["frames"].shape[0] for c in seen] == [3, 3]
    last = seen[1]["frame_mask"]
    np.testing.assert_array_equal(last[:2].numpy(),
                                  batch["frame_mask"][3:].numpy())
    np.testing.assert_array_equal(last[2].numpy(),
                                  np.eye(1, CFG.n_frames)[0])
    assert float(seen[1]["frames"][2].abs().max()) == 0.0


def test_to_device_casts_features_not_mask():
    from stvd.data.bank import synthetic_bank
    bank = synthetic_bank(3, k=CFG.n_frames, d=8, motion_dim=4)
    dev = to_device(bank, "cpu", torch.bfloat16)
    assert dev["frames"].dtype == torch.bfloat16
    assert dev["motion"].dtype == torch.bfloat16
    assert dev["frame_mask"].dtype == torch.float32
    assert "regions" not in dev


def test_bf16_captioner_runs_on_cpu():
    """The bf16 serving configuration decodes through the same path on
    the CPU (bf16 operands, float32 sums) and yields vocabulary words."""
    cfg = dataclasses.replace(config(3), model=dataclasses.replace(
        CFG, compute_dtype="bfloat16"))
    got = tapi.Captioner(numpy_params(CFG, seed=22), cfg, VOCAB,
                         device="cpu").caption(request())
    words = {w for cap in got for w in cap.split()}
    assert len(got) == 5 and words <= set(VOCAB.word_to_id)


def test_pack_request_takes_regions_in_the_jax_position():
    """``pack_request(cfg, feats, regions)`` as written for the JAX
    package: the third positional argument is the regions."""
    feats = request(n=3)
    rng = np.random.RandomState(5)
    regs = [rng.randn(f.shape[0], 3, 4).astype(np.float32) for f in feats]
    ref = japi.pack_request(CFG, feats, regs)
    got = tapi.pack_request(CFG, feats, regs, device="cpu")
    assert tuple(got["regions"].shape) == (3, CFG.n_frames, 3, 4)
    np.testing.assert_array_equal(got["regions"].numpy(),
                                  np.asarray(ref["regions"]))


def test_captioner_takes_step_fn_in_the_jax_position():
    def step_fn(*args):
        raise AssertionError("not called")

    cap = tapi.Captioner(numpy_params(CFG, seed=22), config(3), VOCAB,
                         step_fn, device="cpu")
    assert cap.step_fn is step_fn and cap.device == torch.device("cpu")


def test_captioner_defaults_to_the_card(monkeypatch):
    """Without ``device`` the Captioner is for the card: where there is
    none it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.Captioner(numpy_params(CFG, seed=22), config(3), VOCAB)
    with pytest.raises(TypeError):     # device is keyword-only
        tapi.Captioner(numpy_params(CFG, seed=22), config(3), VOCAB, None,
                       "cpu")
