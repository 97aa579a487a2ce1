"""The port's reference-checkpoint importer against the JAX package's.

The same .npz files (written by the JAX ``save_reference_npz``, by the
port's, or by hand with the reference's own conventions) go through both
importers; the parameters, reports and inferred configs must be equal.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from stvd.config import ModelConfig as JModelConfig
from stvd.model import importer as jimp
from stvd.model.decoder import init_params as jinit
from stvd_torch.config import ModelConfig
from stvd_torch.model import importer as timp

BASE = dict(n_words=50, dim_word=16, dim=24, ctx_dim=20, n_frames=6,
            compute_dtype="float32")


def cfgs(**kw):
    return JModelConfig(**BASE, **kw), ModelConfig(**BASE, **kw)


def jax_npz(tmp_path, jcfg, seed=0):
    params = jinit(jax.random.PRNGKey(seed), jcfg)
    path = os.path.join(tmp_path, "m.npz")
    jimp.save_reference_npz(path, params)
    return path, {k: np.asarray(v) for k, v in params.items()}


def assert_same_import(path, jcfg, tcfg, strict=True):
    jgot, jrep = jimp.load_reference_npz(path, jcfg, strict=strict)
    tgot, trep = timp.load_reference_npz(path, tcfg, strict=strict)
    assert dataclasses.asdict(trep) == dataclasses.asdict(jrep)
    assert str(trep) == str(jrep)
    for k in jrep.mapped:
        assert isinstance(tgot[k], torch.Tensor)
        assert tgot[k].dtype == torch.float32
        np.testing.assert_array_equal(tgot[k].numpy(), np.asarray(jgot[k]), k)
    return tgot, trep


@pytest.mark.parametrize("kw", [
    {}, {"use_spatial": True, "region_dim": 12, "encoder": "lstm"}])
def test_import_matches_jax(tmp_path, kw):
    jcfg, tcfg = cfgs(**kw)
    path, want = jax_npz(tmp_path, jcfg)
    got, rep = assert_same_import(path, jcfg, tcfg)
    assert not rep.missing and not rep.unused
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, k)


def test_port_export_round_trips_through_both_importers(tmp_path):
    jcfg, tcfg = cfgs(use_spatial=True, region_dim=12)
    _, want = jax_npz(tmp_path, jcfg, seed=3)
    path = os.path.join(tmp_path, "port.npz")
    timp.save_reference_npz(path, {k: torch.tensor(v)
                                   for k, v in want.items()})
    with np.load(path) as z, \
            np.load(os.path.join(tmp_path, "m.npz")) as ref:
        assert sorted(z.files) == sorted(ref.files)
        for k in ref.files:
            np.testing.assert_array_equal(z[k], ref[k], k)
    assert_same_import(path, jcfg, tcfg)


def test_reference_conventions_and_bias_fold(tmp_path):
    """decoder_ prefix, (d, 1) columns, (1,) scalars and a separate
    ff_logit_ctx_b folded into the single pre-tanh bias."""
    jcfg, tcfg = cfgs()
    rng = np.random.RandomState(0)
    d, dw, dc, v = 24, 16, 20, 50
    ref = {
        "Wemb": rng.randn(v, dw), "ff_state_W": rng.randn(dc, d),
        "ff_state_b": rng.randn(d), "ff_memory_W": rng.randn(dc, d),
        "ff_memory_b": rng.randn(d),
        "decoder_W": rng.randn(dw, 4 * d), "decoder_U": rng.randn(d, 4 * d),
        "decoder_b": rng.randn(4 * d), "decoder_Wc": rng.randn(dc, 4 * d),
        "decoder_Wc_att": rng.randn(dc, dc), "decoder_b_att": rng.randn(dc),
        "decoder_Wd_att": rng.randn(d, dc), "decoder_U_att": rng.randn(dc, 1),
        "decoder_c_tt": rng.randn(1), "decoder_W_sel": rng.randn(d, 1),
        "decoder_b_sel": rng.randn(1), "ff_logit_lstm_W": rng.randn(d, dw),
        "ff_logit_lstm_b": rng.randn(dw), "ff_logit_ctx_W": rng.randn(dc, dw),
        "ff_logit_ctx_b": rng.randn(dw), "ff_logit_W": rng.randn(dw, v),
        "ff_logit_b": rng.randn(v), "extra_key": rng.randn(3)}
    path = os.path.join(tmp_path, "ref.npz")
    np.savez(path, **{k: a.astype(np.float32) for k, a in ref.items()})
    got, rep = assert_same_import(path, jcfg, tcfg, strict=False)
    assert rep.folded == ["ff_logit_ctx_b"] and rep.unused == ["extra_key"]
    assert tuple(got["U_att"].shape) == (dc,) and got["c_att"].dim() == 0
    jgot, _ = jimp.load_reference_npz(path, jcfg)
    np.testing.assert_array_equal(got["ff_logit_lstm_b"].numpy(),
                                  np.asarray(jgot["ff_logit_lstm_b"]))


@pytest.mark.parametrize("kw", [
    {}, {"use_spatial": True, "region_dim": 12, "encoder": "lstm"}])
def test_infer_model_config_matches_jax(tmp_path, kw):
    jcfg, _ = cfgs(**kw)
    path, _ = jax_npz(tmp_path, jcfg)
    assert (dataclasses.asdict(timp.infer_model_config(path))
            == dataclasses.asdict(jimp.infer_model_config(path)))


def test_errors_match_jax(tmp_path):
    jcfg, _ = cfgs()
    path, _ = jax_npz(tmp_path, jcfg)
    _, tsmall = cfgs()
    wrong = dataclasses.replace(tsmall, dim=32)
    msgs = []
    for mod, cfg in ((jimp, dataclasses.replace(jcfg, dim=32)),
                     (timp, wrong)):
        with pytest.raises(ValueError, match="shape") as e:
            mod.load_reference_npz(path, cfg)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    bad = os.path.join(tmp_path, "bad.npz")
    np.savez(bad, foo=np.zeros(3, np.float32))
    msgs = []
    for mod in (jimp, timp):
        with pytest.raises(ValueError, match="Wemb") as e:
            mod.infer_model_config(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_strict_import_names_the_missing(tmp_path):
    jcfg, tcfg = cfgs()
    path, want = jax_npz(tmp_path, jcfg)
    short = os.path.join(tmp_path, "short.npz")
    with np.load(path) as z:
        np.savez(short, **{k: z[k] for k in z.files if k != "ff_logit_W"})
    with pytest.raises(ValueError, match="ff_logit_W"):
        timp.load_reference_npz(short, tcfg, strict=True)
    got, rep = timp.load_reference_npz(short, tcfg)
    assert rep.missing == ["ff_logit_W"]
    assert tuple(got["ff_logit_W"].shape) == want["ff_logit_W"].shape
