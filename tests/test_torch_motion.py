"""Preset 4's model family through the port, against the JAX package.

The dual-stream model (appearance + motion fused linearly to the
context), with and without the frame-LSTM encoder, and with spatial
attention on top, at a tiny float32 config on the CPU.  Inputs and
weights come from numpy seeds; both packages run the same arrays.

Bars: the fused context within 1e-5; decoded tokens identical and
scores within 1e-5; the loss within 1e-5 relative and every gradient
leaf within 1e-5 of the model's largest gradient entry (both packages
sum in float32, in different orders; see tests/test_torch_train.py);
files of the entry points equal byte for byte, numbers of JSON files
within 1e-5.
"""

import dataclasses
import filecmp
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stvd import api as japi
from stvd import config as jconfig
from stvd.cli import convert as jconvert
from stvd.cli import sample as jsample
from stvd.data import bank as jbank
from stvd.data import corpus as jcorpus
from stvd.data import synthetic as jsynthetic
from stvd.data.batching import gather_batch as jgather_batch
from stvd.data.batching import synthetic_dataset as jsynthetic_dataset
from stvd.data.text import Vocab as JVocab
from stvd.decode import beam as jbeam
from stvd.decode.greedy import greedy_decode as jgreedy
from stvd.model import step as jstep
from stvd.model.decoder import encode_context as jencode_context
from stvd.model.decoder import forward_train as jforward_train
from stvd.train.loss import loss_fn as jloss_fn
from stvd_torch import api as tapi
from stvd_torch import config as tconfig
from stvd_torch.cli import convert as tconvert
from stvd_torch.cli import sample as tsample
from stvd_torch.cli import serve
from stvd_torch.cli import train as ttrain
from stvd_torch.data import bank as tbank
from stvd_torch.data import corpus as tcorpus
from stvd_torch.data import synthetic as tsynthetic
from stvd_torch.data.bank import to_device
from stvd_torch.data.batching import gather_batch, synthetic_dataset
from stvd_torch.data.text import Vocab
from stvd_torch.decode import beam as tbeam
from stvd_torch.decode.greedy import greedy_decode
from stvd_torch.decode.sample import sample_decode
from stvd_torch.model import kernel as tkernel
from stvd_torch.model import step as tstep
from stvd_torch.model.convert import params_from_numpy
from stvd_torch.model.decoder import encode_context, forward_train
from stvd_torch.train import loop as tloop
from stvd_torch.train.loss import loss_fn

from conftest import small_cfg
from test_torch_cli import assert_tree_close
from test_torch_data import assert_banks_equal, assert_datasets_equal
from test_torch_serve import Srv, post, server_args
from test_torch_step import numpy_frames, numpy_params
from test_torch_train import assert_grads_close

DM = 20          # motion width (preset 4: 2048)
MOTION = dict(use_motion=True, motion_dim=DM)
CONFIGS = {
    "motion": MOTION,
    "motion_lstm": dict(MOTION, encoder="lstm"),
    "spatial_motion_lstm": dict(MOTION, encoder="lstm", use_spatial=True,
                                n_regions=4, region_dim=16),
}
STEPS = {"plain": tstep.step, "kernels": tkernel.step_kernels}
TOL = dict(rtol=1e-5, atol=1e-5)
MAXLEN = 8
TIMEOUT = 30.0


def cfg_of(name, **kw):
    return small_cfg(use_dropout=False, **{**CONFIGS[name], **kw})


def inputs(cfg, n=4, seed=12):
    """Weights, frames, frame mask, motion (and regions) as numpy."""
    p = numpy_params(cfg, seed=11)
    frames, mask = numpy_frames(cfg, n, seed=seed)
    mask[2, 3:] = 0.0
    rng = np.random.RandomState(seed + 1)
    arrays = {"frames": frames, "frame_mask": mask,
              "motion": rng.randn(n, cfg.n_frames, DM).astype(np.float32)}
    if cfg.use_spatial:
        arrays["regions"] = rng.randn(n, cfg.n_frames, cfg.n_regions,
                                      cfg.region_dim).astype(np.float32)
    return p, arrays


def jax_side(p, arrays):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in arrays.items()})


def torch_side(p, arrays):
    return (params_from_numpy(p, "cpu"),
            {k: torch.from_numpy(v) for k, v in arrays.items()})


# ---------------------------------------------------------------------------
# The fused context
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_context_matches_jax(name):
    """frames @ W_app + motion @ W_mot + b_fuse (+ the frame LSTM's
    residual) in float32, within 1e-5 of the JAX package's."""
    cfg = cfg_of(name)
    p, arrays = inputs(cfg)
    jp, jb = jax_side(p, arrays)
    tp, tb = torch_side(p, arrays)
    ref = jencode_context(jp, cfg, jb["frames"], jb["motion"])
    got = encode_context(tp, cfg, tb["frames"], tb["motion"])
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (4, cfg.n_frames, cfg.ctx_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_bf16_fused_context_stays_float32():
    """Under bf16 the fusion accumulates in float32 and adds the float32
    bias, as JAX's ``_dot`` does: the context is float32, not bf16."""
    cfg = cfg_of("motion_lstm", compute_dtype="bfloat16")
    p, arrays = inputs(cfg)
    jp, jb = jax_side(p, arrays)
    tp, tb = torch_side(p, arrays)
    tp = tstep.cast_params(tp, cfg)
    got = encode_context(tp, cfg, tb["frames"].bfloat16(),
                         tb["motion"].bfloat16())
    ref = jencode_context(jstep.cast_params(jp, cfg), cfg,
                          jb["frames"].astype(jnp.bfloat16),
                          jb["motion"].astype(jnp.bfloat16))
    assert got.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-3,
                               atol=2e-3)


def test_missing_motion_raises_the_jax_error():
    cfg = cfg_of("motion")
    p, arrays = inputs(cfg)
    jp, jb = jax_side(p, arrays)
    tp, tb = torch_side(p, arrays)
    with pytest.raises(ValueError) as want:
        jencode_context(jp, cfg, jb["frames"], None)
    with pytest.raises(ValueError) as got:
        encode_context(tp, cfg, tb["frames"], None)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Decode: beam (with every hypothesis, the n-best), greedy, sampling
# ---------------------------------------------------------------------------

_jax_cache = {}


def jax_decode(name, kind):
    key = (name, kind)
    if key not in _jax_cache:
        cfg = cfg_of(name)
        jp, jb = jax_side(*inputs(cfg))
        if kind == "greedy":
            out = jgreedy(jp, cfg, jb, maxlen=MAXLEN)
        else:
            out = jbeam.beam_decode(jp, cfg, jb, beam_size=3, maxlen=MAXLEN)
        _jax_cache[key] = {f: np.asarray(v) for f, v in out._asdict().items()
                           if v is not None}
    return _jax_cache[key]


@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_beam_matches_jax(name, step):
    """Best beams and every hypothesis (the n-best) are the JAX
    package's tokens; raw and normalized scores within 1e-5."""
    cfg = cfg_of(name)
    tp, tb = torch_side(*inputs(cfg))
    with torch.inference_mode():
        out = tbeam.beam_decode(tp, cfg, tb, beam_size=3, maxlen=MAXLEN,
                                step_fn=STEPS[step])
    ref = jax_decode(name, "beam")
    for f in ("tokens", "lengths", "all_tokens"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), ref[f], f)
    for f in ("scores", "norm_scores", "all_scores", "all_norm_scores"):
        np.testing.assert_allclose(getattr(out, f).numpy(), ref[f],
                                   err_msg=f, **TOL)


@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_greedy_matches_jax(name, step):
    cfg = cfg_of(name)
    tp, tb = torch_side(*inputs(cfg))
    with torch.no_grad():
        out = greedy_decode(tp, cfg, tb, maxlen=MAXLEN, step_fn=STEPS[step])
    ref = jax_decode(name, "greedy")
    np.testing.assert_array_equal(out.tokens.numpy(), ref["tokens"])
    np.testing.assert_array_equal(out.lengths.numpy(), ref["lengths"])
    np.testing.assert_allclose(out.scores.numpy(), ref["scores"], **TOL)


def test_top1_sampling_is_the_jax_greedy_caption():
    """A draw from the top-1 distribution makes no choice: the sampler
    reads the motion stream and gives the JAX greedy caption."""
    cfg = cfg_of("motion_lstm")
    tp, tb = torch_side(*inputs(cfg))
    out = sample_decode(tp, cfg, tb, torch.Generator().manual_seed(0),
                        maxlen=MAXLEN, top_k=1, n_samples=2)
    ref = jax_decode("motion_lstm", "greedy")
    for j in range(2):
        np.testing.assert_array_equal(out.tokens[:, j].numpy(),
                                      ref["tokens"])


def test_decode_reads_the_motion_stream():
    """Zeroing the motion stream changes the captions: the decode loops
    pass ``batch['motion']`` to the fusion."""
    cfg = cfg_of("motion")
    tp, tb = torch_side(*inputs(cfg, n=6))
    tb0 = dict(tb, motion=torch.zeros_like(tb["motion"]))
    with torch.no_grad():
        a = tbeam.beam_decode(tp, cfg, tb, beam_size=3, maxlen=MAXLEN)
        b = tbeam.beam_decode(tp, cfg, tb0, beam_size=3, maxlen=MAXLEN)
    assert not torch.equal(a.scores, b.scores)


# ---------------------------------------------------------------------------
# Training through the fusion and the encoder
# ---------------------------------------------------------------------------

def train_batches(cfg, n_videos=4):
    """The same batch from both packages' synthetic datasets (ragged
    frame counts, a motion stream, the last example weighted 0)."""
    kw = dict(n_videos=n_videos, k=cfg.n_frames, d=cfg.ctx_dim, maxlen=10,
              seed=0, motion_dim=DM,
              n_regions=cfg.n_regions if cfg.use_spatial else 0,
              region_dim=cfg.region_dim)
    jds, tds = jsynthetic_dataset(**kw), synthetic_dataset(**kw)
    idx = np.array([0, 3, 5, 6], np.int32)
    weight = np.array([1, 1, 1, 0], np.float32)
    jb = jgather_batch(jds.bank.to_device(), jds.captions, idx)
    tb = gather_batch(to_device(tds.bank, "cpu"), tds.captions, idx)
    assert "motion" in tb and "motion" in jb
    jb["weight"] = jnp.asarray(weight)
    tb["weight"] = torch.from_numpy(weight)
    return jb, tb


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_train_matches_jax(name):
    cfg = cfg_of(name)
    p = numpy_params(cfg)
    jb, tb = train_batches(cfg)
    ref = jforward_train({k: jnp.asarray(v) for k, v in p.items()}, cfg, jb,
                         train=False)
    got = forward_train(params_from_numpy(p, "cpu"), cfg, tb, train=False)
    for f in ("logits", "alphas", "nll_per_example"):
        np.testing.assert_allclose(getattr(got, f).detach().numpy(),
                                   np.asarray(getattr(ref, f)), err_msg=f,
                                   **TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_loss_and_grads_match_jax(name):
    """The loss and every leaf's gradient against ``jax.grad`` of
    ``stvd.train.loss.loss_fn``: autograd carries the hand-derived
    sequence VJP's context cotangents into W_app, W_mot, b_fuse and the
    frame LSTM's weights."""
    cfg = cfg_of(name)
    p = numpy_params(cfg)
    jb, tb = train_batches(cfg)
    (jl, _), jg = jax.value_and_grad(
        lambda q: jloss_fn(q, cfg, jb, train=False), has_aux=True)(
            {k: jnp.asarray(v) for k, v in p.items()})
    tp = params_from_numpy(p, "cpu")
    for v in tp.values():
        v.requires_grad_(True)
    tl, _ = loss_fn(tp, cfg, tb, train=False)
    tl.backward()
    tl = tl.detach()
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    got = {k: v.grad.numpy() for k, v in tp.items()}
    assert_grads_close(got, {k: np.asarray(v) for k, v in jg.items()}, 1e-5)
    fused = ["W_app", "W_mot", "b_fuse"] + (
        ["enc_W", "enc_U", "enc_b"] if cfg.encoder == "lstm" else [])
    for k in fused:
        assert float(np.abs(got[k]).max()) > 0.0, k


@pytest.mark.parametrize("mode", ["ss_0.25", "ss_1.0", "autodiff"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_autograd_scans_match_jax(monkeypatch, name, mode):
    """The scheduled-sampling scan (with JAX's coins) and the autodiff
    scan (``fused_seq_grad=False``) through the kernel step: the loss and
    every leaf's gradient, the fusion's and the frame LSTM's included,
    against ``jax.grad`` of the JAX package's loss within 1e-5."""
    from test_torch_train import use_jax_coins
    ss = float(mode[3:]) if mode.startswith("ss") else 0.0
    cfg = cfg_of(name, **({} if ss else {"fused_seq_grad": False}))
    p = numpy_params(cfg)
    jb, tb = train_batches(cfg)
    if ss:
        use_jax_coins(monkeypatch, ss, tb)
    (jl, _), jg = jax.value_and_grad(
        lambda q: jloss_fn(q, cfg, jb, train=False, ss_prob=ss),
        has_aux=True)({k: jnp.asarray(v) for k, v in p.items()})
    tp = params_from_numpy(p, "cpu")
    for v in tp.values():
        v.requires_grad_(True)
    tl, _ = loss_fn(tp, cfg, tb, train=False, ss_prob=ss,
                    step_fn=tkernel.step_kernels)
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    got = {k: v.grad.numpy() for k, v in tp.items()}
    assert_grads_close(got, {k: np.asarray(v) for k, v in jg.items()}, 1e-5)
    for k in ["W_app", "W_mot", "b_fuse"] + (
            ["enc_W", "enc_U", "enc_b"] if cfg.encoder == "lstm" else []):
        assert float(np.abs(got[k]).max()) > 0.0, k


def test_fit_trains_a_dual_stream_split(tmp_path):
    """Three updates of ``fit`` on a dual-stream synthetic split: finite
    losses, and the fusion and encoder weights move."""
    model = tconfig.ModelConfig(**dataclasses.asdict(cfg_of("motion_lstm")))
    cfg = tconfig.Config(model=model, train=tconfig.TrainConfig(
        batch_size=4, metric="nll", disp_freq=1, valid_freq=0, save_freq=0,
        save_dir=str(tmp_path)))
    ds = synthetic_dataset(n_videos=6, k=model.n_frames, d=model.ctx_dim,
                           motion_dim=DM, maxlen=10, seed=0)
    state0 = tloop.init_train_state(cfg.train.seed, model, cfg.train,
                                    "cpu")
    before = {k: v.detach().clone() for k, v in state0["params"].items()}
    out = tloop.fit(cfg, ds, max_updates=3, device="cpu")
    assert [r["update"] for r in out.log] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in out.log)
    for k in ("W_app", "W_mot", "b_fuse", "enc_W", "enc_U", "enc_b"):
        assert not torch.equal(out.state["params"][k], before[k]), k


# ---------------------------------------------------------------------------
# Request layer, bank and data
# ---------------------------------------------------------------------------

def raw_request(cfg, n=5, seed=21):
    """Per-video appearance and motion arrays with frame counts around K
    (sub- and over-sampled by pack_bank)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(2, 2 * cfg.n_frames, size=n)
    feats = [rng.randn(int(f), cfg.ctx_dim).astype(np.float32) for f in lens]
    mots = [rng.randn(int(f), DM).astype(np.float32) for f in lens]
    return feats, mots


def test_pack_request_with_regions_and_motion_matches_jax():
    cfg = cfg_of("spatial_motion_lstm", compute_dtype="bfloat16")
    feats, mots = raw_request(cfg)
    rng = np.random.RandomState(3)
    regs = [rng.randn(f.shape[0], cfg.n_regions, cfg.region_dim)
            .astype(np.float32) for f in feats]
    ref = japi.pack_request(cfg, feats, regs, mots)
    got = tapi.pack_request(cfg, feats, regs, mots, device="cpu")
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(ref[k], np.float32), k)


def vocab(cfg):
    return {f"w{i}": i for i in range(2, cfg.n_words)}


def captioners(name, beam=3):
    cfg = cfg_of(name)
    full = jconfig.Config(model=cfg, decode=jconfig.DecodeConfig(
        beam_size=beam, maxlen=MAXLEN, decode_batch=3))
    p = numpy_params(cfg, seed=22)
    jcap = japi.Captioner({k: jnp.asarray(v) for k, v in p.items()}, full,
                          JVocab(vocab(cfg)))
    tcap = tapi.Captioner(p, tconfig.Config.from_json(full.to_json()),
                          Vocab(vocab(cfg)), device="cpu")
    return cfg, jcap, tcap


@pytest.mark.parametrize("beam", [1, 3])
@pytest.mark.parametrize("name", ["motion", "motion_lstm"])
def test_captioner_caption_with_motion_matches_jax(name, beam):
    cfg, jcap, tcap = captioners(name, beam)
    feats, mots = raw_request(cfg)
    got = tcap.caption(feats, None, mots)
    assert got == jcap.caption(feats, None, mots)
    assert len(got) == 5 and any(got)


def test_captioner_nbest_with_motion_matches_jax():
    cfg, jcap, tcap = captioners("motion_lstm")
    feats, mots = raw_request(cfg)
    got = tcap.nbest(feats, None, mots, n=2)
    want = jcap.nbest(feats, None, mots, n=2)
    assert [[t for t, _ in v] for v in got] == [[t for t, _ in v]
                                                for v in want]
    np.testing.assert_allclose([[s for _, s in v] for v in got],
                               [[s for _, s in v] for v in want], **TOL)


def test_bank_resident_captions_keep_the_motion_stream():
    """A bank with a motion stream attached to the Captioner: captions by
    id equal the captions of the same videos' raw arrays, and a bank
    without motion is refused for the dual-stream model."""
    cfg, jcap, tcap = captioners("motion")
    bank = tbank.synthetic_bank(5, k=cfg.n_frames, d=cfg.ctx_dim,
                                motion_dim=DM, seed=4)
    tcap.attach_bank(bank)
    assert tcap._bank_keys() == ["frames", "frame_mask", "motion"]
    ids = list(bank.ids)[::-1]
    jcap.attach_bank(jbank.synthetic_bank(5, k=cfg.n_frames, d=cfg.ctx_dim,
                                          motion_dim=DM, seed=4))
    assert tcap.caption_ids(ids) == jcap.caption_ids(ids)
    rows = [bank.index()[v] for v in ids]
    feats = [bank.frames[r][bank.frame_mask[r] > 0] for r in rows]
    mots = [bank.motion[r][bank.frame_mask[r] > 0] for r in rows]
    assert tcap.caption_ids(ids) == tcap.caption(feats, None, mots)
    tcap.attach_bank(tbank.synthetic_bank(2, k=cfg.n_frames, d=cfg.ctx_dim))
    with pytest.raises(ValueError, match="motion"):
        tcap.caption_ids(["vid0000"])


def test_load_splits_with_a_motion_pickle_matches_jax(tmp_path):
    """Feature and motion pickles packed at load time (the config's
    ``motion_feature_file``), read by both packages."""
    rng = np.random.RandomState(1)
    ids = [f"v{i}" for i in range(12)]
    feats = {v: rng.randn(3 + i % 4, 8).astype(np.float32)
             for i, v in enumerate(ids)}
    motion = {v: rng.randn(len(f), 6).astype(np.float32)
              for v, f in feats.items()}
    caps = {v: [{"tokenized": f"a thing number{i % 3} happens"}]
            for i, v in enumerate(ids)}
    for fname, obj in (("FEAT.pkl", feats), ("MOT.pkl", motion),
                       ("CAP.pkl", caps)):
        with open(tmp_path / fname, "wb") as f:
            pickle.dump(obj, f, protocol=2)
    t = tconfig.Config(
        model=tconfig.ModelConfig(n_words=40, dim_word=8, dim=16, ctx_dim=8,
                                  n_frames=4, compute_dtype="float32",
                                  use_motion=True, motion_dim=6),
        train=tconfig.TrainConfig(maxlen=8),
        data=tconfig.DataConfig(dataset="legacy", data_dir=str(tmp_path),
                                feature_file="FEAT.pkl",
                                motion_feature_file="MOT.pkl",
                                captions_file="CAP.pkl"))
    got = tcorpus.load_splits(t)
    want = jcorpus.load_splits(jconfig.Config.from_json(t.to_json()))
    for s in want:
        assert got[s].bank.motion is not None
        assert_datasets_equal(got[s], want[s])


@pytest.mark.parametrize("kind", ["discriminative", "structured"])
def test_synthetic_motion_splits_match_jax(kind):
    """The synthetic splits with a motion stream (the verb only in the
    motion stream for the discriminative one) equal the JAX package's."""
    if kind == "discriminative":
        kw = dict(n_train=12, n_valid=4, n_test=4, k=4, d=16, n_regions=0,
                  motion_dim=DM, subject_in="frames", verb_in="motion",
                  seed=3)
        got = tsynthetic.discriminative_splits(**kw)
        want = jsynthetic.discriminative_splits(**kw)
    else:
        kw = dict(n_train=12, n_valid=4, n_test=4, k=4, d=16,
                  motion_dim=DM, seed=3)
        got = tsynthetic.structured_splits(**kw)
        want = jsynthetic.structured_splits(**kw)
    assert sorted(got) == sorted(want)
    for s in want:
        assert got[s].bank.motion.shape[-1] == DM
        assert_datasets_equal(got[s], want[s])


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def test_convert_motion_writes_the_jax_bank(tmp_path):
    """``cli.convert --features --motion`` from pickles writes the same
    bytes as the JAX CLI, and the bank carries the motion stream."""
    rng = np.random.RandomState(2)
    feats = {f"vid{i}": rng.randn(3 + i, 8).astype(np.float32)
             for i in range(5)}
    motion = {v: rng.randn(f.shape[0] + 1, 6).astype(np.float32)
              for v, f in feats.items()}
    for fname, obj in (("F.pkl", feats), ("M.pkl", motion)):
        with open(tmp_path / fname, "wb") as f:
            pickle.dump(obj, f, protocol=2)
    args = ["--features", str(tmp_path / "F.pkl"), "--motion",
            str(tmp_path / "M.pkl"), "--frames", "4"]
    assert jconvert.main(args + ["--out", str(tmp_path / "j.npz")]) == 0
    assert tconvert.main(args + ["--out", str(tmp_path / "t.npz")]) == 0
    assert filecmp.cmp(tmp_path / "j.npz", tmp_path / "t.npz",
                       shallow=False)
    bank = tbank.FeatureBank.load(str(tmp_path / "t.npz"))
    assert bank.motion.shape == (5, 4, 6)
    assert_banks_equal(bank, jbank.FeatureBank.load(str(tmp_path / "j.npz")))


CLI_MODEL = "motion_lstm"


def make_motion_run_dirs(root):
    """(JAX run dir, port run dir) of one dual-stream weight set: each
    package's own checkpoint writer, one config (synthetic corpus of 8
    training videos with a motion stream, beam 3, decode batch 3)."""
    from stvd.train.loop import init_train_state as jinit_train_state
    from stvd.train.loop import save_checkpoint as jsave_checkpoint
    root = str(root)
    mcfg = cfg_of(CLI_MODEL)
    cfg = tconfig.Config(
        model=tconfig.ModelConfig(**dataclasses.asdict(mcfg)),
        decode=tconfig.DecodeConfig(beam_size=3, maxlen=MAXLEN,
                                    decode_batch=3),
        data=tconfig.DataConfig(synthetic_videos=8))
    jcfg = jconfig.Config.from_json(cfg.to_json())
    p = numpy_params(mcfg, seed=5)
    jdir, tdir = os.path.join(root, "jax"), os.path.join(root, "torch")
    jstate = dict(jinit_train_state(jax.random.PRNGKey(0), jcfg.model,
                                    jcfg.train))
    jstate["params"] = {k: jnp.asarray(v) for k, v in p.items()}
    tstate = tloop.init_train_state(0, cfg.model, cfg.train, "cpu")
    tstate["params"] = params_from_numpy(p, "cpu")
    for d in (jdir, tdir):
        os.makedirs(d)
        with open(os.path.join(d, "config.json"), "w") as f:
            f.write(cfg.to_json())
        Vocab(vocab(mcfg)).save_pickle(os.path.join(d, "vocab.pkl"))
    for name in ("ckpt", "ckpt_best"):
        jsave_checkpoint(os.path.join(jdir, name), jstate)
        tloop.save_checkpoint(os.path.join(tdir, name + ".pt"), tstate, {})
    return jdir, tdir


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    return make_motion_run_dirs(tmp_path_factory.mktemp("motion_runs"))


@pytest.fixture(scope="module")
def sampled(run_dirs):
    jdir, tdir = run_dirs
    flags = ["--split", "valid", "--nbest", "2", "--dump-attention", "3",
             "--nll"]
    assert jsample.main(["--run-dir", jdir] + flags) == 0
    assert tsample.main(["--run-dir", tdir, "--device", "cpu"] + flags) == 0
    return jdir, tdir


@pytest.mark.parametrize("fname", ["valid_samples.txt", "valid_samples.json"])
def test_sample_cli_files_are_byte_identical(sampled, fname):
    jdir, tdir = sampled
    assert filecmp.cmp(os.path.join(jdir, fname), os.path.join(tdir, fname),
                       shallow=False)


@pytest.mark.parametrize("fname", ["valid_scores.json", "valid_nbest.json"])
def test_sample_cli_json_files_are_equal(sampled, fname):
    jdir, tdir = sampled
    with open(os.path.join(tdir, fname)) as f:
        got = json.load(f)
    with open(os.path.join(jdir, fname)) as f:
        want = json.load(f)
    assert_tree_close(got, want)


def test_sample_cli_attention_dump_agrees(sampled):
    jdir, tdir = sampled
    with np.load(os.path.join(jdir, "valid_attention.npz")) as j, \
            np.load(os.path.join(tdir, "valid_attention.npz")) as t:
        assert sorted(t.files) == sorted(j.files)
        for k in ("ids", "tokens", "frame_mask"):
            np.testing.assert_array_equal(t[k], j[k], k)
        np.testing.assert_allclose(t["alphas"], j["alphas"], **TOL)


def motion_bank(path):
    mcfg = cfg_of(CLI_MODEL)
    bank = tbank.synthetic_bank(7, k=mcfg.n_frames, d=mcfg.ctx_dim,
                                motion_dim=DM, seed=4)
    bank = dataclasses.replace(bank, ids=[f"vid{i}" for i in range(7)])
    bank.save(path)
    return bank


@pytest.mark.parametrize("wire", ["raw", "npz"])
def test_serve_caption_with_motion_matches_jax(run_dirs, tmp_path, wire):
    """``cli.serve`` on the dual-stream run dir, warmed up with a motion
    stream and with a motion bank resident: ``/caption`` with motion over
    each wire, ``/caption_ids`` and ``/nbest_ids`` give the JAX
    Captioner's captions."""
    jdir, tdir = run_dirs
    mcfg = cfg_of(CLI_MODEL)
    bank = motion_bank(str(tmp_path / "bank.npz"))
    jcap = japi.Captioner.from_run_dir(jdir)
    jcap.attach_bank(jbank.FeatureBank.load(str(tmp_path / "bank.npz")))
    rng = np.random.RandomState(1)
    feats = rng.randn(5, mcfg.n_frames, mcfg.ctx_dim).astype(np.float32)
    mots = rng.randn(5, mcfg.n_frames, DM).astype(np.float32)
    ids = ["vid3", "vid0", "vid6", "vid1"]
    server = serve.build_server(server_args(
        tdir, bank=str(tmp_path / "bank.npz"), no_warmup=False))
    assert server.warmup() >= 0.0
    with Srv(server) as s:
        got = serve.request_captions("127.0.0.1", s.port, feats,
                                     motion=mots, wire=wire,
                                     timeout=TIMEOUT)
        by_id = serve.request_caption_ids("127.0.0.1", s.port, ids,
                                          timeout=TIMEOUT)
        st, nb = post(s.port, "/nbest_ids?n=2", json.dumps({"ids": ids}))
    assert st == 200
    assert got == jcap.caption(feats, None, mots)
    assert by_id == jcap.caption_ids(ids)
    want = jcap.nbest_ids(ids, n=2)
    assert [[t for t, _ in v] for v in nb["nbest"]] == [
        [t for t, _ in v] for v in want]
    assert bank.n_videos == 7


def test_train_cli_takes_the_msrvtt_recipe(tmp_path):
    """``cli.train --config recipes/msrvtt.json`` (dual stream,
    ``data_parallel: true``) cut to a tiny width on one visible device
    trains, with the frame-LSTM encoder on, and the run dir serves."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = str(tmp_path / "run")
    sets = {"model.n_words": 48, "model.dim_word": 16, "model.dim": 24,
            "model.ctx_dim": 32, "model.motion_dim": DM,
            "model.n_frames": 6, "model.encoder": "lstm",
            "model.compute_dtype": "float32", "data.dataset": "synthetic",
            "data.synthetic_videos": 8, "train.batch_size": 4,
            "train.valid_freq": 0, "train.disp_freq": 1,
            "train.save_dir": run, "train.length_buckets": ""}
    argv = ["--config", os.path.join(repo, "recipes", "msrvtt.json"),
            "--max-updates", "2", "--device", "cpu"]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    assert ttrain.main(argv) == 0
    with open(os.path.join(run, "config.json")) as f:
        cfg = tconfig.Config.from_json(f.read())
    assert cfg.model.use_motion and cfg.train.data_parallel
    with open(os.path.join(run, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["update"] for r in recs if r["kind"] == "train"][-1] == 2
    cap = tapi.Captioner.from_run_dir(run, device="cpu")
    feats, mots = raw_request(cfg_of(CLI_MODEL), n=2)
    assert len(cap.caption(feats, None, mots)) == 2


def test_msrvtt_recipe_routes():
    """``recipes/msrvtt.json`` is not preset 4 (dim 3518, dim_word 468,
    vocab 20000): its decode step takes kernel 1's cluster route (A = Dc
    = 2048, float32 context) and the wmma routes of kernels 2, 3 and 6,
    whose TMA boxes need widths that are multiples of 8."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "recipes", "msrvtt.json")) as f:
        cfg = tconfig.Config.from_json(f.read())
    m, d = cfg.model, cfg.decode
    bf16 = torch.bfloat16
    rows = d.decode_batch * d.beam_size
    assert (m.dim, m.dim_word, m.n_words) == (3518, 468, 20000)
    assert tkernel.attention_core_route(d.beam_size, m.n_frames, m.attn_dim,
                                        m.ctx_dim, torch.float32, 0,
                                        0) == "cluster"
    assert tkernel.logit_tail_route(rows, m.dim_word, m.n_words, bf16,
                                    0, 0) == "wmma"
    assert tkernel.gates_route(rows, m.dim_word + m.dim + m.ctx_dim, m.dim,
                               bf16, 0, 0) == "wmma"
    assert tkernel.train_tail_route(cfg.train.batch_size, m.ctx_dim, m.dim,
                                    bf16, 0, 0) == "wmma"
    p4 = tconfig.preset("msrvtt-fused").model
    assert tkernel.logit_tail_route(rows, p4.dim_word, p4.n_words, bf16,
                                    0, 0) == "wgmma"
    assert tkernel.train_tail_route(64, p4.ctx_dim, p4.dim, bf16, 0,
                                    0) == "wgmma"
