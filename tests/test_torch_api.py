"""The port's inference API against stvd.api on the same numpy weights.

Captions are compared as strings at float32 on the CPU, where both
Captioners pick their plain step; requests are split into padded
``decode_batch`` chunks on both sides.
"""

import dataclasses
import os

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


def motion_request(feats, dm=8, seed=23):
    """Per-video (F_i, Dm) motion features beside ``feats``."""
    rng = np.random.RandomState(seed)
    return [rng.randn(f.shape[0], dm).astype(np.float32) for f in feats]


def test_pack_request_rejects_unported_streams():
    """The motion stream, which ``pack_request`` once rejected, is packed
    as the JAX package packs it: subsampled or padded to K beside the
    frames, in the compute dtype."""
    cfg = dataclasses.replace(CFG, compute_dtype="bfloat16",
                              use_motion=True, motion_dim=8)
    feats = request()
    mots = motion_request(feats)
    ref = japi.pack_request(cfg, feats, None, mots)
    got = tapi.pack_request(cfg, feats, None, mots, device="cpu")
    assert sorted(got) == sorted(ref) == ["frame_mask", "frames", "motion"]
    assert got["motion"].dtype == torch.bfloat16
    for k in ref:
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(ref[k], np.float32))


def test_chunked_caption_pads_last_chunk_with_one_valid_frame():
    seen = []

    def run(params, chunk):
        assert params == "weights"
        seen.append({k: v.clone() for k, v in chunk.items()})
        n = chunk["frames"].shape[0]
        return torch.zeros((n, 4), dtype=torch.int64), torch.zeros(n)

    batch = tapi.pack_request(CFG, request(n=5), device="cpu")
    out = tapi.chunked_caption(run, "weights", batch, 3, VOCAB)
    assert out == [""] * 5
    assert [c["frames"].shape[0] for c in seen] == [3, 3]
    last = seen[1]["frame_mask"]
    np.testing.assert_array_equal(last[:2].numpy(),
                                  batch["frame_mask"][3:].numpy())
    np.testing.assert_array_equal(last[2].numpy(),
                                  np.eye(1, CFG.n_frames)[0])
    assert float(seen[1]["frames"][2].abs().max()) == 0.0


@pytest.mark.parametrize("window", [1, 4])
@pytest.mark.parametrize("n", [2, 5, 13])
def test_chunked_caption_takes_the_jax_positional_order(window, n):
    """``chunked_caption(run, params, batch, bsz, vocab, window)`` as the
    JAX package calls it gives ``Captioner.caption``'s captions, for runs
    of fewer chunks than ``window`` (n 2 and 5 at bsz 3) and of more."""
    cap = tapi.Captioner(numpy_params(CFG, seed=22), config(3), VOCAB,
                         device="cpu")
    feats = request(n=n)
    batch = tapi.pack_request(CFG, feats, device="cpu")
    got = tapi.chunked_caption(cap._run, cap.params, batch, 3, VOCAB,
                               window)
    assert got == cap.caption(feats)
    assert len(got) == n


def test_caption_takes_motion_in_the_jax_position():
    """``caption(features, None, motion)`` as written for the JAX package
    gives the JAX Captioner's captions of the dual-stream model."""
    cfg = dataclasses.replace(config(3), model=dataclasses.replace(
        CFG, use_motion=True, motion_dim=8))
    p = numpy_params(cfg.model, seed=22)
    feats = request(n=4)
    mots = motion_request(feats)
    ref = japi.Captioner({k: jnp.asarray(v) for k, v in p.items()}, cfg,
                         VOCAB).caption(feats, None, mots)
    got = tapi.Captioner(p, cfg, VOCAB, device="cpu").caption(feats, None,
                                                              mots)
    assert got == ref
    assert len(got) == 4 and any(got)


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


# ---- n-best, sampling, bank-resident requests, weight swap, run dirs --------

_jax_caps = {}


def jax_captioner(beam=3, seed=22):
    key = (beam, seed)
    if key not in _jax_caps:
        p = numpy_params(CFG, seed=seed)
        _jax_caps[key] = japi.Captioner({k: jnp.asarray(v)
                                         for k, v in p.items()},
                                        config(beam), VOCAB)
    return _jax_caps[key]


def port_captioner(beam=3, seed=22, **kw):
    return tapi.Captioner(numpy_params(CFG, seed=seed), config(beam), VOCAB,
                          device="cpu", **kw)


def assert_nbest_close(got, want):
    assert [[t for t, _ in v] for v in got] == [[t for t, _ in v]
                                                for v in want]
    np.testing.assert_allclose([[s for _, s in v] for v in got],
                               [[s for _, s in v] for v in want],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("norm", [True, False])
def test_nbest_matches_jax(norm):
    feats = request()
    got = port_captioner().nbest(feats, norm=norm)
    want = jax_captioner().nbest(feats, norm=norm)
    assert_nbest_close(got, want)
    assert all(len(v) == 3 for v in got)
    if norm:     # entry 0 is the caption caption() gives
        assert [v[0][0] for v in got] == port_captioner().caption(feats)
    two = port_captioner().nbest(feats, n=2, norm=norm)
    assert [v[:2] for v in got] == two


def test_nbest_needs_a_beam():
    with pytest.raises(ValueError, match="beam_size > 1"):
        port_captioner(beam=1).nbest(request(n=2))


def bank_of(feats, spatial=False):
    from stvd_torch.data.bank import pack_bank
    ids = [f"vid{i}" for i in range(len(feats))]
    regs = ({v: np.zeros((f.shape[0], 3, 4), np.float32)
             for v, f in zip(ids, feats)} if spatial else None)
    return pack_bank(dict(zip(ids, feats)), CFG.n_frames, ids=ids,
                     regions=regs)


def test_caption_ids_equals_caption_and_jax():
    """7 ids at decode batch 3: two full chunks and one padded by
    repeating row 0."""
    from stvd.data.bank import pack_bank as jpack
    feats = request(n=7, seed=5)
    cap = port_captioner()
    bank = bank_of(feats)
    assert cap.attach_bank(bank) == 7
    assert cap.bank_ids == bank.ids
    ids = ["vid3", "vid0", "vid6", "vid6", "vid1", "vid2", "vid5"]
    got = cap.caption_ids(ids)
    direct = cap.caption(feats)
    assert got == [direct[int(v[3:])] for v in ids]
    jcap = jax_captioner()
    jcap.attach_bank(jpack(dict(zip(bank.ids, feats)), CFG.n_frames,
                           ids=bank.ids))
    assert got == jcap.caption_ids(ids)
    assert_nbest_close(cap.nbest_ids(ids[:3], n=2),
                       jcap.nbest_ids(ids[:3], n=2))


def test_bank_errors_match_jax():
    from stvd.data.bank import pack_bank as jpack
    feats = request(n=3, seed=6)
    cap, jcap = port_captioner(), japi.Captioner(
        {k: jnp.asarray(v) for k, v in numpy_params(CFG, 22).items()},
        config(3), VOCAB)
    assert cap.bank_ids == [] == jcap.bank_ids
    msgs = [[], []]
    for i, c in enumerate((cap, jcap)):
        with pytest.raises(ValueError, match="no feature bank") as e:
            c.caption_ids(["vid0"])
        msgs[i].append(str(e.value))
    cap.attach_bank(bank_of(feats))
    jcap.attach_bank(jpack({f"vid{i}": f for i, f in enumerate(feats)},
                           CFG.n_frames))
    for i, c in enumerate((cap, jcap)):
        for bad in (["vid9"], [f"x{j}" for j in range(7)]):
            with pytest.raises(ValueError, match="unknown video ids") as e:
                c.caption_ids(bad)
            msgs[i].append(str(e.value))
        with pytest.raises(ValueError, match="unknown video ids") as e:
            c.nbest_ids(["nope"])
        msgs[i].append(str(e.value))
    assert msgs[0] == msgs[1]
    # a spatial model on a bank without regions
    sp = dataclasses.replace(CFG, use_spatial=True, n_regions=3,
                             region_dim=4)
    scfg = dataclasses.replace(config(3), model=sp)
    import jax
    from stvd.model.decoder import init_params as jinit
    jp = jinit(jax.random.PRNGKey(0), sp)
    spc = tapi.Captioner({k: np.asarray(v) for k, v in jp.items()}, scfg,
                         VOCAB, device="cpu")
    jspc = japi.Captioner(jp, scfg, VOCAB)
    spc.attach_bank(bank_of(feats))
    jspc.attach_bank(jpack({f"vid{i}": f for i, f in enumerate(feats)},
                           CFG.n_frames))
    errs = []
    for c in (spc, jspc):
        with pytest.raises(ValueError, match="lacks streams") as e:
            c.caption_ids(["vid0"])
        errs.append(str(e.value))
    assert errs[0] == errs[1]
    spc.attach_bank(bank_of(feats, spatial=True))
    assert len(spc.caption_ids(["vid0", "vid2"])) == 2


def test_sharded_bank_is_not_ported():
    """A bank is sharded over a mesh's data axis: a mesh without one is
    refused; on a 2-D (data x model) mesh the ranks of a model group hold
    the same rows, those of their data rank (the ranks' own runs are
    tests/test_torch_sharded_serving.py's)."""
    from stvd_torch.data.bank import to_device_sharded

    class Mesh2D:
        """A 2 x 2 DeviceMesh's bookkeeping at rank (data, model)."""
        mesh_dim_names = ("data", "model")

        def __init__(self, data, model):
            self.ranks = {"data": data, "model": model}

        def size(self, dim=None):
            return 2

        def get_local_rank(self, name=None):
            return self.ranks[name]

    cap = port_captioner()
    with pytest.raises(ValueError, match="'data'"):
        cap.attach_bank(bank_of(request(n=2)), mesh=object())
    assert cap.bank_ids == []
    bank = bank_of(request(n=3))
    shards = {(d, m): to_device_sharded(bank, Mesh2D(d, m), "cpu")
              for d in (0, 1) for m in (0, 1)}
    for d in (0, 1):
        for k, v in shards[(d, 0)].items():
            assert v.shape[0] == 2
            assert torch.equal(v, shards[(d, 1)][k])
    assert torch.equal(shards[(1, 0)]["frames"][0],
                       torch.from_numpy(bank.frames[2]))
    assert not shards[(1, 1)]["frame_mask"][1].any()     # the pad row


def test_swap_params_matches_a_fresh_captioner():
    from stvd.export_aot import _check_swap_compatible as jcheck
    feats = request(n=4, seed=8)
    cap = port_captioner(seed=22)
    old = cap.params
    before = {k: v.clone() for k, v in old.items()}
    new = numpy_params(CFG, seed=23)
    bad_key = dict(new, extra=np.zeros(2, np.float32))
    del bad_key["Wemb"]
    bad_shape = dict(new, ff_logit_b=np.zeros(3, np.float32))
    for bad in (bad_key, bad_shape):
        with pytest.raises(ValueError) as e:
            cap.swap_params(bad)
        with pytest.raises(ValueError) as je:
            jcheck({k: jnp.asarray(v) for k, v in numpy_params(
                CFG, seed=22).items()}, bad)
        assert str(e.value) == str(je.value)
        assert cap.params is old
    cap.swap_params(new)
    assert cap.params is not old
    assert cap.caption(feats) == port_captioner(seed=23).caption(feats)
    for k, v in old.items():     # the old dict's tensors are untouched
        assert torch.equal(v, before[k]), k


def test_caption_sample_matches_jax_where_no_draw_is_made():
    feats = request(n=3, seed=9)
    cap = port_captioner()
    batch = tapi.pack_request(CFG, feats, device="cpu")
    got = cap.caption_sample(batch, temperature=0.0, n_samples=2)
    want = jax_captioner().caption_sample(japi.pack_request(CFG, feats),
                                          temperature=0.0, n_samples=2)
    assert got == want and len(got) == 3 and len(got[0]) == 2
    drawn = cap.caption_sample(batch, torch.Generator().manual_seed(1),
                               temperature=1.0, top_k=5, n_samples=4)
    words = {w for caps in drawn for c in caps for w in c.split()}
    assert words <= set(VOCAB.word_to_id)


@pytest.fixture(scope="module")
def sibling_run_dirs(tmp_path_factory):
    from test_torch_cli import make_run_dirs
    return make_run_dirs(tmp_path_factory.mktemp("api_runs"))


@pytest.mark.parametrize("best,quant", [(True, None), (False, None),
                                        (True, "int8")])
def test_from_run_dir_matches_jax(sibling_run_dirs, best, quant):
    from test_torch_cli import MCFG
    jdir, tdir = sibling_run_dirs
    cap = tapi.Captioner.from_run_dir(tdir, best=best, quant=quant,
                                      device="cpu")
    jcap = japi.Captioner.from_run_dir(jdir, best=best, quant=quant)
    assert cap.cfg.to_json() == jcap.cfg.to_json()
    assert cap.vocab.word_to_id == jcap.vocab.word_to_id
    assert cap.device == torch.device("cpu")
    feats = np.random.RandomState(3).randn(
        5, MCFG.n_frames, MCFG.ctx_dim).astype(np.float32)
    assert cap.caption(feats) == jcap.caption(feats)


def test_from_run_dir_prefers_the_best_checkpoint(sibling_run_dirs,
                                                   tmp_path):
    import shutil
    _, tdir = sibling_run_dirs
    run = str(tmp_path / "run")
    shutil.copytree(tdir, run)
    path = os.path.join(run, "ckpt_best.pt")
    blob = torch.load(path, weights_only=True)
    blob["params"]["ff_logit_b"] = blob["params"]["ff_logit_b"] + 1.0
    torch.save(blob, path)
    best = tapi.Captioner.from_run_dir(run, device="cpu")
    last = tapi.Captioner.from_run_dir(run, best=False, device="cpu")
    assert torch.equal(best.params["ff_logit_b"],
                       last.params["ff_logit_b"] + 1.0)
    os.remove(path)        # no best: the latest
    assert torch.equal(tapi.Captioner.from_run_dir(run, device="cpu")
                       .params["ff_logit_b"], last.params["ff_logit_b"])
    os.remove(os.path.join(run, "vocab.pkl"))
    with pytest.raises(ValueError, match="vocab.pkl"):
        tapi.Captioner.from_run_dir(run, device="cpu")
    assert tapi.Captioner.from_run_dir(run, vocab=VOCAB,
                                       device="cpu").vocab is VOCAB
