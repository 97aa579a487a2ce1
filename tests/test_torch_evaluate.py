"""The port's split evaluation (``stvd_torch.train.evaluate``) and model
selection (``stvd_torch.train.loop.fit``) against the JAX package's.

Both packages decode the same numpy weights (``params_from_numpy``) on
the same split at float32 on the CPU, where the port runs its plain step
and the JAX package its jnp step.  Tokens must be identical, the samples
files byte-identical and the score dicts equal (``==``): the port scores
with its own copies of the metrics, its BLEU and CIDEr in Python
(tests/test_torch_metrics.py says why), so the JAX package's scorer runs
here with its native core off.  ``fit``'s dropout draws differ from the
JAX package's, so ``fit`` is held to the JAX package's evaluation of
the port's own weights at each round, not to JAX training.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stvd import config as jconfig
from stvd.data import batching as jbatching
from stvd.metrics import _native as jnative
from stvd.train import evaluate as jevaluate
from stvd_torch import config as tconfig
from stvd_torch.data import batching as tbatching
from stvd_torch.data.bank import to_device
from stvd_torch.model.convert import params_from_numpy, params_to_numpy
from stvd_torch.train import evaluate as tevaluate
from stvd_torch.train import loop as tloop

from test_torch_step import numpy_params

MODEL = dict(n_words=48, dim_word=16, dim=24, ctx_dim=32, n_frames=6,
             compute_dtype="float32")


def configs(save_dir="", beam=3, decode_batch=3, profile="meteor2005",
            **train):
    """Preset 3 (``msvd-beam``) cut to a tiny float32 model, in both
    packages (the JAX one from the port's JSON)."""
    t = tconfig.preset("msvd-beam")
    t = t.replace(
        model=dataclasses.replace(t.model, **MODEL),
        decode=dataclasses.replace(t.decode, beam_size=beam, maxlen=10,
                                   decode_batch=decode_batch),
        train=dataclasses.replace(t.train, meteor_profile=profile,
                                  save_dir=str(save_dir), **train))
    return t, jconfig.Config.from_json(t.to_json())


def datasets(n_videos=7, seed=0, no_refs=(2,)):
    """The same synthetic split in both packages; the videos in
    ``no_refs`` lose their references."""
    kw = dict(n_videos=n_videos, k=6, d=32, maxlen=10, seed=seed,
              n_words=48)
    t, j = tbatching.synthetic_dataset(**kw), jbatching.synthetic_dataset(
        **kw)
    for r in no_refs:
        t.references[r] = []
        j.references[r] = []
    return t, j


@pytest.fixture
def jax_python_scorer(monkeypatch):
    """The JAX package's scorer with its native core off."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_checked", True)


@pytest.fixture(params=["native", "python"])
def mode(request, monkeypatch, jax_python_scorer):
    if request.param == "python":
        monkeypatch.setenv("STVD_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("STVD_NO_NATIVE", raising=False)
    return request.param


@pytest.mark.parametrize("profile", ["meteor2005", "meteor15-en"])
@pytest.mark.parametrize("beam", [1, 3])
def test_evaluate_split_matches_jax(tmp_path, beam, profile, mode):
    """Seven videos at decode batch 3 (the last batch padded with row 0),
    one of them without references: identical tokens, equal scores and
    byte-identical ``valid_samples.txt``/``.json``."""
    tcfg, jcfg = configs(beam=beam, profile=profile)
    tds, jds = datasets()
    p = numpy_params(jconfig.ModelConfig(**MODEL))
    tp = params_from_numpy(p, "cpu")
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    got_rows = tevaluate.generate_captions(
        tp, tcfg.model, to_device(tds.bank, "cpu"), 7, tcfg.decode)
    want_rows = jevaluate.generate_captions(
        jp, jcfg.model, jds.bank.to_device(), 7, jcfg.decode)
    assert got_rows == want_rows
    assert len({tuple(r) for r in got_rows}) > 1      # not one caption
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = tevaluate.evaluate_split(tp, tcfg, tds, "valid",
                                   str(tmp_path / "port"), device="cpu")
    want = jevaluate.evaluate_split(jp, jcfg, jds, "valid",
                                    str(tmp_path / "jax"))
    assert got == want
    for name in ("valid_samples.txt", "valid_samples.json"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    lines = (tmp_path / "port" / "valid_samples.txt").read_text().splitlines()
    assert [ln.split("\t")[0] for ln in lines] == [
        v for i, v in enumerate(tds.bank.ids) if i != 2]


def test_evaluate_split_scores_an_empty_caption_as_unk(tmp_path,
                                                       jax_python_scorer):
    """A model whose first word is always EOS: every caption is empty and
    is scored and written as "unk", in both packages."""
    tcfg, jcfg = configs(beam=1)
    tds, jds = datasets(n_videos=4, no_refs=())
    p = numpy_params(jconfig.ModelConfig(**MODEL))
    p["ff_logit_b"] = p["ff_logit_b"].copy()
    p["ff_logit_b"][0] = 1e4                       # EOS wins every step
    got = tevaluate.evaluate_split(params_from_numpy(p, "cpu"), tcfg, tds,
                                   "test", str(tmp_path), device="cpu")
    want = jevaluate.evaluate_split({k: jnp.asarray(v) for k, v in p.items()},
                                    jcfg, jds, "test", None)
    assert got == want
    caps = json.loads((tmp_path / "test_samples.json").read_text())
    assert [c["caption"] for c in caps] == ["unk"] * 4


def test_evaluate_split_takes_the_step_for_its_device(monkeypatch):
    """``step_fn=None`` is ``get_step_fn(None, device)``: the plain step
    on the CPU (the kernel step on a CUDA device)."""
    seen = []
    real = tevaluate.get_step_fn

    def spy(use, device):
        seen.append((use, device))
        return real(use, device)

    monkeypatch.setattr(tevaluate, "get_step_fn", spy)
    tcfg, _ = configs(beam=1)
    tds, _ = datasets(n_videos=2, no_refs=())
    p = params_from_numpy(numpy_params(jconfig.ModelConfig(**MODEL)), "cpu")
    tevaluate.evaluate_split(p, tcfg, tds, device="cpu")
    assert seen == [(None, "cpu")]


# ---------------------------------------------------------------------------
# fit: model selection by caption metrics
# ---------------------------------------------------------------------------

def fit_configs(save_dir, **train):
    kw = dict(batch_size=4, metric="meteor", disp_freq=1, valid_freq=2,
              sample_freq=0, save_freq=0, patience=20)
    return configs(save_dir, beam=3, decode_batch=4, **{**kw, **train})


def records(save_dir, kind=None):
    """The records of ``metrics.jsonl``, without the logger's clock
    (``elapsed_s``)."""
    recs = [json.loads(ln) for ln in
            (save_dir / "metrics.jsonl").read_text().splitlines()]
    for r in recs:
        r.pop("elapsed_s")
    return [r for r in recs if kind is None or r["kind"] == kind]


@pytest.fixture
def jax_rounds(monkeypatch):
    """Wrap the port's ``evaluate_split`` inside ``fit``: at each call,
    also run the JAX package's ``evaluate_split`` on the port's weights
    (as numpy), and keep both with the weights."""
    rounds, rounds_datasets = [], {}
    real = tloop.evaluate_split

    def both(params, cfg, ds, split="valid", save_dir=None, step_fn=None,
             *, device="cuda"):
        got = real(params, cfg, ds, split, save_dir, step_fn, device=device)
        p = params_to_numpy(params)
        jds = rounds_datasets[split]
        want = jevaluate.evaluate_split(
            {k: jnp.asarray(v) for k, v in p.items()},
            jconfig.Config.from_json(cfg.to_json()), jds, split, None)
        rounds.append({"split": split, "got": dict(got), "want": want,
                       "params": p})
        return got

    monkeypatch.setattr(tloop, "evaluate_split", both)
    return rounds, rounds_datasets


def test_fit_selects_by_meteor_as_jax_scores_it(tmp_path, jax_rounds,
                                                jax_python_scorer):
    """``fit(metric='meteor')`` with ``test_ds`` and length buckets: each
    ``valid`` and ``test`` record's scores equal the JAX package's
    ``evaluate_split`` of the port's weights at that round, the valid
    record comes first, ``best`` records and ``ckpt_best.pt`` follow the
    best valid METEOR (first of equals), and samples come every
    ``sample_freq`` updates."""
    rounds, rds = jax_rounds
    tcfg, _ = fit_configs(tmp_path, length_buckets="5,8", sample_freq=3,
                          optimizer="adam", lr=0.05)
    tr, _ = datasets(n_videos=6, seed=0, no_refs=())
    va, jva = datasets(n_videos=5, seed=1)
    te, jte = datasets(n_videos=3, seed=2, no_refs=())
    rds.update(valid=jva, test=jte)
    out = tloop.fit(tcfg, tr, va, test_ds=te, max_updates=8, device="cpu")
    assert [r["split"] for r in rounds] == ["valid", "test"] * 4
    valid = records(tmp_path, "valid")
    test = records(tmp_path, "test")
    assert [r["update"] for r in valid] == [r["update"] for r in test] == [
        2, 4, 6, 8]
    for rec, rnd in zip(
            [r for pair in zip(valid, test) for r in pair], rounds):
        assert rec["kind"] == rnd["split"]
        assert {k: rec[k] for k in rnd["want"]} == rnd["want"]
        assert np.isfinite(rec["nll"])
    meteor = [r["METEOR"] for r in valid]
    best_i = int(np.argmax(meteor))
    bests = records(tmp_path, "best")
    assert bests[-1] == {"kind": "best", "update": valid[best_i]["update"],
                         "metric": "meteor", "value": meteor[best_i]}
    assert out.best_metric == meteor[best_i]
    assert out.best_step == valid[best_i]["update"]
    blob = torch.load(tmp_path / "ckpt_best.pt", weights_only=True)
    assert blob["step"] == out.best_step
    for k, v in rounds[2 * best_i]["params"].items():
        np.testing.assert_array_equal(blob["params"][k].numpy(), v)
    assert [r["update"] for r in records(tmp_path, "sample")] == [
        3, 3, 6, 6]
    assert (tmp_path / "test_samples.txt").is_file()
    assert [h["update"] for h in out.history] == [2, 4, 6, 8]


def test_fit_uses_length_buckets(tmp_path, monkeypatch):
    """With ``length_buckets='4,6'`` and maxlen 10, every update runs at
    a bucket's length (10 added as the last bucket), in the order the JAX
    package's iterator draws them."""
    lengths = []
    real = tloop.make_train_step

    def spy(mcfg, tcfg, step_fn=None):
        step = real(mcfg, tcfg, step_fn)

        def train_step(state, batch):
            lengths.append(batch["tokens"].shape[1])
            return step(state, batch)
        return train_step

    monkeypatch.setattr(tloop, "make_train_step", spy)
    tcfg, _ = fit_configs(tmp_path, length_buckets="4,6", valid_freq=0,
                          maxlen=10)
    tr, jtr = datasets(n_videos=8, seed=3, no_refs=())
    tloop.fit(tcfg, tr, max_updates=6, device="cpu")
    lens = jtr.captions.mask.sum(axis=1).astype(np.int64)
    want = jbatching.BucketedBatchIterator(lens, 4, (4, 6, 10),
                                           seed=tcfg.train.seed)
    drawn = [t for _ in range(3) for _, _, t in want.epoch()]
    assert lengths == drawn[:6]
    assert set(lengths) <= {4, 6, 10} and len(set(lengths)) > 1


def test_fit_stops_early_at_patience(tmp_path, jax_python_scorer):
    """Weights that do not move (sgd at lr 0) score the same every round:
    round 1 is best, and ``patience`` = 2 rounds later ``early_stop``
    ends the run (the JAX loop's order: no ``save_freq`` checkpoint
    after it, the final ``ckpt.pt`` at that update)."""
    tcfg, _ = fit_configs(tmp_path, optimizer="sgd", lr=0.0, clip_c=0.0,
                          valid_freq=1, patience=2, save_freq=1)
    tr, _ = datasets(n_videos=4, seed=0, no_refs=())
    va, _ = datasets(n_videos=3, seed=1, no_refs=())
    out = tloop.fit(tcfg, tr, va, max_updates=20, device="cpu")
    assert out.state["step"] == 3 and out.bad_rounds == 2
    assert records(tmp_path, "early_stop") == [
        {"kind": "early_stop", "update": 3, "bad_rounds": 2}]
    assert [r["update"] for r in records(tmp_path, "best")] == [1]
    assert records(tmp_path)[-1]["kind"] == "early_stop"
    assert out.best_step == 1
    assert torch.load(tmp_path / "ckpt.pt", weights_only=True)["step"] == 3


@pytest.mark.parametrize("metric", ["nll", "meteor"])
def test_fit_resume_checks_the_metric(tmp_path, metric, jax_python_scorer):
    """A run saved under METEOR resumed under ``metric``: the weights and
    step come back either way; under NLL the old best, bad rounds and
    history are dropped (patience restarts), under METEOR they are
    kept, as the JAX package's ``load_fit_state`` decides."""
    tcfg, _ = fit_configs(tmp_path, valid_freq=2)
    tr, _ = datasets(n_videos=4, seed=0, no_refs=())
    va, _ = datasets(n_videos=3, seed=1, no_refs=())
    first = tloop.fit(tcfg, tr, va, max_updates=4, device="cpu")
    assert first.best_metric == max(h["METEOR"] for h in first.history)
    again = tcfg.replace(train=dataclasses.replace(
        tcfg.train, reload_=True, metric=metric))
    resumed = tloop.fit(again, tr, va, max_updates=6, device="cpu")
    reload = records(tmp_path, "reload")[-1]
    assert reload["step"] == 4 and resumed.state["step"] == 6
    for k, v in first.state["params"].items():
        assert v.shape == resumed.state["params"][k].shape
    if metric == "nll":
        assert reload["best"] == float("inf") and reload["bad_rounds"] == 0
        assert [h["update"] for h in resumed.history] == [6]
        assert resumed.best_step == 6
        assert resumed.best_metric == resumed.history[0]["nll"]
    else:
        assert reload["best"] == first.best_metric
        assert [h["update"] for h in resumed.history] == [2, 4, 6]


def test_metric_keys_and_perplexity_match_jax():
    """``train.metric`` names the score ``fit`` selects by (with the
    reference's misspelled 'blue'), and the perplexity of a per-token
    NLL, clipped at 50, as in the JAX package."""
    from stvd.train import loop as jloop
    for name in ("meteor", "bleu4", "blue", "cider", "rouge", "nll"):
        assert tloop._metric_key(name) == jloop._metric_key(name)
    assert tloop._metric_key("blue") == "Bleu_4"
    for nll in (0.0, 1.7, 49.9, 50.0, 80.0):
        assert tloop.perplexity(nll) == jloop.perplexity(nll)
