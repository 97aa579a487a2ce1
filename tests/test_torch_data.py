"""The port's data layer from disk against the JAX package's: feature
banks (``.npz`` and legacy pickles), vocabularies, caption files, splits
(``stvd_torch.data.corpus``), the synthetic split builders
(``stvd_torch.data.synthetic``) and length-bucketed batching.

Files are written under ``tmp_path`` (the Python 2 pickles come from
``tests/fixtures``); every comparison is exact.
"""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch

from stvd import config as jconfig
from stvd.data import bank as jbank
from stvd.data import batching as jbatching
from stvd.data import corpus as jcorpus
from stvd.data import synthetic as jsynthetic
from stvd.data import text as jtext
from stvd_torch import config as tconfig
from stvd_torch.data import bank as tbank
from stvd_torch.data import batching as tbatching
from stvd_torch.data import corpus as tcorpus
from stvd_torch.data import synthetic as tsynthetic
from stvd_torch.data import text as ttext

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures")
STREAMS = ("frames", "frame_mask", "regions", "motion")


def assert_banks_equal(a, b):
    assert list(a.ids) == list(b.ids)
    for f in STREAMS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, f)


def assert_datasets_equal(t, j):
    assert_banks_equal(t.bank, j.bank)
    for f in ("video_idx", "tokens", "mask"):
        np.testing.assert_array_equal(getattr(t.captions, f),
                                      getattr(j.captions, f), f)
    assert t.vocab.word_to_id == j.vocab.word_to_id
    assert t.references == j.references


@pytest.mark.parametrize("streams", [dict(), dict(n_regions=3, motion_dim=5)])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_banks_load_in_the_other_package(tmp_path, writer, streams):
    kw = dict(n_videos=5, k=6, d=8, region_dim=4, seed=3, **streams)
    src, dst = (tbank, jbank) if writer == "port" else (jbank, tbank)
    bank = src.synthetic_bank(**kw)
    path = str(tmp_path / "bank.npz")
    bank.save(path)
    loaded = dst.FeatureBank.load(path)
    assert_banks_equal(loaded, bank)
    assert_banks_equal(tbank.FeatureBank.load(path),
                       jbank.FeatureBank.load(path))


@pytest.mark.parametrize("path", ["written", "py2_FEAT.pkl"])
def test_load_legacy_pickle_matches_jax(tmp_path, path):
    if path == "written":
        rng = np.random.RandomState(0)
        feats = {f"vid{i}": rng.randn(3 + i, 4).astype(np.float32)
                 for i in range(4)}
        feats[7] = rng.randn(2, 4)        # a non-string key becomes str
        path = str(tmp_path / "FEAT.pkl")
        with open(path, "wb") as f:
            pickle.dump(feats, f, protocol=2)
    else:
        path = os.path.join(FIXDIR, path)
    got, want = tbank.load_legacy_pickle(path), jbank.load_legacy_pickle(path)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_vocab_pickles_round_trip_between_packages(tmp_path):
    corpus = [jtext.tokenize(s) for s in (
        "a man is playing a guitar", "the man's dog runs", "a caf\xe9")]
    tv = ttext.Vocab.build(corpus, max_words=8)
    tv.save_pickle(str(tmp_path / "port.pkl"))
    jv = jtext.Vocab.build(corpus, max_words=8)
    jv.save_pickle(str(tmp_path / "jax.pkl"))
    assert ((tmp_path / "port.pkl").read_bytes()
            == (tmp_path / "jax.pkl").read_bytes())
    for name in ("port.pkl", "jax.pkl"):
        p = str(tmp_path / name)
        assert (ttext.Vocab.load_pickle(p).word_to_id
                == jtext.Vocab.load_pickle(p).word_to_id == tv.word_to_id)
    py2 = os.path.join(FIXDIR, "py2_worddict.pkl")
    t2, j2 = ttext.Vocab.load_pickle(py2), jtext.Vocab.load_pickle(py2)
    assert t2.word_to_id == j2.word_to_id and len(t2) == len(j2)


@pytest.mark.parametrize("kind", ["json", "pickle", "py2_CAP.pkl"])
def test_load_captions_matches_jax(tmp_path, kind):
    if kind == "json":
        path = str(tmp_path / "caps.json")
        with open(path, "w") as f:
            json.dump({"v1": ["A man is playing a guitar.", "Two dogs!"],
                       "v2": [["already", "split"]], "v3": []}, f)
    elif kind == "pickle":
        path = str(tmp_path / "CAP.pkl")
        caps = {"v1": [{"tokenized": "A Man plays"}, {"caption": "Dogs, run"}],
                "v2": ["plain string caption"], 3: [{"caption": ""}]}
        with open(path, "wb") as f:
            pickle.dump(caps, f, protocol=2)
    else:
        path = os.path.join(FIXDIR, kind)
    assert tcorpus.load_captions(path) == jcorpus.load_captions(path)


def _write_split_files(d, ids):
    for name, members in (("train", ids[:3]), ("valid", ids[3:4]),
                          ("test", ids[4:6])):
        (d / f"{name}_ids.txt").write_text("\n".join(members) + "\n\n")


@pytest.mark.parametrize("route", ["files", "youtube2text", "msrvtt",
                                   "seeded"])
def test_split_ids_matches_jax(tmp_path, route):
    """The four routes: explicit ``{split}_ids.txt`` lists, the canonical
    MSVD and MSR-VTT splits by video number, the seeded 80/10/10."""
    if route == "files":
        ids, dataset = [f"v{i}" for i in range(8)], "youtube2text"
        _write_split_files(tmp_path, ids)
    elif route == "youtube2text":
        ids, dataset = [f"vid{i}" for i in range(1, 1971, 7)], route
    elif route == "msrvtt":
        ids, dataset = [f"video{i}" for i in range(0, 10000, 13)], route
    else:
        ids, dataset = [f"clip{i}" for i in range(57)], "synthetic"
    for seed in (0, 5):
        got = tcorpus.split_ids(ids, str(tmp_path), seed=seed,
                                dataset=dataset)
        assert got == jcorpus.split_ids(ids, str(tmp_path), seed=seed,
                                        dataset=dataset)
        assert sum(map(len, got.values())) == (6 if route == "files"
                                               else len(ids))


def both_configs(**sections):
    """The same config in both packages, from JSON."""
    t = tconfig.Config()
    t = t.replace(**{k: dataclasses.replace(getattr(t, k), **v)
                     for k, v in sections.items()})
    return t, jconfig.Config.from_json(t.to_json())


MODEL = dict(n_words=40, dim_word=8, dim=16, ctx_dim=8, n_frames=4,
             compute_dtype="float32")


def test_load_splits_from_disk_matches_jax(tmp_path):
    """An ``.npz`` bank saved by the port, a captions JSON, a vocabulary
    pickle and explicit split lists, read back by both packages."""
    bank = tbank.synthetic_bank(9, k=4, d=8, seed=1)
    bank = dataclasses.replace(bank, ids=[f"v{i}" for i in range(9)])
    bank.save(str(tmp_path / "feats.npz"))
    rng = np.random.RandomState(0)
    words = "a man dog runs plays the guitar in park".split()
    caps = {v: [" ".join(rng.choice(words, rng.randint(2, 9)))
                for _ in range(2)] for v in bank.ids if v != "v3"}
    (tmp_path / "caps.json").write_text(json.dumps(caps))
    ttext.Vocab.build([w.split() for c in caps.values() for w in c],
                      max_words=12).save_pickle(str(tmp_path / "vocab.pkl"))
    _write_split_files(tmp_path, bank.ids)
    t, j = both_configs(
        model=MODEL, train=dict(maxlen=6),
        data=dict(dataset="youtube2text", data_dir=str(tmp_path),
                  feature_file="feats.npz", captions_file="caps.json",
                  vocab_file="vocab.pkl"))
    got, want = tcorpus.load_splits(t), jcorpus.load_splits(j)
    assert sorted(got) == sorted(want) == ["test", "train", "valid"]
    for s in want:
        assert_datasets_equal(got[s], want[s])
    assert got["valid"].references == [[]]         # v3 has no captions
    assert got["train"].bank.n_videos == 3


@pytest.mark.parametrize("vocab", [False, True])
def test_load_splits_from_legacy_pickles_matches_jax(tmp_path, vocab):
    """Feature and region pickles packed at load time, captions from a
    pickle, the vocabulary built from the captions or read from the
    Python 2 worddict fixture; the seeded split."""
    rng = np.random.RandomState(1)
    ids = [f"v{i}" for i in range(12)]
    feats = {v: rng.randn(3 + i % 4, 8).astype(np.float32)
             for i, v in enumerate(ids)}
    regions = {v: rng.randn(len(f), 2, 4).astype(np.float32)
               for v, f in feats.items()}
    caps = {v: [{"tokenized": f"a thing number{i % 3} happens"}]
            for i, v in enumerate(ids)}
    for name, obj in (("FEAT.pkl", feats), ("REG.pkl", regions),
                      ("CAP.pkl", caps)):
        with open(tmp_path / name, "wb") as f:
            pickle.dump(obj, f, protocol=2)
    data = dict(dataset="legacy", data_dir=str(tmp_path),
                feature_file="FEAT.pkl", region_feature_file="REG.pkl",
                captions_file="CAP.pkl")
    if vocab:
        data["vocab_file"] = os.path.join(FIXDIR, "py2_worddict.pkl")
    t, j = both_configs(model=dict(MODEL, use_spatial=True, n_regions=2,
                                   region_dim=4),
                        train=dict(maxlen=8), data=data)
    got, want = tcorpus.load_splits(t), jcorpus.load_splits(j)
    for s in want:
        assert_datasets_equal(got[s], want[s])


@pytest.mark.parametrize("dataset", ["synthetic", "synthetic-structured",
                                     "synthetic-hard"])
def test_load_splits_synthetic_matches_jax(dataset):
    t, j = both_configs(model=MODEL, train=dict(maxlen=10),
                        data=dict(dataset=dataset, synthetic_videos=24))
    got, want = tcorpus.load_splits(t), jcorpus.load_splits(j)
    assert sorted(got) == sorted(want)
    for s in want:
        assert_datasets_equal(got[s], want[s])


def test_load_splits_missing_file_raises(tmp_path):
    t, _ = both_configs(data=dict(dataset="youtube2text",
                                  data_dir=str(tmp_path)))
    with pytest.raises(ValueError, match="captions"):
        tcorpus.load_splits(t)


@pytest.mark.parametrize("marker", [None, {"synthetic": True, "n": 3}])
def test_corpus_provenance_matches_jax(tmp_path, marker):
    if marker is not None:
        (tmp_path / "PROVENANCE.json").write_text(json.dumps(marker))
    got = tcorpus.corpus_provenance(str(tmp_path))
    assert got == jcorpus.corpus_provenance(str(tmp_path))
    assert got.get("synthetic") == (marker or {}).get("synthetic")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(hard=True, n_regions=3, motion_dim=6, seed=2),
    dict(n_train=40, n_valid=8, n_test=8, k=5, d=16, maxlen=9, noise=0.1),
])
def test_structured_splits_match_jax(kw):
    got, want = (tsynthetic.structured_splits(**kw),
                 jsynthetic.structured_splits(**kw))
    assert sorted(got) == sorted(want)
    for s in want:
        assert_datasets_equal(got[s], want[s])


@pytest.mark.parametrize("kw", [
    dict(),
    dict(subject_in="frames", verb_in="motion", motion_dim=6, n_regions=0,
         seed=1),
    dict(p_generic=0.4, confusable=0.9),
    dict(p_generic=0.05),          # n_gen = 0: kept as the JAX package has it
])
def test_discriminative_splits_match_jax(kw):
    kw = dict(n_train=60, n_valid=8, n_test=12, **kw)
    got, lat_t = tsynthetic.discriminative_splits(with_latents=True, **kw)
    want, lat_j = jsynthetic.discriminative_splits(with_latents=True, **kw)
    assert lat_t == lat_j
    for s in want:
        assert_datasets_equal(got[s], want[s])


def test_discriminative_splits_reject_what_jax_rejects():
    for kw in (dict(subject_in="x"), dict(verb_in="motion"),
               dict(n_regions=0), dict(n_train=5000)):
        with pytest.raises(ValueError):
            jsynthetic.discriminative_splits(**kw)
        with pytest.raises(ValueError):
            tsynthetic.discriminative_splits(**kw)


@pytest.mark.parametrize("shuffle", [True, False])
def test_bucketed_batches_match_jax(shuffle):
    """Three epochs of ``(idx, w, T)`` from one seed, buckets that leave
    one empty, ragged tails and a length at a bucket's edge."""
    rng = np.random.RandomState(4)
    lengths = np.concatenate([rng.randint(2, 11, 37), [20, 30, 30]])
    kw = dict(batch_size=8, buckets=(10, 20, 25, 30), seed=9,
              shuffle=shuffle)
    t = tbatching.BucketedBatchIterator(lengths, **kw)
    j = jbatching.BucketedBatchIterator(lengths, **kw)
    assert t.buckets == j.buckets and t.n == j.n
    for _ in range(3):
        got, want = list(t.epoch()), list(j.epoch())
        assert len(got) == len(want)
        for (ti, tw, tt), (ji, jw, jt) in zip(got, want):
            assert tt == jt and ti.dtype == ji.dtype
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tw, jw)
    with pytest.raises(ValueError):
        tbatching.BucketedBatchIterator([31], 4, (10, 30))


@pytest.mark.parametrize("seq_len", [0, 4, 7])
def test_gather_batch_seq_len_matches_jax(seq_len):
    kw = dict(n_videos=5, k=6, d=8, n_regions=2, region_dim=4, maxlen=10,
              seed=0)
    td, jd = tbatching.synthetic_dataset(**kw), jbatching.synthetic_dataset(
        **kw)
    idx = np.asarray([3, 0, 7, 7, 1], np.int32)
    got = tbatching.gather_batch(tbank.to_device(td.bank, "cpu"),
                                 td.captions, idx, seq_len=seq_len)
    want = jbatching.gather_batch(jd.bank.to_device(), jd.captions, idx,
                                  seq_len=seq_len)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), k)
    assert got["tokens"].shape[1] == (seq_len or 10)
    assert got["tokens"].dtype == torch.int64
