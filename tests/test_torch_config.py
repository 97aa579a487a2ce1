"""The port's own copies of the JAX package's framework-free modules
(config, vocabulary, feature-bank packing) against the originals, and a
guard that the port imports neither jax nor anything of ``stvd``."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from stvd import config as jconfig
from stvd.data import bank as jbank
from stvd.data import text as jtext
from stvd_torch import config as tconfig
from stvd_torch.data import bank as tbank
from stvd_torch.data import text as ttext

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = ("msvd-temporal", "msvd-spatial", "msvd-beam", "msrvtt-fused",
           "msvd-dp")


def test_port_imports_neither_jax_nor_stvd():
    """Every module of ``stvd_torch`` imports in a process where ``jax``,
    ``stvd`` and ``nltk`` cannot be imported at all (a card's machine
    has no nltk), and the caption metrics score there."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['stvd'] = None\n"
        "sys.modules['nltk'] = None\n"
        "import stvd_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    stvd_torch.__path__, 'stvd_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'stvd_torch.train.loop' in names, names\n"
        "for n in ('tokenizer', 'stem', 'bleu', 'meteor', 'rouge', 'cider',\n"
        "          'scorer', '_native'):\n"
        "    assert 'stvd_torch.metrics.' + n in names, n\n"
        "for n in ('cli.train', 'cli.sample', 'cli.score', 'cli.convert',\n"
        "          'cli.serve', 'utils.logging', 'utils.profiling',\n"
        "          'utils.debug', 'decode.sample', 'model.importer',\n"
        "          'export_aot', 'cli.export', 'train.parallel'):\n"
        "    assert 'stvd_torch.' + n in names, n\n"
        "from stvd_torch.metrics.scorer import score_all\n"
        "s = score_all({'a': ['a man is running']}, {'a': ['men run']},\n"
        "              meteor_profile='meteor15-en')\n"
        "assert s['METEOR'] > 0, s\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 26


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_jax(name):
    assert (dataclasses.asdict(tconfig.preset(name))
            == dataclasses.asdict(jconfig.preset(name)))


def test_config_json_round_trips_between_packages():
    cfg = jconfig.preset("msvd-spatial")
    assert tconfig.Config.from_json(cfg.to_json()).to_json() == cfg.to_json()


@pytest.mark.parametrize("section,field,value", [
    ("model", "n_words", 3), ("train", "optimizer", "lamb"),
    ("train", "meteor_profile", "meteor99"),
    ("model", "spatial_bwd_kernel", "maybe"), ("train", "ss_prob", 1.5),
    ("train", "grad_accum", 3), ("train", "length_buckets", "a,b"),
    ("train", "opt_slot_dtype", "float16")])
def test_validate_rejects_what_jax_rejects(section, field, value):
    def bad(mod):
        cfg = mod.preset("msvd-beam")
        sec = dataclasses.replace(getattr(cfg, section), **{field: value})
        return cfg.replace(**{section: sec})
    with pytest.raises(ValueError):
        jconfig.validate(bad(jconfig))
    with pytest.raises(ValueError):
        tconfig.validate(bad(tconfig))
    for name in PRESETS:
        tconfig.validate(tconfig.preset(name))


def test_vocab_and_caption_encoding_match_jax():
    corpus = [jtext.tokenize(s) for s in (
        "A man is playing a guitar.", "The man's dog runs; a dog barks",
        "Two cats", "a man is cooking 2 eggs")]
    jv = jtext.Vocab.build(corpus, max_words=9)
    tv = ttext.Vocab.build([ttext.tokenize(s) for s in (
        "A man is playing a guitar.", "The man's dog runs; a dog barks",
        "Two cats", "a man is cooking 2 eggs")], max_words=9)
    assert tv.word_to_id == jv.word_to_id and len(tv) == len(jv)
    jt, jm = jtext.encode_captions(corpus, jv, maxlen=5, n_words=7)
    tt, tm = ttext.encode_captions(corpus, tv, maxlen=5, n_words=7)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tm, jm)
    assert tv.decode([3, 2, ttext.EOS_ID, 4]) == jv.decode([3, 2, 0, 4])
    assert (ttext.EOS_ID, ttext.UNK_ID) == (jtext.EOS_ID, jtext.UNK_ID)


def test_pack_and_synthetic_banks_match_jax():
    kw = dict(n_videos=5, k=6, d=8, n_regions=3, region_dim=4,
              motion_dim=5, seed=2)
    jb, tb = jbank.synthetic_bank(**kw), tbank.synthetic_bank(**kw)
    assert list(tb.ids) == list(jb.ids)
    for f in ("frames", "frame_mask", "regions", "motion"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), f)
    rng = np.random.RandomState(0)
    feats = {"b": rng.randn(9, 8), "a": rng.randn(2, 8)}
    jp, tp = jbank.pack_bank(feats, 4), tbank.pack_bank(feats, 4)
    assert list(tp.ids) == list(jp.ids) == ["a", "b"]
    np.testing.assert_array_equal(tp.frames, jp.frames)
    np.testing.assert_array_equal(tp.frame_mask, jp.frame_mask)
    np.testing.assert_array_equal(tbank.subsample_frames(feats["b"], 4),
                                  jbank.subsample_frames(feats["b"], 4))
