"""The port's caption metrics (``stvd_torch.metrics``) against the JAX
package's (``stvd.metrics``), its stemmers against NLTK's, and its own
build of the C++ metrics core.

Scores are compared with ``==``: both packages run the same Python code
and load the same C++ source, so they agree bit for bit in each mode
(native core, or pure Python under ``STVD_NO_NATIVE=1``).  One
difference is by design: the C core keys BLEU's and CIDEr's n-grams by a
64-bit mix of token ids that is not injective (interned bigrams (44, 16)
and (45, 81) share a key, and the random corpus below hits such a pair),
so the port counts n-grams in Python in both modes, and its BLEU and
CIDEr equal the JAX package's pure-Python scores; its METEOR and ROUGE-L
equal the JAX package's in each mode.
"""

import json
import os
import string
import subprocess
import sys
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from stvd.metrics import _native as jnative
from stvd.metrics import bleu as jbleu
from stvd.metrics import cider as jcider
from stvd.metrics import meteor as jmeteor
from stvd.metrics import rouge as jrouge
from stvd.metrics import scorer as jscorer
from stvd.metrics import tokenizer as jtok
from stvd_torch.metrics import _native as tnative
from stvd_torch.metrics import bleu as tbleu
from stvd_torch.metrics import cider as tcider
from stvd_torch.metrics import meteor as tmeteor
from stvd_torch.metrics import rouge as trouge
from stvd_torch.metrics import scorer as tscorer
from stvd_torch.metrics import stem as tstem
from stvd_torch.metrics import tokenizer as ttok

from test_metrics import _STEM_FUZZ_WORDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNONYMS = os.path.join(REPO, "tests", "fixtures", "synonyms_en_mini.json")
PROFILES = ("meteor2005", "meteor15-en")
METRICS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
           "CIDEr")

# the corpora of tests/test_metrics.py and tests/test_native.py, one
# video each
SMALL = {
    "gts": {"p1": ["a man is playing a guitar", "someone plays the guitar"],
            "p2": ["a dog is running in a park"],
            "n1": ["a man is playing a guitar loudly",
                   "someone plays the guitar"],
            "n3": ["two people are cooking food in a kitchen"],
            "m1": ["the cat sat on the mat"],
            "s1": ["a puppy runs"], "s2": ["a large dog"],
            "s3": ["a big dog"], "b1": ["the the cat sat"],
            "b2": ["a b a"], "z1": ["a b"]},
    "res": {"p1": ["a man is playing a guitar"],
            "p2": ["a dog runs in the park"],
            "n1": ["a man plays a guitar"], "n3": ["people cook food"],
            "m1": ["the cat sat on mat"], "s1": ["a dog runs"],
            "s2": ["a big dog"], "s3": ["a large dog"],
            "b1": ["the cat sat the"], "b2": ["a"],
            "z1": ["zebra piano"]},
}

_WORDS = (list(_STEM_FUZZ_WORDS)
          + "a the is in on at of man woman dog cat car big large huge "
            "quick fast street road guy lady child kid slice cut play "
            "perform ride drive puppy hound feline automobile playing "
            "plays guitar park kitchen don't man's they're".split())


def random_corpus(n_videos=240, seed=0):
    """Raw-caption corpus: 1-5 references of 1-18 words a video, words
    from the stemmer fuzz list, the synonym fixture and clitics, and one
    reference of 70 words (past the native aligner's 62-token mask)."""
    rng = np.random.RandomState(seed)
    gts, res = {}, {}
    for v in range(n_videos):
        gts[f"vid{v}"] = [" ".join(rng.choice(_WORDS, rng.randint(1, 19)))
                          for _ in range(rng.randint(1, 6))]
        res[f"vid{v}"] = [" ".join(rng.choice(_WORDS, rng.randint(1, 19)))]
    gts["vid0"].append(" ".join(rng.choice(_WORDS, 70)))
    return gts, res


CORPORA = {"small": (SMALL["gts"], SMALL["res"]), "random": random_corpus()}


NGRAM_METRICS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "CIDEr")


def jax_native(on: bool) -> None:
    """Switch the JAX package's scorers to its native core or off it."""
    if not on:
        jnative._lib, jnative._checked = None, True
        return
    if jnative._lib is None:
        # the JAX package builds native/ in place, and a process that
        # loaded it half-written cached None: ask again
        jnative._checked = False
    assert jnative.get_lib() is not None


def jax_score_all(gts, res, profile, native: bool):
    """The JAX package's scores as the port computes them: its n-gram
    metrics in pure Python, METEOR and ROUGE-L in ``native``'s mode."""
    saved = jnative._lib, jnative._checked
    try:
        jax_native(False)
        out = jscorer.score_all(gts, res, meteor_profile=profile)
        if native:
            jax_native(True)
            on = jscorer.score_all(gts, res, meteor_profile=profile)
            out.update(METEOR=on["METEOR"], ROUGE_L=on["ROUGE_L"])
        return out
    finally:
        jnative._lib, jnative._checked = saved


@pytest.fixture(params=["native", "python"])
def mode(request, monkeypatch):
    """The port on its native core, or in pure Python."""
    if request.param == "python":
        monkeypatch.setenv("STVD_NO_NATIVE", "1")
        assert tnative.get_lib() is None
    else:
        monkeypatch.delenv("STVD_NO_NATIVE", raising=False)
        assert tnative.get_lib() is not None
    return request.param


@pytest.fixture(params=["no_synonyms", "synonyms"])
def synonyms(request):
    if request.param == "synonyms":
        assert jmeteor.load_synonym_table(SYNONYMS) == \
            tmeteor.load_synonym_table(SYNONYMS)
    yield request.param
    jmeteor.set_synonym_table(None)
    tmeteor.set_synonym_table(None)


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_score_all_matches_jax(corpus, profile, mode, synonyms):
    gts, res = CORPORA[corpus]
    want = jax_score_all(gts, res, profile, mode == "native")
    got = tscorer.score_all(gts, res, meteor_profile=profile)
    assert sorted(got) == sorted(METRICS)
    assert got == want


def test_ngram_metrics_do_not_merge_distinct_ngrams():
    """Three videos of the random corpus whose interned bigrams collide
    in the C core's n-gram key: the JAX package's native CIDEr differs
    from its pure-Python CIDEr there, and the port's CIDEr and BLEU, on
    its native core, equal the pure-Python scores."""
    gts, res = CORPORA["random"]
    sub = ("vid200", "vid201", "vid202")
    gts, res = {v: gts[v] for v in sub}, {v: res[v] for v in sub}
    want = jax_score_all(gts, res, "meteor2005", native=False)
    saved = jnative._lib, jnative._checked
    try:
        jax_native(True)
        on = jscorer.score_all(gts, res)
    finally:
        jnative._lib, jnative._checked = saved
    assert on["CIDEr"] != want["CIDEr"]
    assert os.environ.get("STVD_NO_NATIVE") is None
    got = tscorer.score_all(gts, res)
    for k in NGRAM_METRICS:
        assert got[k] == want[k], k


def test_each_metric_matches_jax(mode):
    """Every public scorer on the tokenized random corpus: BLEU with each
    reference-length option, METEOR per segment and with explicit
    parameters, ROUGE-L per segment, CIDEr-D, the tokenizer (the JAX
    package's BLEU and CIDEr in pure Python, as the port's)."""
    saved = jnative._lib, jnative._checked
    try:
        jax_native(mode == "native")
        _each_metric_matches_jax()
    finally:
        jnative._lib, jnative._checked = saved


def _each_metric_matches_jax():
    gts, res = CORPORA["random"]
    tg, tr = jtok.tokenize_corpus(gts), jtok.tokenize_corpus(res)
    assert (ttok.tokenize_corpus(gts), ttok.tokenize_corpus(res)) == (tg, tr)
    ids = sorted(tg)
    hyps, refs = [tr[i][0] for i in ids], [tg[i] for i in ids]
    saved = jnative._lib, jnative._checked
    jax_native(False)
    for option in ("closest", "shortest", "average"):
        for max_n in (2, 4):
            assert (tbleu.bleu(hyps, refs, max_n=max_n, option=option)
                    == jbleu.bleu(hyps, refs, max_n=max_n, option=option))
    assert tbleu.bleu_score(tg, tr) == jbleu.bleu_score(tg, tr)
    assert tcider.cider_score(tg, tr) == jcider.cider_score(tg, tr)
    jnative._lib, jnative._checked = saved
    assert trouge.rouge_score(tg, tr) == jrouge.rouge_score(tg, tr)
    assert tmeteor.meteor_score(tg, tr, alpha=0.8, beta=2.0, gamma=0.4) == \
        jmeteor.meteor_score(tg, tr, alpha=0.8, beta=2.0, gamma=0.4)
    for i in ids[:60]:
        assert (trouge.rouge_l_sentence(tr[i][0], tg[i])
                == jrouge.rouge_l_sentence(tr[i][0], tg[i]))
        for profile in (None,) + PROFILES:
            assert (tmeteor.meteor_sentence(tr[i][0], tg[i], profile=profile)
                    == jmeteor.meteor_sentence(tr[i][0], tg[i],
                                               profile=profile))


def test_native_and_python_agree(monkeypatch):
    """The port's two modes on the random corpus give equal scores."""
    gts, res = CORPORA["random"]
    monkeypatch.delenv("STVD_NO_NATIVE", raising=False)
    for profile in PROFILES:
        native = tscorer.score_all(gts, res, meteor_profile=profile)
        monkeypatch.setenv("STVD_NO_NATIVE", "1")
        python = tscorer.score_all(gts, res, meteor_profile=profile)
        monkeypatch.delenv("STVD_NO_NATIVE")
        assert native == python


def _csr_ids(rng, n, hi, lo=1, top=12):
    return [rng.randint(0, hi, rng.randint(lo, top)).astype(np.int32)
            for _ in range(n)]


def test_native_helpers_match_jax():
    """Each ctypes helper of the port's core against the JAX package's
    on the same id arrays (both compile native/metrics_core.cpp)."""
    jax_native(True)
    assert tnative.get_lib() is not None
    rng = np.random.RandomState(3)
    for _ in range(100):
        a, b = _csr_ids(rng, 2, 6)
        assert tnative.lcs_len(a, b) == jnative.lcs_len(a, b)
        hs, rs = a % 4, b % 4          # stems: a coarser partition
        for syn in ((None, None), (a % 3, b % 3)):
            args = (a, hs, syn[0], b, rs, syn[1])
            assert tnative.meteor_align(*args) == jnative.meteor_align(*args)
    hyps = _csr_ids(rng, 30, 20)
    refs = [_csr_ids(rng, rng.randint(1, 4), 20) for _ in range(30)]
    np.testing.assert_array_equal(tnative.lcs_batch(hyps, refs),
                                  jnative.lcs_batch(hyps, refs))
    stems = [h % 7 for h in hyps]
    rstems = [[r % 7 for r in rr] for rr in refs]
    np.testing.assert_array_equal(
        tnative.meteor_corpus(hyps, stems, refs, rstems, 0.9, 3.0, 0.5),
        jnative.meteor_corpus(hyps, stems, refs, rstems, 0.9, 3.0, 0.5))


def test_synonym_tables_behave_as_in_jax(tmp_path):
    """The fixture's asymmetric table matches both orders of a pair, a
    bad file is refused with nothing installed, and clearing it turns
    stage 2 off, in both packages."""
    try:
        for meteor in (jmeteor, tmeteor):
            meteor.load_synonym_table(SYNONYMS)
            assert meteor._synonyms_active()
        for hyp, ref in ((["a", "big", "dog"], [["a", "large", "dog"]]),
                         (["a", "large", "dog"], [["a", "big", "dog"]])):
            for profile in PROFILES:
                got = tmeteor.meteor_sentence(hyp, ref, profile=profile)
                assert got == jmeteor.meteor_sentence(hyp, ref,
                                                      profile=profile)
            assert tmeteor.meteor_sentence(hyp, ref) > 0.9
    finally:
        jmeteor.set_synonym_table(None)
        tmeteor.set_synonym_table(None)
    assert tmeteor.meteor_sentence(["a", "big", "dog"],
                                   [["a", "large", "dog"]]) < 0.7
    bad = tmp_path / "bad.json"
    bad.write_text("[1, 2, 3]")
    with pytest.raises(ValueError):
        tmeteor.load_synonym_table(str(bad))
    assert tmeteor._synonym_override is None


# ---------------------------------------------------------------------------
# Stemmers against NLTK's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nltk_stemmers():
    from nltk.stem.porter import PorterStemmer
    from nltk.stem.snowball import SnowballStemmer
    return {"porter": (PorterStemmer(), tstem.PorterStemmer()),
            "snowball": (SnowballStemmer("english"),
                         tstem.EnglishStemmer())}


def _outcome(stemmer, word):
    try:
        return "ok", stemmer.stem(word)
    except Exception as e:      # the same failure counts as agreement
        return "raises", type(e).__name__


@pytest.mark.parametrize("kind", ["porter", "snowball"])
def test_stemmers_match_nltk_on_corpus_words(kind, nltk_stemmers):
    theirs, ours = nltk_stemmers[kind]
    words = {w for gts, res in CORPORA.values()
             for caps in list(gts.values()) + list(res.values())
             for c in caps for w in jtok.ptb_tokenize(c)}
    words |= {w.upper() for w in list(words)[:50]}   # lower-casing
    assert len(words) > 100
    for w in sorted(words):
        assert ours.stem(w) == theirs.stem(w), w


def test_stemmers_keep_the_pinned_divergences(nltk_stemmers):
    """The Porter/Snowball divergences tests/test_metrics.py pins: each
    stemmer equals NLTK's on the list, so both diverge on the same
    words, and METEOR's stem stage follows the profile's stemmer."""
    (np_, tp), (ns, ts) = nltk_stemmers["porter"], nltk_stemmers["snowball"]
    ours = [(tp.stem(w), ts.stem(w)) for w in _STEM_FUZZ_WORDS]
    assert ours == [(np_.stem(w), ns.stem(w)) for w in _STEM_FUZZ_WORDS]
    diverging = [w for w, (p, s) in zip(_STEM_FUZZ_WORDS, ours) if p != s]
    assert "generously" in diverging and len(diverging) >= 5
    with tmeteor._stem_kind("snowball"):
        assert tmeteor._stem("generously") == ns.stem("generously")
    with tmeteor._stem_kind("porter"):
        assert tmeteor._stem("generously") == np_.stem("generously")
    for profile in PROFILES:
        assert (tmeteor.meteor_sentence(["fairly"], [["fair"]],
                                        profile=profile)
                == jmeteor.meteor_sentence(["fairly"], [["fair"]],
                                           profile=profile))


@settings(max_examples=2500, deadline=None, derandomize=True, database=None)
@given(st.text(alphabet=string.ascii_lowercase + "'", max_size=18))
def test_stemmers_match_nltk_on_random_strings(word):
    from nltk.stem.porter import PorterStemmer
    from nltk.stem.snowball import SnowballStemmer
    assert _outcome(tstem.PorterStemmer(), word) == \
        _outcome(PorterStemmer(), word)
    assert _outcome(tstem.EnglishStemmer(), word) == \
        _outcome(SnowballStemmer("english"), word)


# ---------------------------------------------------------------------------
# The port's build of the metrics core
# ---------------------------------------------------------------------------

_RACER = """
import sys, time
from pathlib import Path
sys.path.insert(0, {repo!r})
from stvd_torch.metrics import _native
_native.BUILD_DIR = Path({build!r})
while time.time() < {start!r}:
    time.sleep(0.001)
lib = _native.get_lib()
assert lib is not None
print(_native.lcs_len([1, 2, 3, 4], [2, 4, 3]), _native.library_path())
"""


def test_metrics_core_builds_race_free_in_six_processes(tmp_path):
    """Six processes start building into one empty directory at the same
    moment; each gets a whole library (none None, none an error), and
    the directory holds that library and no temporary file after."""
    build = tmp_path / "build"
    code = _RACER.format(repo=REPO, build=str(build), start=time.time() + 2)
    env = {k: v for k, v in os.environ.items() if k != "STVD_NO_NATIVE"}
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    lines = {out.strip() for out, _ in outs}
    assert len(lines) == 1
    length, path = lines.pop().split()
    assert length == "2"
    assert [f.name for f in build.iterdir()] == [os.path.basename(path)]


def test_metrics_core_loads_a_built_library_without_building(
        tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    path = tnative.build()
    assert path == tnative.library_path() and path.is_file()

    def no_compiler(*a, **k):
        raise AssertionError("rebuilt a library that exists")

    monkeypatch.setattr(tnative.subprocess, "run", no_compiler)
    assert tnative.build() == path
    assert tnative.load(path).stvd_lcs_len is not None


def test_metrics_core_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output,
    leaves nothing in the build directory, and no scorer falls back to
    pure Python in its place."""
    bad = tmp_path / "metrics_core.cpp"
    bad.write_text("int stvd_lcs_len( {\n")
    build = tmp_path / "build"
    monkeypatch.delenv("STVD_NO_NATIVE", raising=False)
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", build)
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="error"):
        tnative.get_lib()
    assert list(build.iterdir()) == []
    with pytest.raises(RuntimeError, match="metrics core build failed"):
        tscorer.score_all({"a": ["a dog"]}, {"a": ["a dog"]})


def test_metrics_core_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CXX", "no-such-compiler-stvd")
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="no-such-compiler-stvd"):
        tnative.build()


def test_no_native_gives_pure_python(monkeypatch):
    monkeypatch.setenv("STVD_NO_NATIVE", "1")
    assert tnative.get_lib() is None
    assert tnative.lcs_len([1, 2], [2]) is None
    monkeypatch.delenv("STVD_NO_NATIVE")
    assert tnative.get_lib() is not None


def test_score_all_needs_no_nltk():
    """A process where ``nltk`` cannot be imported scores both METEOR
    profiles, stem stage included, as this process does."""
    gts, res = {"a": ["a man fairly plays"]}, {"a": ["the men fair play"]}
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "sys.modules['nltk'] = None\n"
        "from stvd_torch.metrics.scorer import score_all\n"
        f"print(json.dumps([score_all({gts!r}, {res!r}, meteor_profile=p)"
        f" for p in {PROFILES!r}]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == [tscorer.score_all(gts, res, meteor_profile=p)
                   for p in PROFILES]
    assert got[0]["METEOR"] > 0
