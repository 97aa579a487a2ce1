"""METEOR, pure Python, with selectable parameter profiles (the port's
copy of stvd/metrics/meteor.py; it stems with its own copies of NLTK's
stemmers, ``stem.py``, so it needs no nltk, and looks WordNet up only
where nltk and its data are installed).

Replaces the Java METEOR-1.5 jar the reference's scorer pipes to
(reference ``cocoeval.py`` -> coco-caption ``meteor/meteor-1.5.jar`` —
SURVEY.md §2 row 11), with no Java.

Two profiles are shipped (select via ``profile=`` on every scoring
function, or ``score_all(meteor_profile=...)``):

``meteor2005`` (the DEFAULT, and the module-level ALPHA/BETA/GAMMA
constants): the classic Banerjee & Lavie 2005 parameters —
F = 10PR/(R+9P) i.e. alpha=0.9, penalty = 0.5*(chunks/matches)^3
(beta=3, gamma=0.5), unweighted words, equal stage weights.  Under
these parameters an exact match scores ~1.0, and the fast native
aligner applies.

``meteor15-en``: the METEOR-1.5 English task parameters (Denkowski &
Lavie 2014): alpha=0.85, beta=0.2, gamma=0.6, content/function-word
weighting delta=0.75, stage weights exact=1.0, stem=0.6, synonym=0.8.
The ALIGNMENT is the jar's algorithm: beam search (width 40) over
hypothesis positions selecting the match subset that maximizes
coverage, then minimizes chunks, then minimizes positional distance
(Denkowski & Lavie 2011) — implemented in ``_resolve_beam`` and
mirrored in native C++.

**Exact jar-delta classes** (what is and is not jar-identical —
VERDICT r3 Next #5; each class is stage-tested in
tests/test_metrics.py):

  1. *Alignment resolution*: IDENTICAL algorithm (beam-40, coverage →
     chunks → distance, same deterministic tie-breaks), pinned by
     hand-computed known-answer tests and Python↔C++ fuzz.
  2. *Parameters / scoring formula*: IDENTICAL (the published 1.5
     English task tuple; weighted P/R, fragmentation penalty).
  3. *Stemmer*: the 1.5 jar stems with the SNOWBALL English stemmer
     (org.tartarus.snowball.ext.englishStemmer), not the 1979 Porter
     algorithm; the ``meteor15-en`` profile therefore uses NLTK's
     SnowballStemmer("english") while ``meteor2005`` keeps the
     PorterStemmer of the 2005 paper (both as copies in ``stem.py``).
     Snowball-vs-Porter divergences (e.g. 'generously' → 'generous'
     vs 'gener') are pinned in tests.
  4. *Synonym stage*: the jar ships a WordNet-DERIVED synonym DB;
     without WordNet data, scoring runs exact+stem (stage 2
     silently off).  The stage LOGIC is jar-shaped
     (asymmetric ``hyp in syns(ref) or ref in syns(hyp)`` test) and
     activates with WordNet data OR an external table installed via
     ``set_synonym_table``/``load_synonym_table`` (CLI:
     ``cli/sample --synonyms table.json``); committed fixture:
     tests/fixtures/synonyms_en_mini.json.  Scores with a non-jar
     table are NOT jar-comparable — same machinery, different data.
  5. *Function-word list*: APPROXIMATED.  The jar derives it from
     corpus relative frequency > 1e-3; ours is a fixed English list.
     Only affects the delta-weighting split of ``meteor15-en``.
  6. *Paraphrase stage*: NOT IMPLEMENTED.  The full 1.5 English task
     adds a 4th stage driven by a ~60 MB paraphrase table the jar
     ships as data; not shipped with this package.  meteor15-en is the
     exact/stem/synonym subset — scores are systematically ≲ jar
     scores on real data for this reason alone.

Net: 1–2 are jar-identical; 3 is now jar-identical in algorithm
choice; 4 is data-absent (logic pinned); 5 approximated; 6 absent.
Treat METEOR-1.5 numbers as non-comparable to jar scores until
validated with the jar's own data files (see PARITY.md).

Common machinery for both profiles:

  * staged unigram alignment: exact -> Porter stem -> synonym (stage 2
    activates with WordNet data OR an injected ``_synonym_override``
    table; without WordNet data, scoring runs exact+stem
    — but the stage-2 logic itself is pinned by known-answer tests with
    injected tables, tests/test_metrics.py and
    tests/test_torch_metrics.py),
  * F_mean = P*R / (alpha*P + (1-alpha)*R),
  * fragmentation penalty gamma * (chunks / matches)^beta,
  * score = F_mean * (1 - penalty), best reference taken per segment,
  * corpus score aggregates the per-segment statistics of the best
    alignments (as the jar does), not the mean of segment scores.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .stem import EnglishStemmer, PorterStemmer

ALPHA = 0.9    # recall weight in F_mean: F = P*R / (a*P + (1-a)*R)
BETA = 3.0    # fragmentation exponent
GAMMA = 0.5    # fragmentation weight


@dataclasses.dataclass(frozen=True)
class MeteorProfile:
    """A METEOR parameter tuple.  ``delta`` enables METEOR-1.5's
    content/function-word weighting (None = unweighted, as in 2005);
    ``w_exact/w_stem/w_syn`` weight matches by the stage that found
    them (1.5 uses 1.0/0.6/0.8; 2005 weighs all stages equally);
    ``stemmer`` names the stage-1 algorithm ('porter' for the 2005
    paper, 'snowball' = the 1.5 jar's englishStemmer)."""
    name: str
    alpha: float
    beta: float
    gamma: float
    delta: Optional[float] = None
    w_exact: float = 1.0
    w_stem: float = 1.0
    w_syn: float = 1.0
    stemmer: str = "porter"

    @property
    def weighted(self) -> bool:
        return (self.delta is not None or self.w_stem != self.w_exact
                or self.w_syn != self.w_exact)


PROFILES: Dict[str, MeteorProfile] = {
    "meteor2005": MeteorProfile("meteor2005", ALPHA, BETA, GAMMA),
    "meteor15-en": MeteorProfile("meteor15-en", 0.85, 0.2, 0.6,
                                 delta=0.75, w_stem=0.6, w_syn=0.8,
                                 stemmer="snowball"),
}


def resolve_profile(p: Union[str, MeteorProfile, None]) -> MeteorProfile:
    if p is None:
        return PROFILES["meteor2005"]
    if isinstance(p, MeteorProfile):
        return p
    try:
        return PROFILES[p]
    except KeyError:
        raise KeyError(f"unknown METEOR profile {p!r}; "
                       f"available: {sorted(PROFILES)}")


# Approximation of the METEOR-1.5 English function-word list (the jar
# derives it from corpus relative frequency > 1e-3; no corpus here).
FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no
i you he she it we they me him her us them my your his its our their
mine yours hers ours theirs myself yourself himself herself itself
ourselves themselves
am is are was were be been being do does did done doing have has had
having will would shall should may might can could must ought need
of in on at by for with about against between into through during
before after above below to from up down out off over under again
further once here there and but or nor so yet both either neither
not only just than too very as if because while although though
whether when where why how what which who whom whose
's n't 're 've 'll 'd 'm
""".split())


_stemmers = {"porter": PorterStemmer(), "snowball": EnglishStemmer()}
_stem_caches: Dict[str, Dict[str, str]] = {"porter": {}, "snowball": {}}
_active_stem_kind = "porter"   # module default = the 2005 profile's


def _stem(w: str) -> str:
    """Memoized stem under the ACTIVE stemmer kind (vocab is small and
    captions repeat words constantly).

    'porter' (2005 profile) = NLTK's PorterStemmer; 'snowball'
    (meteor15-en) = NLTK's SnowballStemmer('english'), the same
    algorithm as the 1.5 jar's org.tartarus englishStemmer; both are the
    port's own pure-Python copies (``stem.py``), so nltk is not needed.
    Scoring entry points switch the kind via ``_stem_kind`` per
    profile."""
    cache = _stem_caches[_active_stem_kind]
    s = cache.get(w)
    if s is None:
        s = _stemmers[_active_stem_kind].stem(w)
        cache[w] = s
    return s


@contextlib.contextmanager
def _stem_kind(kind: str):
    """Scoped stemmer selection (single-threaded scoring)."""
    global _active_stem_kind
    if kind not in _stem_caches:
        raise ValueError(f"unknown stemmer {kind!r}; "
                         f"available: {sorted(_stem_caches)}")
    prev = _active_stem_kind
    _active_stem_kind = kind
    try:
        yield
    finally:
        _active_stem_kind = prev


_wordnet_checked = False
_wordnet = None


def _get_wordnet():
    """WordNet if its data is installed, else None (graceful stage skip)."""
    global _wordnet_checked, _wordnet
    if not _wordnet_checked:
        _wordnet_checked = True
        try:
            from nltk.corpus import wordnet as wn
            wn.synsets("dog")  # force-load; raises if data missing
            _wordnet = wn
        except Exception:
            _wordnet = None
    return _wordnet


# Injectable synonym source: {word: set(synonyms)}.  Tests (and any
# WordNet-free deployment with its own thesaurus) set this to exercise
# the stage-2 logic without nltk_data; None = use WordNet when present.
_synonym_override: Optional[Dict[str, set]] = None


def set_synonym_table(table: Optional[Dict[str, Sequence[str]]]) -> None:
    """Install a synonym table for the stage-2 aligner (None clears it,
    restoring WordNet-if-present).  The lookup is the jar's asymmetric
    test: a (hyp, ref) pair matches when ``hyp in table[ref] or
    ref in table[hyp]`` — so a one-directional table still matches in
    both orders of the pair."""
    global _synonym_override
    _synonym_override = (None if table is None else
                         {w: set(s) for w, s in table.items()})


def load_synonym_table(path: str) -> int:
    """Load a JSON ``{word: [synonym, ...]}`` file (e.g. exported from
    a WordNet installation elsewhere, or the jar's synonymy data
    converted offline) and install it via ``set_synonym_table``.
    Returns the number of headwords.  This is the scoring-time escape
    hatch for boxes without nltk_data (jar-delta class 4 above);
    CLI surface: ``cli/sample --synonyms table.json``."""
    import json
    with open(path) as f:
        table = json.load(f)
    if not isinstance(table, dict):
        raise ValueError(f"{path}: synonym table must be a JSON object "
                         "{word: [synonyms...]}")
    set_synonym_table(table)
    return len(table)


def _synonyms(w: str) -> set:
    if _synonym_override is not None:
        return _synonym_override.get(w, set())
    wn = _get_wordnet()
    if wn is None:
        return set()
    syns = set()
    for s in wn.synsets(w):
        for l in s.lemmas():
            syns.add(l.name().lower())
    return syns


def _synonyms_active() -> bool:
    """THE native/Python routing rule, in one place: the native C ABI
    aligner takes symmetric equivalence-class ids and cannot express
    the jar's asymmetric synonymy test (``hyp_word in syns(ref_word) or
    ref_word in syns(hyp_word)``), so ANY active synonym source —
    WordNet data or an injected table — routes alignment through the
    pure-Python resolver; the native fast paths (meteor_align and the
    batched meteor_corpus) engage only when this returns False."""
    return _synonym_override is not None or _get_wordnet() is not None


BEAM_WIDTH = 40   # the METEOR jar's default alignment beam


def _align(hyp: List[str], ref: List[str]) -> List[Tuple[int, int]]:
    """Staged unigram alignment; returns (hyp_pos, ref_pos) pairs."""
    return [(h, r) for h, r, _ in _align_staged(hyp, ref)]


def _resolve_beam(cands: List[List[Tuple[int, int]]], nr: int,
                  beam: int = BEAM_WIDTH) -> List[Tuple[int, int, int]]:
    """The METEOR jar's alignment resolution (Denkowski & Lavie 2011):
    beam search over hypothesis positions selecting the non-conflicting
    match subset that 1. maximizes word coverage, 2. minimizes chunk
    count, 3. minimizes total |hyp_pos - ref_pos|.  ``cands[i]`` lists
    (ref_pos, stage) candidates for hyp position i, ref_pos ascending.

    Deterministic tie-break (mirrored EXACTLY by the native aligner,
    native/metrics_core.cpp:stvd_meteor_align): states are expanded in
    beam order, skip before matches, candidates in ascending ref_pos;
    an equal-valued state reached later never replaces an earlier one;
    the per-level prune is a stable sort by (coverage desc, chunks asc,
    distance asc).
    """
    # state key: (ref_used_mask, prev_i, prev_j); value: (m, chunks,
    # dist, pairs)
    states: Dict[Tuple[int, int, int], Tuple[int, int, int, tuple]] = {
        (0, -2, -2): (0, 0, 0, ())}
    for i, ci in enumerate(cands):
        new: Dict[Tuple[int, int, int], Tuple[int, int, int, tuple]] = {}

        def consider(key, val):
            old = new.get(key)
            # strictly better = more matches, then fewer chunks, then
            # smaller distance; equal keeps the first arrival
            if old is None or (-val[0], val[1], val[2]) < (
                    -old[0], old[1], old[2]):
                new[key] = val

        for (used, pi, pj), (m, ch, dist, pairs) in states.items():
            consider((used, pi, pj), (m, ch, dist, pairs))       # skip i
            for j, stage in ci:
                if used >> j & 1:
                    continue
                nch = ch + (0 if (pi == i - 1 and pj == j - 1) else 1)
                consider((used | (1 << j), i, j),
                         (m + 1, nch, dist + abs(i - j),
                          pairs + ((i, j, stage),)))
        ranked = sorted(new.items(),
                        key=lambda kv: (-kv[1][0], kv[1][1], kv[1][2]))
        states = dict(ranked[:beam])
    best = min(states.values(), key=lambda v: (-v[0], v[1], v[2]))
    return list(best[3])


def _align_staged(hyp: List[str], ref: List[str]
                  ) -> List[Tuple[int, int, int]]:
    """(hyp_pos, ref_pos, stage) triples; stage 0=exact 1=stem 2=syn.
    Each (i, j) candidate carries the highest-precedence stage that
    matches it; the beam resolution picks the final subset.

    Stays pure Python deliberately: routing through the native
    pairs-returning aligner (_native.meteor_align_pairs) measured 2x
    SLOWER at caption scale — per-pair ctypes + interning overhead
    exceeds the beam cost on <=30-token segments.  The native win is
    the batched one-call corpus path (stvd_meteor_corpus)."""
    syn_on = _synonyms_active()
    syns = [_synonyms(w) for w in hyp] if syn_on else None
    cands: List[List[Tuple[int, int]]] = []
    for i, hw in enumerate(hyp):
        hs = _stem(hw)
        ci: List[Tuple[int, int]] = []
        for j, rw in enumerate(ref):
            if hw == rw:
                ci.append((j, 0))
            elif hs == _stem(rw):
                ci.append((j, 1))
            elif syn_on and (hw in _synonyms(rw) or rw in syns[i]):
                ci.append((j, 2))
        cands.append(ci)
    return sorted(_resolve_beam(cands, len(ref)))


def _count_chunks(matches: List[Tuple[int, int]]) -> int:
    if not matches:
        return 0
    chunks = 1
    for (h0, r0), (h1, r1) in zip(matches, matches[1:]):
        if h1 != h0 + 1 or r1 != r0 + 1:
            chunks += 1
    return chunks


def _align_stats(hyp: List[str], ref: List[str]) -> Tuple[int, int]:
    """(matches, chunks) for one hypothesis/reference pair.

    Uses the native C++ beam aligner (native/metrics_core.cpp:
    stvd_meteor_align) when built, no synonym source is active (the
    routing rule lives in ``_synonyms_active``), and the reference fits
    the native 63-token bitmask; identical results to the Python path
    are pinned by tests/test_torch_metrics.py.
    """
    from . import _native
    if not _synonyms_active() and _native.get_lib() is not None:
        intern = _native.Interner()
        out = _native.meteor_align(
            intern(hyp), intern([_stem(w) for w in hyp]), None,
            intern(ref), intern([_stem(w) for w in ref]), None)
        if out is not None:
            return out
    m = _align(hyp, ref)
    return len(m), _count_chunks(m)


# ---------------------------------------------------------------------------
# Unweighted (2005-style) scoring — native-accelerated
# ---------------------------------------------------------------------------

def _segment_stats(hyp: List[str], refs: Sequence[List[str]],
                   alpha: float = ALPHA, beta: float = BETA,
                   gamma: float = GAMMA) -> Tuple[int, int, int, int]:
    """Best-reference (matches, hyp_len, ref_len, chunks) for a segment.

    'Best' = highest segment METEOR score, ties to fewer chunks (what
    the jar optimizes per segment before corpus aggregation).
    """
    from . import _native
    use_native = not _synonyms_active() and _native.get_lib() is not None
    if use_native:
        # hoist hypothesis interning/stemming out of the reference loop
        intern = _native.Interner()
        h_ids = intern(hyp)
        h_stems = intern([_stem(w) for w in hyp])
    best = None
    best_score = -1.0
    for r in refs:
        out = _native.meteor_align(
            h_ids, h_stems, None, intern(r),
            intern([_stem(w) for w in r]), None) if use_native else None
        if out is not None:
            nm, nchunks = out
        else:
            # native returned None (>62-token ref) or is unavailable:
            # go straight to the Python beam — _align_stats would
            # re-intern/re-stem and re-ask native just to get None again
            m = _align(hyp, r)
            nm, nchunks = len(m), _count_chunks(m)
        stats = (nm, len(hyp), len(r), nchunks)
        s = _score_from_stats(*stats, alpha=alpha, beta=beta, gamma=gamma)
        if s > best_score or (s == best_score and best is not None
                              and stats[3] < best[3]):
            best_score = s
            best = stats
    return best if best is not None else (0, len(hyp), 0, 0)


def _score_from_stats(m: int, hlen: int, rlen: int, chunks: int,
                      alpha: float = ALPHA, beta: float = BETA,
                      gamma: float = GAMMA) -> float:
    if m == 0 or hlen == 0 or rlen == 0:
        return 0.0
    p = m / hlen
    r = m / rlen
    f_mean = p * r / (alpha * p + (1 - alpha) * r)
    frag = chunks / m
    penalty = gamma * (frag ** beta) if chunks > 0 else 0.0
    return f_mean * (1.0 - penalty)


# ---------------------------------------------------------------------------
# Weighted (METEOR-1.5-style) scoring — pure Python
# ---------------------------------------------------------------------------

def _word_weight(w: str, delta: Optional[float]) -> float:
    if delta is None:
        return 1.0
    return (1.0 - delta) if w in FUNCTION_WORDS else delta


_W15 = Tuple[float, float, float, float, int, int]  # mwh mwr whl wrl m ch


def _segment_stats_weighted(hyp: List[str], refs: Sequence[List[str]],
                            prof: MeteorProfile) -> _W15:
    """Best-reference weighted stats: (weighted hyp matches, weighted
    ref matches, weighted hyp len, weighted ref len, raw matches,
    chunks) — the sufficient statistics of the METEOR-1.5 score."""
    stage_w = (prof.w_exact, prof.w_stem, prof.w_syn)
    whl = sum(_word_weight(w, prof.delta) for w in hyp)
    best: Optional[_W15] = None
    best_score = -1.0
    for r in refs:
        triples = _align_staged(hyp, r)
        mwh = sum(stage_w[s] * _word_weight(hyp[h], prof.delta)
                  for h, _, s in triples)
        mwr = sum(stage_w[s] * _word_weight(r[j], prof.delta)
                  for _, j, s in triples)
        wrl = sum(_word_weight(w, prof.delta) for w in r)
        ch = _count_chunks([(h, j) for h, j, _ in triples])
        stats: _W15 = (mwh, mwr, whl, wrl, len(triples), ch)
        s = _score_from_weighted(stats, prof)
        if s > best_score or (s == best_score and best is not None
                              and stats[5] < best[5]):
            best_score = s
            best = stats
    return best if best is not None else (0.0, 0.0, whl, 0.0, 0, 0)


def _score_from_weighted(stats: _W15, prof: MeteorProfile) -> float:
    mwh, mwr, whl, wrl, m, ch = stats
    if m == 0 or whl <= 0 or wrl <= 0:
        return 0.0
    p = mwh / whl
    r = mwr / wrl
    if p <= 0 or r <= 0:
        return 0.0
    f_mean = p * r / (prof.alpha * p + (1 - prof.alpha) * r)
    penalty = prof.gamma * ((ch / m) ** prof.beta) if ch > 0 else 0.0
    return f_mean * (1.0 - penalty)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def meteor_sentence(hyp: List[str], refs: Sequence[List[str]],
                    alpha: float = ALPHA, beta: float = BETA,
                    gamma: float = GAMMA,
                    profile: Union[str, MeteorProfile, None] = None) -> float:
    """Segment METEOR.  ``profile`` overrides alpha/beta/gamma (and
    selects the profile's stemmer — snowball for meteor15-en)."""
    if profile is not None:
        prof = resolve_profile(profile)
        with _stem_kind(prof.stemmer):
            if prof.weighted:
                return _score_from_weighted(
                    _segment_stats_weighted(hyp, refs, prof), prof)
            a, b, g = prof.alpha, prof.beta, prof.gamma
            return _score_from_stats(
                *_segment_stats(hyp, refs, a, b, g),
                alpha=a, beta=b, gamma=g)
    return _score_from_stats(*_segment_stats(hyp, refs, alpha, beta, gamma),
                             alpha=alpha, beta=beta, gamma=gamma)


def meteor_score(gts: Dict[str, List[List[str]]],
                 res: Dict[str, List[List[str]]],
                 alpha: float = ALPHA, beta: float = BETA,
                 gamma: float = GAMMA,
                 profile: Union[str, MeteorProfile, None] = None
                 ) -> Tuple[float, Dict[str, float]]:
    """Corpus METEOR on tokenized {id: [tokens...]} dicts (aggregated
    statistics, matching the jar's corpus-level final score).

    ``profile`` selects a parameter profile ('meteor2005' default,
    'meteor15-en'); when omitted, the explicit alpha/beta/gamma apply
    with unweighted 2005-style statistics.
    """
    ids = sorted(gts)
    if profile is not None:
        prof = resolve_profile(profile)
        if prof.weighted:
            with _stem_kind(prof.stemmer):
                tot = [0.0, 0.0, 0.0, 0.0, 0, 0]
                for i in ids:
                    s = _segment_stats_weighted(res[i][0], gts[i], prof)
                    for k in range(6):
                        tot[k] += s[k]
                score = _score_from_weighted(tuple(tot), prof)
            return score, {"METEOR": score}
        alpha, beta, gamma = prof.alpha, prof.beta, prof.gamma
    from . import _native
    if (not _synonyms_active() and _native.get_lib() is not None
            and all(len(r) <= 62 for i in ids for r in gts[i])):
        # one native call for the whole corpus (per-pair ctypes overhead
        # dominates otherwise); >62-token refs exceed the native beam
        # resolver's bitmask and take the pure-Python path
        intern = _native.Interner()
        hyp_ids = [intern(res[i][0]) for i in ids]
        hyp_stems = [intern([_stem(w) for w in res[i][0]]) for i in ids]
        refs_ids = [[intern(r) for r in gts[i]] for i in ids]
        refs_stems = [[intern([_stem(w) for w in r]) for r in gts[i]]
                      for i in ids]
        stats = _native.meteor_corpus(hyp_ids, hyp_stems, refs_ids,
                                      refs_stems, alpha, beta, gamma)
        if stats is not None:
            tm, th, tr, tc = (int(stats[:, 0].sum()), int(stats[:, 1].sum()),
                              int(stats[:, 2].sum()), int(stats[:, 3].sum()))
            score = _score_from_stats(tm, th, tr, tc, alpha=alpha,
                                      beta=beta, gamma=gamma)
            return score, {"METEOR": score}
    tm = th = tr = tc = 0
    for i in ids:
        m, h, r, c = _segment_stats(res[i][0], gts[i], alpha, beta, gamma)
        tm += m
        th += h
        tr += r
        tc += c
    score = _score_from_stats(tm, th, tr, tc, alpha=alpha, beta=beta,
                              gamma=gamma)
    return score, {"METEOR": score}
