"""CIDEr-D, pure Python (the port's copy of stvd/metrics/cider.py,
without its native fast path: the C core's ``stvd_cider`` keys n-grams
by a 64-bit mix of token ids that is not injective, so two distinct
n-grams can share a tf-idf weight; the port counts them here exactly).

Replaces coco-caption's ``cider/`` scorer (reference ``cocoeval.py`` —
SURVEY.md §3.5).  CIDEr-D (Vedantam et al. 2015): tf-idf weighted n-gram
(n=1..4) cosine similarity between hypothesis and each reference, with a
gaussian length penalty (sigma=6), count clipping, scaled by 10 and
averaged over n and references.  IDF is computed from the reference
corpus of the evaluated split, exactly as the COCO scorer does.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence, Tuple

N_MAX = 4
SIGMA = 6.0


def _ngram_counts(toks: Sequence[str]) -> List[Counter]:
    return [Counter(tuple(toks[i: i + n]) for i in range(len(toks) - n + 1))
            for n in range(1, N_MAX + 1)]


def _compute_doc_freq(refs_per_id: Dict[str, List[List[str]]]
                      ) -> List[Counter]:
    """df[n][gram] = number of ids whose reference set contains gram."""
    df = [Counter() for _ in range(N_MAX)]
    for refs in refs_per_id.values():
        seen = [set() for _ in range(N_MAX)]
        for r in refs:
            for n, cnt in enumerate(_ngram_counts(r)):
                seen[n].update(cnt.keys())
        for n in range(N_MAX):
            for g in seen[n]:
                df[n][g] += 1
    return df


def _tfidf_vec(counts: List[Counter], df: List[Counter], log_n: float
               ) -> Tuple[List[Dict], List[float], int]:
    vecs, norms = [], []
    for n in range(N_MAX):
        v = {}
        sq = 0.0
        for g, c in counts[n].items():
            idf = log_n - math.log(max(df[n][g], 1.0))
            w = c * idf
            v[g] = w
            sq += w * w
        vecs.append(v)
        norms.append(math.sqrt(sq))
    length = sum(counts[0].values())  # unigram count == token count
    return vecs, norms, length


def cider_score(gts: Dict[str, List[List[str]]],
                res: Dict[str, List[List[str]]]
                ) -> Tuple[float, Dict[str, float]]:
    """COCOScorer-style interface on tokenized {id: [tokens...]} dicts."""
    ids = sorted(gts)
    df = _compute_doc_freq({i: gts[i] for i in ids})
    log_n = math.log(max(len(ids), 1))
    scores = []
    for i in ids:
        hyp_counts = _ngram_counts(res[i][0])
        hv, hnorm, hlen = _tfidf_vec(hyp_counts, df, log_n)
        per_ref = []
        for r in gts[i]:
            rv, rnorm, rlen = _tfidf_vec(_ngram_counts(r), df, log_n)
            sim_total = 0.0
            for n in range(N_MAX):
                # CIDEr-D: clip hypothesis weights by reference weights
                dot = 0.0
                for g, w in hv[n].items():
                    if g in rv[n]:
                        dot += min(w, rv[n][g]) * rv[n][g]
                if hnorm[n] > 0 and rnorm[n] > 0:
                    sim = dot / (hnorm[n] * rnorm[n])
                else:
                    sim = 0.0
                delta = float(hlen - rlen)
                sim *= math.exp(-(delta ** 2) / (2 * SIGMA ** 2))
                sim_total += sim
            per_ref.append(sim_total / N_MAX)
        scores.append(10.0 * sum(per_ref) / max(len(per_ref), 1))
    avg = sum(scores) / len(scores) if scores else 0.0
    return avg, {"CIDEr": avg}
