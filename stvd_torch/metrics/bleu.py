"""Corpus BLEU-1..4, pure Python (the port's copy of stvd/metrics/bleu.py,
without its native fast path: the C core's ``stvd_bleu_stats`` keys
n-grams by a 64-bit mix of token ids that is not injective, so two
distinct n-grams can count as one; the port counts them here exactly).

Replaces coco-caption's ``bleu/`` scorer (reference ``cocoeval.py`` calls
``Bleu(4)`` — SURVEY.md §3.5).  Same algorithm: modified (clipped) n-gram
precision accumulated corpus-level, brevity penalty from the
closest-length reference ('closest' is the option COCO eval passes).
Cross-checked against nltk.translate.corpus_bleu in tests.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Sequence, Tuple

_TINY = 1e-15


def _ngrams(toks: Sequence[str], n: int) -> Counter:
    return Counter(tuple(toks[i: i + n]) for i in range(len(toks) - n + 1))


def bleu(
    hypotheses: Sequence[Sequence[str]],
    references: Sequence[Sequence[Sequence[str]]],
    max_n: int = 4,
    option: str = "closest",
) -> List[float]:
    """Corpus BLEU-1..max_n over tokenized hypotheses/references.

    ``references[i]`` is the list of reference token lists for
    hypothesis ``i``.  Returns [BLEU_1, ..., BLEU_max_n].
    """
    if len(hypotheses) != len(references):
        raise ValueError("hypotheses/references length mismatch")
    match = [0] * max_n
    total = [0] * max_n
    hyp_len = 0
    ref_len = 0

    for hyp, refs in zip(hypotheses, references):
        hyp_len += len(hyp)
        rls = [len(r) for r in refs]
        if option == "shortest":
            ref_len += min(rls)
        elif option == "average":
            ref_len += sum(rls) / len(rls)
        else:  # closest (COCO default)
            ref_len += min(rls, key=lambda rl: (abs(rl - len(hyp)), rl))
        for n in range(1, max_n + 1):
            hc = _ngrams(hyp, n)
            if not hc:
                continue
            # clip by the max count over references
            maxref: Counter = Counter()
            for r in refs:
                for g, c in _ngrams(r, n).items():
                    if c > maxref[g]:
                        maxref[g] = c
            match[n - 1] += sum(min(c, maxref[g]) for g, c in hc.items())
            total[n - 1] += sum(hc.values())
    return _finalize(match, total, hyp_len, ref_len, max_n)


def _finalize(match, total, hyp_len, ref_len, max_n):
    bp = 1.0 if hyp_len > ref_len else math.exp(1.0 - ref_len / max(hyp_len, 1))
    out = []
    logp_sum = 0.0
    for n in range(max_n):
        p = (match[n] + _TINY) / (total[n] + _TINY) if total[n] else 0.0
        logp_sum += math.log(max(p, _TINY))
        out.append(bp * math.exp(logp_sum / (n + 1)))
    return out


def bleu_score(gts: Dict[str, List[List[str]]],
               res: Dict[str, List[List[str]]],
               max_n: int = 4) -> Tuple[List[float], Dict[str, float]]:
    """COCOScorer-style interface: {id: [tokens...]} dicts.

    ``res[id]`` must hold exactly one hypothesis.  Returns the corpus
    BLEU list and a per-metric dict (Bleu_1..Bleu_4).
    """
    ids = sorted(gts)
    hyps = [res[i][0] for i in ids]
    refs = [gts[i] for i in ids]
    scores = bleu(hyps, refs, max_n=max_n)
    return scores, {f"Bleu_{n + 1}": s for n, s in enumerate(scores)}
