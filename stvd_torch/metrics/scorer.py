"""COCOScorer-equivalent: one call -> all caption metrics (the port's
copy of stvd/metrics/scorer.py).

Mirrors the reference's ``cocoeval.py:§COCOScorer.score(GT, hypo, IDs)``
(SURVEY.md §3.5) but with zero subprocesses: the PTB tokenization and
every scorer (BLEU-1..4, METEOR, ROUGE_L, CIDEr) are pure Python in this
package.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

from .bleu import bleu_score
from .cider import cider_score
from .meteor import meteor_score
from .rouge import rouge_score
from .tokenizer import tokenize_corpus

Raw = Dict[str, Sequence[str]]
Tok = Dict[str, List[List[str]]]


def score_all(gts: Union[Raw, Tok], res: Union[Raw, Tok],
              tokenized: bool = False,
              meteor_profile: str = "meteor2005") -> Dict[str, float]:
    """Score hypotheses against references.

    ``gts[id]`` = list of reference captions, ``res[id]`` = list with one
    hypothesis caption.  Pass raw strings (default; PTB-tokenized here,
    like the reference pipeline) or pre-tokenized token lists with
    ``tokenized=True``.  ``meteor_profile`` picks the METEOR parameter
    profile ('meteor2005' | 'meteor15-en' — see metrics/meteor.py).
    """
    missing = set(gts) - set(res)
    if missing:
        raise ValueError(f"hypotheses missing for ids: {sorted(missing)[:5]}")
    if not tokenized:
        gts = tokenize_corpus(gts)
        res = tokenize_corpus(res)
    out: Dict[str, float] = {}
    _, b = bleu_score(gts, res)
    out.update(b)
    _, m = meteor_score(gts, res, profile=meteor_profile)
    out.update(m)
    _, r = rouge_score(gts, res)
    out.update(r)
    _, c = cider_score(gts, res)
    out.update(c)
    return out
