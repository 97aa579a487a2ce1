"""ROUGE-L, pure Python (the port's copy of stvd/metrics/rouge.py).

Replaces coco-caption's ``rouge/`` scorer (reference ``cocoeval.py`` —
SURVEY.md §3.5).  Same definition: LCS-based F-measure with beta=1.2,
taking the max precision and max recall over references, averaged over
the corpus.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

BETA = 1.2


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    """Length of the longest common subsequence.

    Uses the native C++ core (native/metrics_core.cpp:stvd_lcs_len) when
    built; pure-Python single-row DP otherwise (identical results —
    pinned by tests/test_torch_metrics.py).
    """
    if not a or not b:
        return 0
    from . import _native
    if _native.get_lib() is not None:
        intern = _native.Interner()
        r = _native.lcs_len(intern(a), intern(b))
        if r is not None:
            return r
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l_sentence(hyp: Sequence[str],
                     refs: Sequence[Sequence[str]]) -> float:
    if not refs:
        return 0.0      # no ground truth: unscorable, not an error
    precs, recs = [], []
    for r in refs:
        l = _lcs_len(hyp, r)
        precs.append(l / len(hyp) if hyp else 0.0)
        recs.append(l / len(r) if r else 0.0)
    p, rc = max(precs), max(recs)
    if p == 0.0 and rc == 0.0:
        return 0.0
    return ((1 + BETA ** 2) * p * rc) / (rc + BETA ** 2 * p)


def rouge_score(gts: Dict[str, List[List[str]]],
                res: Dict[str, List[List[str]]]) -> Tuple[float, Dict[str, float]]:
    ids = sorted(gts)
    from . import _native
    if _native.get_lib() is not None:
        # batched native LCS: one ctypes call for every (hyp, ref) pair
        intern = _native.Interner()
        hyp_ids = [intern(res[i][0]) for i in ids]
        refs_ids = [[intern(r) for r in gts[i]] for i in ids]
        lcs = _native.lcs_batch(hyp_ids, refs_ids)
        if lcs is not None:
            scores = []
            ri = 0
            for v, i in enumerate(ids):
                hyp = res[i][0]
                if not gts[i]:
                    scores.append(0.0)
                    continue
                precs, recs = [], []
                for r in gts[i]:
                    l = int(lcs[ri])
                    ri += 1
                    precs.append(l / len(hyp) if hyp else 0.0)
                    recs.append(l / len(r) if r else 0.0)
                p, rc = max(precs), max(recs)
                scores.append(0.0 if p == 0.0 and rc == 0.0 else
                              ((1 + BETA ** 2) * p * rc) / (rc + BETA ** 2 * p))
            avg = sum(scores) / len(scores) if scores else 0.0
            return avg, {"ROUGE_L": avg}
    scores = [rouge_l_sentence(res[i][0], gts[i]) for i in ids]
    avg = sum(scores) / len(scores) if scores else 0.0
    return avg, {"ROUGE_L": avg}
