"""PTB-style tokenizer, pure Python (the port's copy of
stvd/metrics/tokenizer.py).

Replaces the Java Stanford PTBTokenizer subprocess the reference's scorer
shells out to (reference ``cocoeval.py`` -> coco-caption ``tokenizer/`` —
SURVEY.md §3.5).  Implements the same normalization the PTBTokenizer
applies to captions: lowercase, clitic splitting (``man's`` ->
``man 's``, ``don't`` -> ``do n't`` — PTB keeps the clitic as its own
token with the apostrophe), punctuation-token removal, whitespace split.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

# PTB splits these off as separate tokens, apostrophe retained
_CLITICS = re.compile(r"(?<=\w)(n't|'s|'re|'ve|'ll|'d|'m)(?=\W|$)")
_CLITIC_TOKENS = frozenset({"n't", "'s", "'re", "'ve", "'ll", "'d", "'m"})

# punctuation set the COCO tokenizer strips from captions (apostrophe
# handled separately: clitic apostrophes survive, stray ones don't)
_PUNCT = re.compile(
    r"[\"`\.\?\!,;:\-\(\)\[\]\{\}<>@#\$%\^&\*\+=~_/\\\|]")
_APOS = re.compile(r"'")
_WS = re.compile(r"\s+")


def ptb_tokenize(text: str) -> List[str]:
    """Tokenize one caption the way the COCO eval pipeline does."""
    t = _PUNCT.sub(" ", text.lower())
    t = _CLITICS.sub(r" \1", t)
    out: List[str] = []
    for w in _WS.split(t):
        if w in _CLITIC_TOKENS:
            out.append(w)       # keep the apostrophe, like PTB
            continue
        out.extend(x for x in _WS.split(_APOS.sub(" ", w)) if x)
    return out


def tokenize_corpus(d: Dict[str, Sequence[str]]) -> Dict[str, List[List[str]]]:
    """Tokenize an {id: [caption strings]} dict (the COCOScorer input
    format the reference uses)."""
    return {k: [ptb_tokenize(c) for c in caps] for k, caps in d.items()}
