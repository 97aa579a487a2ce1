"""Vocabulary and caption encoding (the port's copy of stvd/data/text.py).

Id convention of the reference worddict: 0 is EOS ('<eos>'), 1 is UNK.
Captions encode to fixed ``(maxlen,)`` int32 rows with a float32 mask.
"""

from __future__ import annotations

import pickle
import re
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

EOS_ID = 0   # word id 0 terminates a caption
UNK_ID = 1   # out-of-vocabulary words map to 1
EOS_TOKEN = "<eos>"
UNK_TOKEN = "UNK"

_TOKEN_RE = re.compile(r"[a-z0-9']+")


def tokenize(text: str) -> List[str]:
    """Lowercase word tokenizer for raw captions."""
    return _TOKEN_RE.findall(text.lower())


class Vocab:
    """word <-> id mapping with 0 = EOS and 1 = UNK."""

    def __init__(self, word_to_id: Dict[str, int]):
        w2i = dict(word_to_id)
        w2i.setdefault(EOS_TOKEN, EOS_ID)
        w2i.setdefault(UNK_TOKEN, UNK_ID)
        if w2i[EOS_TOKEN] != EOS_ID or w2i[UNK_TOKEN] != UNK_ID:
            raise ValueError("vocab must reserve id 0 for <eos>, 1 for UNK")
        self.word_to_id = w2i
        self.id_to_word = {i: w for w, i in w2i.items()}

    def __len__(self) -> int:
        return max(self.word_to_id.values()) + 1

    @staticmethod
    def build(corpus: Iterable[Sequence[str]], max_words: int = 20000
              ) -> "Vocab":
        """Frequency-ranked vocab from tokenized captions (ids 2.. in
        descending frequency, ties in first-seen order)."""
        counts: Counter = Counter()
        for toks in corpus:
            counts.update(toks)
        w2i = {EOS_TOKEN: EOS_ID, UNK_TOKEN: UNK_ID}
        for i, (w, _) in enumerate(counts.most_common(max_words - 2)):
            w2i[w] = i + 2
        return Vocab(w2i)

    @staticmethod
    def load_pickle(path: str) -> "Vocab":
        """A worddict pickle (``{word: id}``); a Python 2 one decodes
        with latin-1."""
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="latin1")
        return Vocab({str(k): int(v) for k, v in d.items()})

    def save_pickle(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.word_to_id, f, protocol=2)

    def encode(self, tokens: Sequence[str], n_words: int) -> List[int]:
        """tokens -> ids; ids at or above ``n_words`` become UNK."""
        out = []
        for t in tokens:
            i = self.word_to_id.get(t, UNK_ID)
            out.append(i if i < n_words else UNK_ID)
        return out

    def decode(self, ids: Sequence[int]) -> List[str]:
        """ids -> tokens, stopping at EOS."""
        toks = []
        for i in ids:
            if i == EOS_ID:
                break
            toks.append(self.id_to_word.get(int(i), UNK_TOKEN))
        return toks


def encode_captions(captions: Sequence[Sequence[str]], vocab: Vocab,
                    maxlen: int, n_words: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens (N, maxlen) int32, mask (N, maxlen) float32).  A row is
    ``w_1 .. w_L <eos> 0 ..`` with the mask over the L words and the EOS;
    captions longer than ``maxlen - 1`` words are truncated."""
    n = len(captions)
    toks = np.zeros((n, maxlen), dtype=np.int32)
    mask = np.zeros((n, maxlen), dtype=np.float32)
    for r, cap in enumerate(captions):
        ids = vocab.encode(cap, n_words)[: maxlen - 1]
        toks[r, :len(ids)] = ids
        mask[r, :len(ids) + 1] = 1.0
    return toks, mask
