"""Dataset assembly and fixed-shape batching (counterpart of
stvd/data/batching.py).

Every caption is encoded once to a static ``(maxlen,)`` row with a mask,
and a batch is a gather from the device-resident feature bank by each
caption's video row, so every train step runs at one shape.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .bank import FeatureBank, synthetic_bank
from .text import Vocab, encode_captions


@dataclasses.dataclass
class CaptionSet:
    """All encoded (video, caption) pairs of one split; ``video_idx[i]``
    is the bank row of caption i's video."""

    video_idx: np.ndarray   # (M,) int32
    tokens: np.ndarray      # (M, maxlen) int32
    mask: np.ndarray        # (M, maxlen) float32

    @property
    def n(self) -> int:
        return self.tokens.shape[0]


@dataclasses.dataclass
class Dataset:
    """One split: a feature bank, its encoded captions and the raw
    tokenized references per video row."""

    bank: FeatureBank
    captions: CaptionSet
    vocab: Vocab
    references: List[List[List[str]]]


def build_caption_set(pairs: Sequence[Tuple[str, Sequence[str]]],
                      bank: FeatureBank, vocab: Vocab, maxlen: int,
                      n_words: int) -> CaptionSet:
    """Encode (video_id, tokens) pairs against a bank; pairs whose video
    is not in the bank are dropped."""
    idx = bank.index()
    vids, caps = [], []
    for v, toks in pairs:
        if v in idx:
            vids.append(idx[v])
            caps.append(toks)
    tokens, mask = encode_captions(caps, vocab, maxlen, n_words)
    return CaptionSet(video_idx=np.asarray(vids, dtype=np.int32),
                      tokens=tokens, mask=mask)


class BatchIterator:
    """Shuffled fixed-shape minibatch indices.  An epoch's ragged tail is
    filled by wrapping around the epoch's order, with weight 0 on the
    wrapped slots, so every batch has the same shape and the loss is
    unbiased.  Shuffles with numpy's ``RandomState(seed)``, as the JAX
    package does, so both draw the same batches."""

    def __init__(self, n: int, batch_size: int, seed: int = 0,
                 shuffle: bool = True):
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self._epoch = 0

    def epoch(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (indices (B,) int32, weight (B,) float32) for one pass."""
        order = np.arange(self.n)
        if self.shuffle:
            self._rng.shuffle(order)
        self._epoch += 1
        b = self.batch_size
        for s in range(0, self.n, b):
            chunk = order[s: s + b]
            n_real = len(chunk)
            w = np.ones(b, dtype=np.float32)
            if n_real < b:
                chunk = np.concatenate([chunk, np.resize(order, b - n_real)])
                w[n_real:] = 0.0
            yield chunk.astype(np.int32), w


class BucketedBatchIterator:
    """Length-bucketed minibatches (the JAX package's, draw for draw): a
    caption of length L goes to the smallest bucket >= L, so a batch of
    short captions runs a short scan; the columns a bucket drops are
    all-pad, so the loss is unchanged.  Yields ``(indices (B,), weight
    (B,), t_bucket)``; batches are shuffled across buckets each epoch,
    and a bucket's ragged tail wraps within the bucket with weight 0."""

    def __init__(self, lengths: Sequence[int], batch_size: int,
                 buckets: Sequence[int], seed: int = 0,
                 shuffle: bool = True):
        lengths = np.asarray(lengths, dtype=np.int64)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if lengths.size and int(lengths.max()) > self.buckets[-1]:
            raise ValueError(
                f"max caption length {int(lengths.max())} exceeds the "
                f"largest bucket {self.buckets[-1]}")
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        edges = np.asarray(self.buckets)
        assign = edges[np.searchsorted(edges, lengths)]
        self._groups = [(int(t), np.flatnonzero(assign == t))
                        for t in self.buckets
                        if np.any(assign == t)]
        self.n = int(lengths.size)

    def epoch(self) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        b = self.batch_size
        batches = []
        for t_b, idxs in self._groups:
            order = idxs.copy()
            if self.shuffle:
                self._rng.shuffle(order)
            for s in range(0, len(order), b):
                chunk = order[s: s + b]
                n_real = len(chunk)
                w = np.ones(b, dtype=np.float32)
                if n_real < b:
                    chunk = np.concatenate(
                        [chunk, np.resize(order, b - n_real)])
                    w[n_real:] = 0.0
                batches.append((chunk.astype(np.int32), w, t_b))
        if self.shuffle:
            self._rng.shuffle(batches)
        return iter(batches)


def gather_batch(dev_bank: Dict[str, torch.Tensor], caps: CaptionSet,
                 idx: np.ndarray, seq_len: int = 0
                 ) -> Dict[str, torch.Tensor]:
    """A device batch: the bank's streams gathered by each caption's video
    row (``index_select`` on the bank's device), tokens int64 and
    token_mask float32.  ``seq_len`` > 0 cuts tokens and mask to that
    many steps."""
    dev = dev_bank["frames"].device
    rows = torch.from_numpy(caps.video_idx[idx].astype(np.int64)).to(dev)
    tokens = caps.tokens[idx]
    mask = caps.mask[idx]
    if seq_len:
        tokens = tokens[:, :seq_len]
        mask = mask[:, :seq_len]
    out = {k: v.index_select(0, rows) for k, v in dev_bank.items()}
    out["tokens"] = torch.from_numpy(tokens.astype(np.int64)).to(dev)
    out["token_mask"] = torch.from_numpy(np.ascontiguousarray(mask)).to(dev)
    return out


_SYN_WORDS = [
    "a", "the", "man", "woman", "dog", "cat", "is", "playing", "running",
    "jumping", "eating", "cooking", "guitar", "piano", "ball", "water",
    "riding", "bike", "horse", "singing", "dancing", "cutting", "onion",
    "slicing", "bread", "driving", "car", "walking", "street", "talking",
    "phone", "baby", "laughing", "bird", "flying", "swimming", "pool",
    "group", "people", "video", "game", "boy", "girl", "kicking", "throwing",
]


def synthetic_dataset(n_videos: int = 64, captions_per_video: int = 2,
                      k: int = 28, d: int = 1024, n_regions: int = 0,
                      region_dim: int = 1024, motion_dim: int = 0,
                      maxlen: int = 30, seed: int = 0,
                      n_words: Optional[int] = None) -> Dataset:
    """Deterministic synthetic dataset (the JAX package's, draw for draw):
    each video's captions follow a per-video word pattern, so features
    determine the caption.  ``n_words`` caps the vocab (rarer words
    encode as UNK)."""
    bank = synthetic_bank(n_videos, k=k, d=d, n_regions=n_regions,
                          region_dim=region_dim, motion_dim=motion_dim,
                          seed=seed)
    rng = np.random.RandomState(seed + 1)
    cap = len(_SYN_WORDS) + 2 if n_words is None else n_words
    vocab = Vocab.build([[w] for w in _SYN_WORDS], max_words=cap)
    pairs: List[Tuple[str, List[str]]] = []
    references: List[List[List[str]]] = []
    for i, vid in enumerate(bank.ids):
        base_len = 4 + (i % 5)
        widx = rng.randint(0, len(_SYN_WORDS),
                           size=(captions_per_video, base_len))
        refs = []
        for c in range(captions_per_video):
            toks = [_SYN_WORDS[j] for j in widx[c]]
            pairs.append((vid, toks))
            refs.append(toks)
        references.append(refs)
    caps = build_caption_set(pairs, bank, vocab, maxlen, cap)
    return Dataset(bank=bank, captions=caps, vocab=vocab,
                   references=references)
