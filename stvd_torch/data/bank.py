"""Feature banks: packed video features, and their place on a device.

The numpy part is the port's copy of ``stvd/data/bank.py``: ``pack_bank``
packs per-video feature arrays once into dense arrays

    frames     (N, K, D)      float32
    frame_mask (N, K)         float32 (1 where a real frame exists)
    regions    (N, K, R, Dr)  optional (spatial attention)
    motion     (N, K, Dm)     optional (motion stream)

and ``to_device`` puts them on a torch device, once per (device, dtype),
from which a training batch is an ``index_select`` gather
(``batching.gather_batch``); ``to_device_sharded`` puts one rank's share
of the video rows on its device, for a bank split over a data mesh.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Dict, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class FeatureBank:
    """A packed feature bank; ``ids[i]`` names the video at row ``i``."""

    ids: Sequence[str]
    frames: np.ndarray
    frame_mask: np.ndarray
    regions: Optional[np.ndarray] = None
    motion: Optional[np.ndarray] = None
    # (device, dtype) -> the tensors ``to_device`` made; not part of the
    # bank's value (compare/repr excluded)
    _dev_cache: Dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def n_videos(self) -> int:
        return self.frames.shape[0]

    @property
    def n_frames(self) -> int:
        return self.frames.shape[1]

    def index(self) -> Dict[str, int]:
        return {v: i for i, v in enumerate(self.ids)}

    def save(self, path: str) -> None:
        """A compressed ``.npz`` with the JAX package's keys (``frames``,
        ``frame_mask``, ``ids``, and ``regions``/``motion`` when
        present), so either package loads the other's file."""
        arrs = dict(frames=self.frames, frame_mask=self.frame_mask,
                    ids=np.asarray(list(self.ids)))
        if self.regions is not None:
            arrs["regions"] = self.regions
        if self.motion is not None:
            arrs["motion"] = self.motion
        np.savez_compressed(path, **arrs)

    @staticmethod
    def load(path: str) -> "FeatureBank":
        z = np.load(path, allow_pickle=False)
        return FeatureBank(
            ids=[str(s) for s in z["ids"]],
            frames=z["frames"],
            frame_mask=z["frame_mask"],
            regions=z["regions"] if "regions" in z.files else None,
            motion=z["motion"] if "motion" in z.files else None,
        )


def subsample_frames(feat: np.ndarray, k: int) -> np.ndarray:
    """Up to ``k`` frames of ``(F, ...)``, at a uniform stride when F > k."""
    f = feat.shape[0]
    if f <= k:
        return feat
    idx = np.floor(np.linspace(0, f - 1, k)).astype(np.int64)
    return feat[idx]


def pack_bank(feats: Dict[str, np.ndarray], k: int,
              ids: Optional[Sequence[str]] = None,
              regions: Optional[Dict[str, np.ndarray]] = None,
              motion: Optional[Dict[str, np.ndarray]] = None) -> FeatureBank:
    """Pack per-video ``(F, D)`` features (and ``(F, R, Dr)`` regions,
    ``(F, Dm)`` motion) into a dense bank; frames past a video's length
    are zero and masked out."""
    vids = list(ids) if ids is not None else sorted(feats)
    n = len(vids)
    d = next(iter(feats.values())).shape[-1]
    frames = np.zeros((n, k, d), dtype=np.float32)
    mask = np.zeros((n, k), dtype=np.float32)
    reg_arr = mot_arr = None
    if regions is not None:
        r0 = next(iter(regions.values()))
        reg_arr = np.zeros((n, k, r0.shape[-2], r0.shape[-1]), np.float32)
    if motion is not None:
        m0 = next(iter(motion.values()))
        mot_arr = np.zeros((n, k, m0.shape[-1]), dtype=np.float32)
    for i, v in enumerate(vids):
        f = subsample_frames(np.asarray(feats[v], dtype=np.float32), k)
        frames[i, : f.shape[0]] = f
        mask[i, : f.shape[0]] = 1.0
        if reg_arr is not None:
            r = subsample_frames(np.asarray(regions[v], dtype=np.float32), k)
            reg_arr[i, : r.shape[0]] = r
        if mot_arr is not None:
            m = subsample_frames(np.asarray(motion[v], dtype=np.float32), k)
            mot_arr[i, : m.shape[0]] = m
    return FeatureBank(ids=vids, frames=frames, frame_mask=mask,
                       regions=reg_arr, motion=mot_arr)


def load_legacy_pickle(path: str) -> Dict[str, np.ndarray]:
    """A reference-era feature pickle (video id -> array); a Python 2
    pickle's numpy payloads decode with latin-1."""
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="latin1")
    return {str(k): np.asarray(v) for k, v in d.items()}


def synthetic_bank(n_videos: int, k: int = 28, d: int = 1024,
                   n_regions: int = 0, region_dim: int = 1024,
                   motion_dim: int = 0, seed: int = 0,
                   varying_lengths: bool = True) -> FeatureBank:
    """Deterministic random bank: each video has its own signature plus
    per-frame noise, drawn in the JAX package's order so both packages
    make the same bank from one seed."""
    rng = np.random.RandomState(seed)
    feats = {}
    regions = {} if n_regions else None
    motion = {} if motion_dim else None
    for i in range(n_videos):
        f = rng.randint(max(2, k // 2), k + 1) if varying_lengths else k
        base = rng.randn(1, d).astype(np.float32)
        feats[f"vid{i:04d}"] = base + 0.1 * rng.randn(f, d).astype(np.float32)
        if regions is not None:
            rbase = rng.randn(1, 1, region_dim).astype(np.float32)
            regions[f"vid{i:04d}"] = (
                rbase + 0.1 * rng.randn(f, n_regions, region_dim
                                        ).astype(np.float32))
        if motion is not None:
            mbase = rng.randn(1, motion_dim).astype(np.float32)
            motion[f"vid{i:04d}"] = (
                mbase + 0.1 * rng.randn(f, motion_dim).astype(np.float32))
    ids = sorted(feats)
    return pack_bank(feats, k, ids=ids, regions=regions, motion=motion)


def to_device(bank: FeatureBank, device: torch.device | str,
              dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Feature streams cast to ``dtype`` (the compute dtype), the frame
    mask kept float32; streams the bank lacks are omitted.

    Cached per (device, dtype) on the bank, as the JAX package caches
    its uploads: ``fit`` and every ``evaluate_nll`` round call this, and
    each would otherwise copy the whole bank to the device again.  The
    bank is treated as immutable after its first upload, and callers
    gather from the tensors (``gather_batch``) without writing into
    them."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (dev, dtype)
    cache = bank._dev_cache if isinstance(bank, FeatureBank) else {}
    if key in cache:
        return cache[key]

    def put(x, cast: bool):
        t = torch.from_numpy(x)
        return t.to(device=dev, dtype=dtype if cast else None)

    out = {"frames": put(bank.frames, True),
           "frame_mask": put(bank.frame_mask, False)}
    if bank.regions is not None:
        out["regions"] = put(bank.regions, True)
    if bank.motion is not None:
        out["motion"] = put(bank.motion, True)
    cache[key] = out
    return out


def to_device_sharded(bank: FeatureBank, mesh, device: torch.device | str,
                      dtype: Optional[torch.dtype] = None
                      ) -> Dict[str, torch.Tensor]:
    """This rank's shard of the bank's video rows over the 1-D
    ``('data',)`` mesh (``train.parallel``): with N videos over n ranks
    and ``sn = ceil(N / n)``, rank r holds rows ``[r*sn, (r+1)*sn)`` of
    the bank zero-padded to ``n*sn`` rows, so every shard has ``sn``
    rows; padded rows are never addressed (ids are checked against the
    real index).  Streams as in ``to_device``; cached on the bank per
    (device, dtype, axis size, rank) like ``to_device``.  Every rank
    calls this; nothing crosses between ranks."""
    from ..train import parallel
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    n, r = parallel.axis_size(mesh), parallel.axis_rank(mesh)
    key = ("sharded", dev, dtype, n, r)
    if key in bank._dev_cache:
        return bank._dev_cache[key]
    sn = -(-bank.n_videos // n)
    lo, hi = min(r * sn, bank.n_videos), min((r + 1) * sn, bank.n_videos)

    def put(x, cast: bool):
        part = np.zeros((sn,) + x.shape[1:], x.dtype)
        part[:hi - lo] = x[lo:hi]
        return torch.from_numpy(part).to(device=dev,
                                         dtype=dtype if cast else None)

    out = {"frames": put(bank.frames, True),
           "frame_mask": put(bank.frame_mask, False)}
    if bank.regions is not None:
        out["regions"] = put(bank.regions, True)
    if bank.motion is not None:
        out["motion"] = put(bank.motion, True)
    bank._dev_cache[key] = out
    return out
