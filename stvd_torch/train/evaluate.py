"""Split evaluation: batched decode, caption metrics and the samples
files (counterpart of stvd/train/evaluate.py).

Every video of a split is decoded (beam search, or greedy at
``beam_size <= 1``) in fixed-size batches on the device, its caption
written to ``{split}_samples.txt`` and ``.json`` in the run directory,
and the split scored with the COCO metrics (``metrics.scorer``); the
metric dict is what ``fit`` selects a model by.  The decode is eager:
there is no compiled executable to cache.  With a 1-D ``('data',)`` mesh
(``train.parallel``) each rank decodes its slice of every decode batch
and the tokens are gathered, so every rank returns every caption.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.bank import to_device
from ..data.batching import Dataset
from ..decode.beam import beam_decode
from ..decode.greedy import greedy_decode
from ..metrics.scorer import score_all
from ..model.decoder import StepFn
from ..model.kernel import get_step_fn
from ..model.step import compute_dtype
from . import parallel


def generate_captions(params, mcfg, dev_bank: Dict[str, torch.Tensor],
                      n_videos: int, dcfg, step_fn: Optional[StepFn] = None,
                      mesh=None) -> List[List[int]]:
    """One caption's token ids per video row of ``dev_bank``, decoded in
    batches of ``min(decode_batch, n_videos)`` rows; the last batch is
    filled with row 0 and its extra captions dropped, so every batch has
    one shape.  All batches are dispatched before the first is read.

    With a ``mesh`` (every rank calls this with the same arguments) the
    batch is rounded down to a multiple of the data-axis size (at least
    one row a rank), each rank decodes its contiguous slice of every
    batch, and one ``all_gather`` a batch brings every rank all tokens,
    as the JAX package's batch-sharded decode does."""
    bsz = min(dcfg.decode_batch, n_videos)
    if mesh is not None:
        n_dev = parallel.axis_size(mesh)
        bsz = max(n_dev, (bsz // n_dev) * n_dev)
    mine = parallel.local_slice(bsz, mesh)
    dev = dev_bank["frames"].device
    pending = []
    with torch.no_grad():
        for s in range(0, n_videos, bsz):
            rows = np.arange(s, min(s + bsz, n_videos))
            pad = bsz - len(rows)
            if pad:
                rows = np.concatenate([rows, np.zeros(pad, np.int64)])
            idx = torch.from_numpy(rows[mine].astype(np.int64)).to(dev)
            batch = {k: v.index_select(0, idx) for k, v in dev_bank.items()}
            if dcfg.beam_size <= 1:
                toks = greedy_decode(params, mcfg, batch, maxlen=dcfg.maxlen,
                                     step_fn=step_fn).tokens
            else:
                toks = beam_decode(params, mcfg, batch,
                                   beam_size=dcfg.beam_size,
                                   maxlen=dcfg.maxlen,
                                   length_norm=dcfg.length_norm,
                                   step_fn=step_fn).tokens
            pending.append((bsz - pad, toks))
        if mesh is not None:
            pending = [(n, parallel.all_gather_rows(t, mesh))
                       for n, t in pending]
    out: List[List[int]] = []
    for n_real, toks in pending:
        toks = toks.cpu().numpy()
        out.extend(toks[i].tolist() for i in range(n_real))
    return out


def evaluate_split(params, cfg, ds: Dataset, split: str = "valid",
                   save_dir: Optional[str] = None,
                   step_fn: Optional[StepFn] = None, mesh=None, *,
                   device: torch.device | str = "cuda") -> Dict[str, float]:
    """Decode and score a split on ``device``; with ``save_dir``, write
    ``{split}_samples.txt`` (``vid<TAB>caption`` lines) and
    ``{split}_samples.json`` as the JAX package writes them.  Videos
    without references are not scored; an empty caption scores as
    ``"unk"``.  ``step_fn=None`` takes ``get_step_fn(None, device)``:
    the kernel step on a CUDA device.  With a ``mesh`` every rank calls
    this with the same arguments: the decode is data-parallel
    (``generate_captions``), every rank scores all captions on the host
    (the same metrics on every rank) and rank 0 alone writes the
    samples files."""
    if step_fn is None:
        step_fn = get_step_fn(None, device)
    dev_bank = to_device(ds.bank, device, compute_dtype(cfg.model))
    token_rows = generate_captions(params, cfg.model, dev_bank,
                                   ds.bank.n_videos, cfg.decode,
                                   step_fn=step_fn, mesh=mesh)
    if parallel.axis_rank(mesh) != 0:
        save_dir = None
    hyps: Dict[str, List[str]] = {}
    gts: Dict[str, List[str]] = {}
    for row, vid in enumerate(ds.bank.ids):
        if not ds.references[row]:
            continue
        toks = ds.vocab.decode(token_rows[row])
        hyps[vid] = [" ".join(toks) if toks else "unk"]
        gts[vid] = [" ".join(r) for r in ds.references[row]]
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, f"{split}_samples.txt"), "w") as f:
            for vid in ds.bank.ids:
                if vid in hyps:
                    f.write(f"{vid}\t{hyps[vid][0]}\n")
        with open(os.path.join(save_dir, f"{split}_samples.json"), "w") as f:
            json.dump([{"image_id": v, "caption": hyps[v][0]}
                       for v in ds.bank.ids if v in hyps], f, indent=1)
    return score_all(gts, hyps, meteor_profile=cfg.train.meteor_profile)
