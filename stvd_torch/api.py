"""Inference API on a torch device (counterpart of stvd/api.py).

    cap = Captioner(params, cfg, vocab)        # device="cuda" by default
    texts = cap.caption(features)          # (N, F, D) numpy -> [str]
    texts = cap.caption(features, regions=regions)   # spatial (preset 2)

Ported so far: ``pack_request``, ``chunked_caption`` and
``Captioner.caption`` / ``caption_batch`` for the temporal and the
spatial model, by beam search or greedy decoding, with bf16 or W8A8 int8
gates (``decode_quant='int8'``; ``gates_kernel='on'`` runs them through
the fused gates kernel).  The motion stream, loading a run directory,
n-best lists, sampling and bank-resident requests are still to come.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .config import Config, preset
from .data.bank import pack_bank, to_device
from .data.text import Vocab
from .decode.beam import beam_decode
from .decode.greedy import greedy_decode
from .model.decoder import StepFn
from .model.kernel import get_step_fn
from .model.step import compute_dtype

# the config and vocabulary a caller needs
__all__ = ["Captioner", "Config", "Vocab", "chunked_caption",
           "pack_request", "preset"]


def chunked_caption(run: Callable[[Dict], torch.Tensor],
                    batch: Dict[str, torch.Tensor], bsz: int,
                    vocab: Vocab) -> List[str]:
    """Drive ``run(chunk) -> tokens`` over a batch of any size in fixed
    ``bsz`` chunks, the last one zero-padded, so every decode runs at the
    same shapes.  Padded rows get one valid frame so their softmax stays
    sane; their captions are dropped."""
    n = int(batch["frames"].shape[0])
    out: List[str] = []
    for s in range(0, n, bsz):
        e = min(s + bsz, n)
        chunk = {k: v[s:e] for k, v in batch.items()}
        pad = bsz - (e - s)
        if pad:
            chunk = {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
                     for k, v in chunk.items()}
            chunk["frame_mask"][e - s:, 0] = 1.0
        toks = run(chunk).cpu().numpy()
        out.extend(" ".join(vocab.decode(toks[i])) for i in range(e - s))
    return out


def pack_request(model_cfg, features, regions=None, motion=None, *,
                 device: torch.device | str = "cuda"
                 ) -> Dict[str, torch.Tensor]:
    """Raw per-video feature arrays -> a device batch (frames and regions
    in the compute dtype, frame_mask float32).  ``features`` is (N, F, D)
    or a list of (F_i, D) arrays, ``regions`` a matching sequence of
    (F_i, R, Dr) arrays; frame counts are subsampled or padded to the
    model's K by ``pack_bank``.  The positional parameters are the JAX
    package's; ``device`` is keyword-only."""
    if motion is not None:
        raise NotImplementedError("the motion stream is not ported yet")
    if isinstance(features, np.ndarray) and features.ndim == 3:
        feats = {f"v{i}": features[i] for i in range(features.shape[0])}
    else:
        feats = {f"v{i}": np.asarray(f) for i, f in enumerate(features)}
    ids = [f"v{i}" for i in range(len(feats))]
    regs = ({v: np.asarray(r) for v, r in zip(ids, regions)}
            if regions is not None else None)
    bank = pack_bank(feats, model_cfg.n_frames, ids=ids, regions=regs)
    return to_device(bank, device, compute_dtype(model_cfg))


class Captioner:
    """Caption pre-extracted video features with a model on ``device``.

    ``params`` is a dict of numpy arrays or tensors keyed by the JAX
    parameter names (float32 masters; the decode casts them to the compute
    dtype).  ``step_fn=None`` picks the kernel step on a CUDA device and
    the plain step elsewhere.  The positional parameters are the JAX
    package's; ``device`` is keyword-only and defaults to the card, so
    without one the Captioner raises instead of running on the CPU."""

    def __init__(self, params, cfg: Config, vocab: Vocab,
                 step_fn: Optional[StepFn] = None, *,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Captioner: no CUDA device; pass "
                               "device='cpu' to run on the CPU")
        self.params = {
            k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.array(v, np.float32))
                ).to(self.device, torch.float32)
            for k, v in params.items()}
        self.cfg = cfg
        self.vocab = vocab
        self.step_fn = step_fn or get_step_fn(None, self.device)

    def _run(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        d = cfg.decode
        with torch.inference_mode():
            if d.beam_size <= 1:
                return greedy_decode(self.params, cfg.model, batch,
                                     maxlen=d.maxlen,
                                     step_fn=self.step_fn).tokens
            return beam_decode(self.params, cfg.model, batch,
                               beam_size=d.beam_size, maxlen=d.maxlen,
                               length_norm=d.length_norm,
                               step_fn=self.step_fn).tokens

    def caption_batch(self, batch: Dict[str, torch.Tensor]) -> List[str]:
        """Caption a prepared device batch in ``decode_batch`` chunks."""
        return chunked_caption(self._run, batch,
                               self.cfg.decode.decode_batch, self.vocab)

    def caption(self, features: Union[np.ndarray, Sequence[np.ndarray]],
                regions: Optional[Sequence[np.ndarray]] = None
                ) -> List[str]:
        """Caption raw per-video feature arrays: (N, F, D) or a list of
        (F_i, D) arrays, with per-video (F_i, R, Dr) region features for
        the spatial model."""
        return self.caption_batch(
            pack_request(self.cfg.model, features, regions,
                         device=self.device))
