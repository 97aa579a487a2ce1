"""Inference API on a torch device (counterpart of stvd/api.py).

    cap = Captioner.from_run_dir("runs/msvd")    # device="cuda" by default
    texts = cap.caption(features)          # (N, F, D) numpy -> [str]
    texts = cap.caption(features, regions=regions)   # spatial (preset 2)
    hyps = cap.nbest(features, n=3)        # [[(text, logprob), ...], ...]
    cap.attach_bank(FeatureBank.load("bank.npz"))
    texts = cap.caption_ids(["vid1", "vid7"])  # features already resident

``Captioner`` decodes the temporal and the spatial model by beam search
or greedy decoding, with bf16 or W8A8 int8 gates (``decode_quant='int8'``;
``gates_kernel='on'`` runs them through the fused gates kernel): captions
of raw features or of a prepared batch, n-best lists, stochastic samples,
and id-addressed requests against a feature bank resident on the device
(``BankResident``).  It loads a run directory of either package's
``cli.convert`` or of the port's ``cli.train`` (``from_run_dir``) and
swaps in new weights of the same shapes between requests
(``swap_params``).  The weights are an input of every decode call, so a
swap is the assignment of a new dict.  Not ported: the motion stream
(``motion=`` raises ``NotImplementedError``) and a bank sharded over
several devices (``attach_bank(mesh=...)`` raises likewise).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import Config, preset, validate
from .data.bank import pack_bank, to_device
from .data.text import Vocab
from .decode.beam import beam_decode
from .decode.greedy import greedy_decode
from .decode.sample import sample_decode
from .model.decoder import StepFn
from .model.kernel import get_step_fn
from .model.step import compute_dtype

# the config and vocabulary a caller needs
__all__ = ["BankResident", "Captioner", "Config", "Vocab",
           "chunked_caption", "chunked_caption_ids", "pack_request",
           "preset"]

def padded_chunks(batch: Dict[str, torch.Tensor], bsz: int):
    """``(rows, chunk)`` pairs of a batch in fixed ``bsz`` chunks, the
    last one zero-padded, so every decode runs at the same shapes and a
    video's result does not depend on the request it came in.  Padded
    rows get one valid frame so their softmax stays sane."""
    n = int(batch["frames"].shape[0])
    for s in range(0, n, bsz):
        e = min(s + bsz, n)
        chunk = {k: v[s:e] for k, v in batch.items()}
        pad = bsz - (e - s)
        if pad:
            chunk = {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
                     for k, v in chunk.items()}
            chunk["frame_mask"][e - s:, 0] = 1.0
        yield e - s, chunk


def _captions_in_window(results, vocab: Vocab, window: int) -> List[str]:
    """Captions of a lazy sequence of ``(rows, tokens)`` decode results,
    pulling (and so dispatching) up to ``window`` of them before the
    oldest one's tokens are copied to the host; each result's first
    ``rows`` captions are kept."""
    pending: List = []
    out: List[str] = []

    def drain_one():
        count, toks = pending.pop(0)
        toks = toks.cpu().numpy()
        out.extend(" ".join(vocab.decode(toks[i])) for i in range(count))

    for item in results:
        pending.append(item)
        if len(pending) >= window:
            drain_one()
    while pending:
        drain_one()
    return out


def chunked_caption(run: Callable, params, batch: Dict[str, torch.Tensor],
                    bsz: int, vocab: Vocab, window: int = 4) -> List[str]:
    """Drive ``run(params, chunk) -> (tokens, scores)`` over a batch of
    any size in ``padded_chunks`` of ``bsz`` (the JAX package's
    signature), up to ``window`` chunks in flight; the padded rows'
    captions are dropped."""
    return _captions_in_window(
        ((count, run(params, chunk)[0])
         for count, chunk in padded_chunks(batch, bsz)), vocab, window)


def chunked_caption_ids(run_ids: Callable, params,
                        bank: Dict[str, torch.Tensor], rows: np.ndarray,
                        bsz: int, vocab: Vocab, window: int = 4
                        ) -> List[str]:
    """Drive ``run_ids(params, bank, rows) -> (tokens, scores)``, a row
    gather from the resident ``bank`` and a decode, over any number of
    bank rows in fixed ``bsz`` chunks: the host moves only row indices.
    Short chunks repeat row 0 (a valid row, so masks stay sane); their
    captions are dropped.  Up to ``window`` chunks stay in flight."""
    dev = bank["frames"].device

    def results():
        for s in range(0, int(rows.shape[0]), bsz):
            chunk = np.zeros(bsz, np.int64)
            part = rows[s:s + bsz]
            chunk[:len(part)] = part
            yield len(part), run_ids(params, bank,
                                     torch.from_numpy(chunk).to(dev))[0]

    return _captions_in_window(results(), vocab, window)


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


def _check_swap_compatible(cur, new) -> None:
    """Same architecture for a weight swap: the same key set and the
    same shape for every key (the JAX package's messages)."""
    missing = sorted(set(cur) - set(new))
    extra = sorted(set(new) - set(cur))
    if missing or extra:
        raise ValueError(f"swap params key mismatch: missing={missing} "
                         f"extra={extra}")
    for k in cur:
        if tuple(cur[k].shape) != tuple(new[k].shape):
            raise ValueError(
                f"swap params shape mismatch at {k!r}: "
                f"{tuple(cur[k].shape)} -> {tuple(new[k].shape)}")


class BankResident:
    """Mixin: a feature bank resident on the device and captions of its
    videos by id.  Features are offline artifacts, so the bank belongs
    with the model: attached once, it turns a request into a list of ids
    (bytes of text in, bytes of text out) and each chunk's features into
    an ``index_select`` on the device."""

    _bank_dev: Optional[Dict[str, torch.Tensor]] = None
    _bank_index: Optional[Dict[str, int]] = None

    def attach_bank(self, bank, dtype: Optional[torch.dtype] = None,
                    mesh=None) -> int:
        """Copy a ``FeatureBank`` to the device once, its features in
        ``dtype`` (default: the compute dtype); returns the number of
        resident videos.  The copy is ``to_device``'s cached one."""
        if mesh is not None:
            raise NotImplementedError(
                "a bank sharded over several devices is not ported yet "
                "(ROADMAP.md Queue 1 item 8)")
        self._bank_index = bank.index()
        self._bank_dev = to_device(bank, self.device,
                                   dtype or compute_dtype(self.cfg.model))
        return bank.n_videos

    @property
    def bank_ids(self) -> List[str]:
        if self._bank_index is None:
            return []
        return sorted(self._bank_index, key=self._bank_index.__getitem__)

    def _bank_keys(self) -> List[str]:
        """The streams this model reads; a bank may carry more."""
        m = self.cfg.model
        keys = ["frames", "frame_mask"]
        if m.use_spatial:
            keys.append("regions")
        if m.use_motion:
            keys.append("motion")
        bad = [k for k in keys if k not in self._bank_dev]
        if bad:
            raise ValueError(f"bank lacks streams the model needs: {bad}")
        return keys

    def _rows_for(self, ids: Sequence[str]) -> np.ndarray:
        if self._bank_dev is None:
            raise ValueError("no feature bank attached "
                             "(attach_bank / cli/serve --bank)")
        idx = self._bank_index
        missing = [v for v in ids if v not in idx]
        if missing:
            raise ValueError(f"unknown video ids: {missing[:5]}"
                             + ("..." if len(missing) > 5 else ""))
        return np.asarray([idx[v] for v in ids], np.int64)

    def _resident(self) -> Dict[str, torch.Tensor]:
        return {k: self._bank_dev[k] for k in self._bank_keys()}

    def caption_ids(self, ids: Sequence[str]) -> List[str]:
        """Captions of resident-bank videos by id (no feature transfer:
        each chunk gathers its rows on the device and decodes them)."""
        return self._caption_rows(self._rows_for(ids))

    def _caption_rows(self, rows: np.ndarray) -> List[str]:
        raise NotImplementedError  # Captioner

    def nbest_ids(self, ids: Sequence[str], n: Optional[int] = None,
                  norm: bool = True) -> List[List[tuple]]:
        """``caption_nbest`` of resident-bank videos by id."""
        rows = torch.from_numpy(self._rows_for(ids)).to(self.device)
        batch = {k: v.index_select(0, rows)
                 for k, v in self._resident().items()}
        return self.caption_nbest(batch, n=n, norm=norm)


class Captioner(BankResident):
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
        self.params = self._on_device(params)
        self.cfg = cfg
        self.vocab = vocab
        self.step_fn = step_fn or get_step_fn(None, self.device)

    def _on_device(self, params) -> Dict[str, torch.Tensor]:
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.array(v, np.float32))
                    ).to(self.device, torch.float32)
                for k, v in params.items()}

    @staticmethod
    def from_run_dir(run_dir: str, best: bool = True,
                     vocab: Optional[Vocab] = None,
                     step_fn: Optional[StepFn] = None,
                     quant: Optional[str] = None, *,
                     device: torch.device | str = "cuda") -> "Captioner":
        """Load ``config.json``, the weights of ``ckpt_best.pt`` (or of
        ``ckpt.pt`` with ``best=False`` or when there is no best) and,
        unless ``vocab`` is given, ``vocab.pkl`` from a run directory of
        the port (``cli.train``, ``cli.convert``).  ``quant`` overrides
        ``model.decode_quant`` ('int8' serves through W8A8 gates however
        the model was trained)."""
        with open(os.path.join(run_dir, "config.json")) as f:
            cfg = Config.from_json(f.read())
        if quant is not None:
            cfg = validate(dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model,
                                               decode_quant=quant)))
        path = os.path.join(run_dir,
                            "ckpt_best.pt" if best else "ckpt.pt")
        if not os.path.exists(path):
            path = os.path.join(run_dir, "ckpt.pt")
        params = torch.load(path, map_location="cpu",
                            weights_only=True)["params"]
        if vocab is None:
            vpath = os.path.join(run_dir, "vocab.pkl")
            if not os.path.exists(vpath):
                raise ValueError("no vocab.pkl in run dir; pass vocab=")
            vocab = Vocab.load_pickle(vpath)
        return Captioner(params, cfg, vocab, step_fn, device=device)

    def swap_params(self, params) -> None:
        """Swap in weights of the same architecture (key set and shapes
        must match).  A new dict is assigned; the old one's tensors are
        never written, so a decode that holds them finishes on them."""
        params = dict(params)
        _check_swap_compatible(self.params, params)
        self.params = self._on_device(params)

    def _run(self, params, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(params, batch) -> (tokens, scores): the best beam and its
        length-normalized score, or the greedy caption and its log-prob.
        The weights are an input of the call, not read from ``self``, so
        a concurrent ``swap_params`` never changes them mid-request;
        ``inference_mode`` is entered here because it is thread-local."""
        cfg = self.cfg
        d = cfg.decode
        with torch.inference_mode():
            if d.beam_size <= 1:
                out = greedy_decode(params, cfg.model, batch,
                                    maxlen=d.maxlen, step_fn=self.step_fn)
                return out.tokens, out.scores
            out = beam_decode(params, cfg.model, batch,
                              beam_size=d.beam_size, maxlen=d.maxlen,
                              length_norm=d.length_norm,
                              step_fn=self.step_fn)
            return out.tokens, out.norm_scores

    def _run_ids(self, params, bank: Dict[str, torch.Tensor],
                 rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._run(params, {k: v.index_select(0, rows)
                                  for k, v in bank.items()})

    def caption_batch(self, batch: Dict[str, torch.Tensor]) -> List[str]:
        """Caption a prepared device batch in ``decode_batch`` chunks."""
        return chunked_caption(self._run, self.params, batch,
                               self.cfg.decode.decode_batch, self.vocab)

    def _caption_rows(self, rows: np.ndarray) -> List[str]:
        return chunked_caption_ids(self._run_ids, self.params,
                                   self._resident(), rows,
                                   self.cfg.decode.decode_batch, self.vocab)

    def caption_nbest(self, batch: Dict[str, torch.Tensor],
                      n: Optional[int] = None, norm: bool = True
                      ) -> List[List[tuple]]:
        """Every beam hypothesis per video, ``[(text, logprob), ...]``
        best first, decoded in ``decode_batch`` chunks like ``caption``.
        ``norm=True`` ranks by the length-normalized score, the one
        best-beam selection uses, so entry 0 is ``caption()``'s caption;
        ``norm=False`` ranks by the raw log-prob.  The score given is the
        one ranked by."""
        cfg = self.cfg
        if cfg.decode.beam_size <= 1:
            raise ValueError("n-best export requires beam_size > 1")
        params = self.params
        res: List[List[tuple]] = []
        for count, chunk in padded_chunks(batch, cfg.decode.decode_batch):
            with torch.inference_mode():
                out = beam_decode(params, cfg.model, chunk,
                                  beam_size=cfg.decode.beam_size,
                                  maxlen=cfg.decode.maxlen,
                                  length_norm=cfg.decode.length_norm,
                                  step_fn=self.step_fn)
            toks = out.all_tokens[:count].cpu().numpy()
            scores = (out.all_norm_scores if norm
                      else out.all_scores)[:count].cpu().numpy()
            k = n or toks.shape[1]
            for b in range(count):
                order = np.argsort(-scores[b])[:k]
                res.append([(" ".join(self.vocab.decode(toks[b, j])),
                             float(scores[b, j])) for j in order])
        return res

    def caption_sample(self, batch: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator] = None,
                       temperature: float = 1.0, top_k: int = 0,
                       n_samples: int = 1) -> List[List[str]]:
        """``n_samples`` captions drawn per video (``sample_decode``);
        ``generator`` lives on the device (default: seed 0)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        with torch.inference_mode():
            toks = sample_decode(
                self.params, self.cfg.model, batch, generator,
                maxlen=self.cfg.decode.maxlen, temperature=temperature,
                top_k=top_k, n_samples=n_samples,
                step_fn=self.step_fn).tokens.cpu().numpy()
        return [[" ".join(self.vocab.decode(toks[b, j]))
                 for j in range(toks.shape[1])] for b in range(toks.shape[0])]

    def caption(self, features: Union[np.ndarray, Sequence[np.ndarray]],
                regions: Optional[Sequence[np.ndarray]] = None,
                motion: Optional[Sequence[np.ndarray]] = None
                ) -> List[str]:
        """Caption raw per-video feature arrays: (N, F, D) or a list of
        (F_i, D) arrays, with per-video (F_i, R, Dr) region features for
        the spatial model.  ``motion`` raises ``NotImplementedError``
        until the motion stream is ported."""
        return self.caption_batch(
            pack_request(self.cfg.model, features, regions, motion,
                         device=self.device))

    def nbest(self, features: Union[np.ndarray, Sequence[np.ndarray]],
              regions: Optional[Sequence[np.ndarray]] = None,
              motion: Optional[Sequence[np.ndarray]] = None,
              n: Optional[int] = None, norm: bool = True
              ) -> List[List[tuple]]:
        """``caption_nbest`` of raw feature arrays (packed as
        ``caption`` packs them)."""
        return self.caption_nbest(
            pack_request(self.cfg.model, features, regions, motion,
                         device=self.device), n=n, norm=norm)
