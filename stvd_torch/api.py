"""Inference API on a torch device (counterpart of stvd/api.py).

    cap = Captioner.from_run_dir("runs/msvd")    # device="cuda" by default
    texts = cap.caption(features)          # (N, F, D) numpy -> [str]
    texts = cap.caption(features, regions=regions)   # spatial (preset 2)
    texts = cap.caption(features, None, motion)      # dual stream (preset 4)
    hyps = cap.nbest(features, n=3)        # [[(text, logprob), ...], ...]
    cap.attach_bank(FeatureBank.load("bank.npz"))
    texts = cap.caption_ids(["vid1", "vid7"])  # features already resident

``Captioner`` decodes the temporal, the spatial and the dual-stream
(appearance + motion, optionally with the frame-LSTM encoder) models by
beam search or greedy decoding, with bf16 or W8A8 int8 gates (``decode_quant='int8'``;
``gates_kernel='on'`` runs them through the fused gates kernel): captions
of raw features or of a prepared batch, n-best lists, stochastic samples,
and id-addressed requests against a feature bank resident on the device
(``BankResident``).  It loads a run directory of either package's
``cli.convert`` or of the port's ``cli.train`` (``from_run_dir``) and
swaps in new weights of the same shapes between requests
(``swap_params``).  The weights are an input of every decode call, so a
swap is the assignment of a new dict.  A bank too large for one device
is sharded over the data axis of a mesh of ranks
(``attach_bank(bank, mesh=mesh)``, ``train.parallel``; a 1-D
``('data',)`` mesh, or a sharded artifact's 2-D ``('data', 'model')``
one, whose model ranks hold the same rows): every rank holds its share
of the videos and calls each id request with the same arguments, and
every rank gets every caption.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import Config, preset, validate
from .data.bank import pack_bank, to_device, to_device_sharded
from .data.text import Vocab
from .decode.beam import beam_decode
from .decode.greedy import greedy_decode
from .decode.sample import sample_decode
from .model.decoder import StepFn
from .model.kernel import get_step_fn
from .model.step import compute_dtype
from .train import parallel
from .utils.profiling import span, spanned

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
        with span("stvd.request.copy"):
            toks = toks.cpu().numpy()
        with span("stvd.request.detok"):
            out.extend(" ".join(vocab.decode(toks[i]))
                       for i in range(count))

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
            with span("stvd.request.rows"):
                chunk = torch.from_numpy(chunk).to(dev)
            yield len(part), run_ids(params, bank, chunk)[0]

    return _captions_in_window(results(), vocab, window)


def pack_request(model_cfg, features, regions=None, motion=None, *,
                 device: torch.device | str = "cuda"
                 ) -> Dict[str, torch.Tensor]:
    """Raw per-video feature arrays -> a device batch (frames, regions and
    motion in the compute dtype, frame_mask float32).  ``features`` is
    (N, F, D) or a list of (F_i, D) arrays, ``regions`` a matching
    sequence of (F_i, R, Dr) arrays, ``motion`` one of (F_i, Dm) arrays;
    frame counts are subsampled or padded to the model's K by
    ``pack_bank``.  The positional parameters are the JAX package's;
    ``device`` is keyword-only."""
    if isinstance(features, np.ndarray) and features.ndim == 3:
        feats = {f"v{i}": features[i] for i in range(features.shape[0])}
    else:
        feats = {f"v{i}": np.asarray(f) for i, f in enumerate(features)}
    ids = [f"v{i}" for i in range(len(feats))]
    regs = ({v: np.asarray(r) for v, r in zip(ids, regions)}
            if regions is not None else None)
    mots = ({v: np.asarray(m) for v, m in zip(ids, motion)}
            if motion is not None else None)
    bank = pack_bank(feats, model_cfg.n_frames, ids=ids, regions=regs,
                     motion=mots)
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


def _bank_local_gather(bank: Dict[str, torch.Tensor], rows: torch.Tensor,
                       mesh, scatter: bool) -> Dict[str, torch.Tensor]:
    """The row gather of a bank sharded over the data axis
    (``to_device_sharded``; every rank calls it with the same global
    ``rows``): each rank looks up the rows it owns, the others clamped to
    a valid index and set to zero, and one sum over the data axis a
    stream (each model rank of a 2-D mesh in its own data group)
    assembles the chunk, only this rank's contiguous slice of it with
    ``scatter`` (the chunk divides the axis; the JAX package's
    ``psum_scatter``), all of it otherwise (its ``psum``)."""
    start = parallel.axis_rank(mesh)
    out = {}
    for k, leaf in bank.items():
        sn = leaf.shape[0]
        local = rows - start * sn
        mine = (local >= 0) & (local < sn)
        g = leaf.index_select(0, local.clamp(0, sn - 1))
        g = torch.where(mine.view((-1,) + (1,) * (g.dim() - 1)), g,
                        torch.zeros((), dtype=g.dtype, device=g.device))
        out[k] = parallel.sum_rows(g, mesh, scatter)
    return out


class BankResident:
    """Mixin: a feature bank resident on the device and captions of its
    videos by id.  Features are offline artifacts, so the bank belongs
    with the model: attached once, it turns a request into a list of ids
    (bytes of text in, bytes of text out) and each chunk's features into
    an ``index_select`` on the device."""

    _bank_dev: Optional[Dict[str, torch.Tensor]] = None
    _bank_index: Optional[Dict[str, int]] = None
    _bank_mesh = None

    def attach_bank(self, bank, dtype: Optional[torch.dtype] = None,
                    mesh=None) -> int:
        """Copy a ``FeatureBank`` to the device once, its features in
        ``dtype`` (default: the compute dtype); returns the number of
        resident videos.  The copy is ``to_device``'s cached one.

        ``mesh`` (a 1-D ``('data',)`` mesh, ``parallel.make_mesh``, or
        a 2-D ``('data', 'model')`` one) shards the video rows over the
        data axis, for a bank larger than one device holds: each rank
        keeps ``ceil(N / n)`` of them (``to_device_sharded``; the ranks
        of a model group the same ones), and every rank calls this and
        each later id request with the same arguments.  A mesh without a
        data axis raises ``ValueError``.  A chunk of ids is gathered
        by one sum over the ranks; a chunk that divides the axis is then
        decoded data-parallel (each rank its slice, the tokens gathered),
        any other chunk whole on every rank."""
        dtype = dtype or compute_dtype(self.cfg.model)
        if mesh is None:
            dev = to_device(bank, self.device, dtype)
        else:
            parallel.check_data_mesh(mesh)
            dev = to_device_sharded(bank, mesh, self.device, dtype)
        self._bank_index = bank.index()
        self._bank_dev = dev
        self._bank_mesh = mesh
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

    @spanned("stvd.request")
    def caption_ids(self, ids: Sequence[str]) -> List[str]:
        """Captions of resident-bank videos by id (no feature transfer:
        each chunk gathers its rows on the device and decodes them)."""
        with span("stvd.request.rows"):
            rows = self._rows_for(ids)
        return self._caption_rows(rows)

    def _caption_rows(self, rows: np.ndarray) -> List[str]:
        raise NotImplementedError  # Captioner

    def nbest_ids(self, ids: Sequence[str], n: Optional[int] = None,
                  norm: bool = True) -> List[List[tuple]]:
        """``caption_nbest`` of resident-bank videos by id."""
        if self._bank_mesh is not None:
            return self._nbest_rows(self._rows_for(ids), n=n, norm=norm)
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
        if self._bank_mesh is None:
            return self._run(params, {k: v.index_select(0, rows)
                                      for k, v in bank.items()})
        return self._on_shards(self._run, params, bank, rows)

    def _on_shards(self, run: Callable, params,
                   bank: Dict[str, torch.Tensor], rows: torch.Tensor):
        """``run(params, batch)`` over ``rows`` of the sharded bank: the
        chunk is gathered (``_bank_local_gather``); one that divides the
        data axis is decoded a slice a rank and its outputs gathered, any
        other whole on every rank."""
        mesh = self._bank_mesh
        scatter = rows.shape[0] % parallel.axis_size(mesh) == 0
        with torch.inference_mode():
            out = run(params, _bank_local_gather(bank, rows, mesh, scatter))
            if scatter:
                out = tuple(parallel.all_gather_rows(t, mesh) for t in out)
        return out

    @spanned("stvd.request")
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
        if self.cfg.decode.beam_size <= 1:
            raise ValueError("n-best export requires beam_size > 1")
        params = self.params
        res: List[List[tuple]] = []
        for count, chunk in padded_chunks(batch, self.cfg.decode.decode_batch):
            toks, scores = self._nbest_decode(params, chunk, norm)
            res += self._nbest_lists(toks[:count], scores[:count], n)
        return res

    def _nbest_decode(self, params, batch: Dict[str, torch.Tensor],
                      norm: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every hypothesis's tokens (B, beam, maxlen) and its score."""
        cfg = self.cfg
        with torch.inference_mode():
            out = beam_decode(params, cfg.model, batch,
                              beam_size=cfg.decode.beam_size,
                              maxlen=cfg.decode.maxlen,
                              length_norm=cfg.decode.length_norm,
                              step_fn=self.step_fn)
        return out.all_tokens, (out.all_norm_scores if norm
                                else out.all_scores)

    def _nbest_lists(self, toks: torch.Tensor, scores: torch.Tensor,
                     n: Optional[int]) -> List[List[tuple]]:
        toks, scores = toks.cpu().numpy(), scores.cpu().numpy()
        k = n or toks.shape[1]
        res = []
        for b in range(toks.shape[0]):
            order = np.argsort(-scores[b])[:k]
            res.append([(" ".join(self.vocab.decode(toks[b, j])),
                         float(scores[b, j])) for j in order])
        return res

    def _nbest_rows(self, rows: np.ndarray, n: Optional[int] = None,
                    norm: bool = True) -> List[List[tuple]]:
        """``nbest_ids`` over a sharded bank, in ``decode_batch`` chunks
        of bank rows (short chunks repeat row 0), each run ``_on_shards``:
        feature bytes never leave the device."""
        if self.cfg.decode.beam_size <= 1:
            raise ValueError("n-best export requires beam_size > 1")
        bank = self._resident()
        bsz = self.cfg.decode.decode_batch
        res: List[List[tuple]] = []
        for s in range(0, int(rows.shape[0]), bsz):
            part = rows[s:s + bsz]
            chunk = np.zeros(bsz, np.int64)
            chunk[:len(part)] = part
            toks, scores = self._on_shards(
                lambda p, b: self._nbest_decode(p, b, norm), self.params,
                bank, torch.from_numpy(chunk).to(self.device))
            res += self._nbest_lists(toks[:len(part)], scores[:len(part)], n)
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

    @spanned("stvd.request")
    def caption(self, features: Union[np.ndarray, Sequence[np.ndarray]],
                regions: Optional[Sequence[np.ndarray]] = None,
                motion: Optional[Sequence[np.ndarray]] = None
                ) -> List[str]:
        """Caption raw per-video feature arrays: (N, F, D) or a list of
        (F_i, D) arrays, with per-video (F_i, R, Dr) region features for
        the spatial model and (F_i, Dm) motion features for the
        dual-stream model (its ``stvd.request`` span holds the packing
        and that of ``caption_batch``)."""
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
