"""AOT-exported decode artifacts: serving without model-building Python
(counterpart of stvd/export_aot.py).

``torch.export`` traces the decode program (the body ``Captioner._run``
runs: greedy when beam_size <= 1, length-normalized beam otherwise) into
an ``ExportedProgram`` per static batch size and platform, which
``torch.export.save`` writes to a self-contained file.  A serving process
loads the files and calls the graphs: no model code of the port runs at
serving time, and the graph is pinned (a change to the model code cannot
silently alter a deployed decoder).  With the kernels (``use_kernel``,
the default for a CUDA-only export) kernels 1-4 are custom ops of the
graph (``stvd_torch::attention_core``, ``::logit_tail``,
``::gates_lstm`` under ``gates_kernel``, ``::spatial_core`` under
spatial attention), so every call of the loaded graph launches them on
the card; the manifest lists the ops its graphs call.

Artifact layout (a directory)::

    decode_b{N}_{platform}.pt2  one saved ExportedProgram per static
                       batch size N and platform (cuda or cpu): bucketed
                       serving (see save_artifact).  A graph carries the
                       device of every tensor it makes, so each platform
                       has its own file.
    nbest_b{N}_{platform}.pt2   optional (``nbest=True``): the full-beam
                       hypothesis graph per size (all tokens and both
                       score variants) for ranked n-best serving
    params.npz         float32 weights, keyed by the JAX names.  Weights
                       are CALL-TIME inputs of the graphs (cast to the
                       compute dtype, and quantized under int8, inside
                       them), so one artifact serves any checkpoint of
                       the same architecture (``load_artifact(params=)``,
                       ``swap_params``); re-export only on config or code
                       changes.
    vocab.pkl          worddict (reference pickle format)
    config.json        the full Config, with decode_batch the largest size
    manifest.json      shapes / platforms / torch version / beam setup /
                       the custom ops the graphs call

``params.npz``, ``vocab.pkl`` and ``config.json`` have the JAX package's
formats.  The graphs are traced under ``FakeTensorMode`` on the target
device: no weights or features are made, so a CUDA-platform artifact can
be exported on a host without a card (the graph's ops are then only
checked, not run).

The exported callable has the contract of ``Captioner._run``:
``(params, batch) -> (tokens, scores)`` at a static batch size, and
``ExportedCaptioner`` drives it through the same chunking helpers as the
live ``Captioner``.  Unlike the live loop, the graph has no early exit:
it runs all ``maxlen`` steps, which gives the same tokens and scores (a
finished caption only extends with EOS, at no cost).  Not ported: graphs
sharded over several devices (``data_parallel``, ``model_parallel``,
``mesh=``) and a bank sharded under an artifact
(``ExportedCaptioner.attach_bank(mesh=...)``) raise
``NotImplementedError`` (ROADMAP.md Queue 1 item 8c).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from . import api as _api
from .config import Config
from .data.text import Vocab
from .model import kernel as _kernel  # noqa: F401 (registers the custom ops)

FORMAT = "stvd-torch-aot-decode-v1"
JAX_FORMAT = "stvd-aot-decode-v1"
PLATFORMS = ("cuda", "cpu")
_PARALLEL = ("graphs sharded over several devices (a data mesh, or a mesh "
             "with a model axis) are not ported yet (ROADMAP.md Queue 1 "
             "item 8c)")


def _decode_run_fn(cfg: Config, step_fn):
    """The (params, batch) -> (tokens, scores) decode program: the body
    of ``Captioner._run`` (greedy when beam_size <= 1, length-normalized
    beam otherwise)."""
    from .decode.beam import beam_decode
    from .decode.greedy import greedy_decode
    d = cfg.decode

    def run(params, batch):
        if d.beam_size <= 1:
            out = greedy_decode(params, cfg.model, batch,
                                maxlen=d.maxlen, step_fn=step_fn)
            return out.tokens, out.scores
        out = beam_decode(params, cfg.model, batch,
                          beam_size=d.beam_size, maxlen=d.maxlen,
                          length_norm=d.length_norm, step_fn=step_fn)
        return out.tokens, out.norm_scores

    return run


def _nbest_run_fn(cfg: Config, step_fn):
    """(params, batch) -> (all_tokens, all_norm_scores, all_scores): the
    beam's full hypothesis set, the quantities ``Captioner.caption_nbest``
    reads (both score variants, so the loader ranks by either)."""
    from .decode.beam import beam_decode
    d = cfg.decode
    if d.beam_size <= 1:
        raise ValueError("n-best export requires decode.beam_size > 1")

    def run(params, batch):
        out = beam_decode(params, cfg.model, batch,
                          beam_size=d.beam_size, maxlen=d.maxlen,
                          length_norm=d.length_norm, step_fn=step_fn)
        return out.all_tokens, out.all_norm_scores, out.all_scores

    return run


class _Program(torch.nn.Module):
    """``run(params, batch)`` as the module ``torch.export`` traces."""

    def __init__(self, run):
        super().__init__()
        self.run = run

    def forward(self, params, batch):
        return self.run(params, batch)


def example_batch(cfg: Config, batch_size: Optional[int] = None, *,
                  device: torch.device | str = "cuda"
                  ) -> Dict[str, torch.Tensor]:
    """A zeros device batch with exactly the shapes and dtypes the
    serving path produces (built through ``pack_bank`` and ``to_device``
    so the two cannot drift); every row has one valid frame, as
    ``padded_chunks`` pads."""
    from .data.bank import pack_bank, to_device
    from .model.step import compute_dtype
    m = cfg.model
    bsz = batch_size or cfg.decode.decode_batch
    ids = [f"v{i}" for i in range(bsz)]
    feats = {v: np.zeros((m.n_frames, m.ctx_dim), np.float32) for v in ids}
    regs = ({v: np.zeros((m.n_frames, m.n_regions, m.region_dim),
                         np.float32) for v in ids}
            if m.use_spatial else None)
    mots = ({v: np.zeros((m.n_frames, m.motion_dim), np.float32)
             for v in ids} if m.use_motion else None)
    bank = pack_bank(feats, m.n_frames, ids=ids, regions=regs, motion=mots)
    batch = dict(to_device(bank, device, compute_dtype(m)))
    batch["frame_mask"] = batch["frame_mask"].clone()
    batch["frame_mask"][:, 0] = 1.0
    return batch


def _input_spec(cfg: Config, batch_size: int) -> Dict[str, tuple]:
    """{stream: (shape, dtype)} of a serving batch of ``batch_size``
    videos, read off a one-video ``example_batch`` on the CPU."""
    one = example_batch(cfg, 1, device="cpu")
    return {k: ((batch_size,) + tuple(v.shape[1:]), v.dtype)
            for k, v in sorted(one.items())}


def _resolve_kernel(platforms, use_kernel: Optional[bool]) -> bool:
    """``use_kernel`` picks the step statically (a graph cannot re-select
    per device): by default the kernels iff the export targets CUDA
    only.  The kernels' custom ops run only on the card."""
    bad = [p for p in platforms if p not in PLATFORMS]
    if not platforms or bad:
        raise ValueError(f"platforms must be a non-empty subset of "
                         f"{PLATFORMS}; got {tuple(platforms)}")
    if use_kernel is None:
        use_kernel = tuple(platforms) == ("cuda",)
    if use_kernel and any(p != "cuda" for p in platforms):
        raise ValueError(
            f"the CUDA kernels only run on cuda; platforms="
            f"{tuple(platforms)} requires use_kernel=False")
    return bool(use_kernel)


def _index(t: torch.Tensor, idx):
    """``t[idx]`` through explicit ops (unsqueeze, select, slice, and
    ``aten.index`` for one tensor index): the view basic indexing
    gives."""
    items = list(idx) if isinstance(idx, tuple) else [idx]
    consumed = sum(1 for i in items if i is not None and i is not Ellipsis)
    if sum(isinstance(i, torch.Tensor) for i in items) > 1:
        raise NotImplementedError("more than one tensor index")
    out, dim = t, 0
    for item in items:
        if item is None:
            out = out.unsqueeze(dim)
            dim += 1
        elif item is Ellipsis:
            dim += t.ndim - consumed
        elif isinstance(item, int):
            out = out.select(dim, item)
        elif isinstance(item, slice):
            if item != slice(None):
                out = torch.ops.aten.slice(out, dim, item.start, item.stop,
                                           1 if item.step is None
                                           else item.step)
            dim += 1
        elif isinstance(item, torch.Tensor):
            out = torch.ops.aten.index(out, [None] * dim + [item])
            dim += item.ndim
        else:
            raise NotImplementedError(f"index {item!r}")
    return out


class _GuardFreeMethods(TorchFunctionMode):
    """The tensor methods whose Python bindings take a CUDA device guard
    (indexing, ``~`` and ``contiguous``) through explicit ops.  A build of
    PyTorch without CUDA cannot take that guard, even for a fake tensor,
    so an export for the card on such a host runs under this mode; it is
    not used where CUDA is."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name == "__getitem__":
            return _index(*args)
        if name == "__setitem__":
            t, idx, value = args
            if any(isinstance(i, torch.Tensor)
                   for i in (idx if isinstance(idx, tuple) else (idx,))):
                raise NotImplementedError("assignment through a tensor index")
            view = _index(t, idx)
            if isinstance(value, torch.Tensor):
                torch.ops.aten.copy_(view, value)
            else:
                torch.ops.aten.fill_(view, value)
            return None
        if name == "__invert__":
            return torch.bitwise_not(args[0])
        if name == "contiguous":
            fmt = kwargs.get("memory_format", torch.contiguous_format)
            t = args[0]
            return (t if t.is_contiguous(memory_format=fmt)
                    else t.clone(memory_format=fmt))
        return func(*args, **kwargs)


def _export(run, params, spec: Dict[str, tuple], platform: str):
    """``run`` traced under ``FakeTensorMode`` on ``platform`` at the
    float32 weights' shapes and the batch ``spec``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dev = torch.device(platform)
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.no_grad())
        if dev.type == "cuda" and not torch.cuda.is_available():
            stack.enter_context(_GuardFreeMethods())
        stack.enter_context(FakeTensorMode())
        fparams = {k: torch.empty(tuple(v.shape), dtype=torch.float32,
                                  device=dev)
                   for k, v in sorted(params.items())}
        fbatch = {k: torch.empty(shape, dtype=dtype, device=dev)
                  for k, (shape, dtype) in spec.items()}
        ep = torch.export.export(_Program(run), (fparams, fbatch),
                                 strict=False)
    # the fake example inputs would be pickled into the file: drop them
    ep._example_inputs = None
    return ep


def custom_ops(ep) -> List[str]:
    """The port's custom ops (``stvd_torch::...``) a graph calls."""
    return sorted({n.target.name() for n in ep.graph.nodes
                   if n.op == "call_function"
                   and isinstance(n.target, torch._ops.OpOverload)
                   and n.target.namespace == "stvd_torch"})


def export_decoder(params, cfg: Config,
                   platforms: Sequence[str] = ("cuda",),
                   batch_size: Optional[int] = None,
                   use_kernel: Optional[bool] = None,
                   _example: Optional[Dict] = None,
                   mesh=None) -> Dict[str, object]:
    """Trace the decode program for the target platform(s): one
    ``torch.export.ExportedProgram`` per platform, ``{platform: program}``
    (a graph is bound to its device).

    ``use_kernel`` picks the step statically: by default the kernel step
    iff the export targets ``cuda`` only; a multi-platform export must
    use the plain step.  ``_example`` (a batch) gives the input shapes
    and dtypes instead of ``example_batch``'s.  ``mesh`` raises
    ``NotImplementedError``: sharded graphs are not ported."""
    from .model.kernel import get_step_fn
    if mesh is not None:
        raise NotImplementedError(_PARALLEL)
    platforms = tuple(platforms)
    use_kernel = _resolve_kernel(platforms, use_kernel)
    run = _decode_run_fn(cfg, get_step_fn(use_kernel))
    spec = ({k: (tuple(v.shape), v.dtype) for k, v in sorted(_example.items())}
            if _example is not None
            else _input_spec(cfg, batch_size or cfg.decode.decode_batch))
    return {p: _export(run, params, spec, p) for p in platforms}


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v, np.float32)


def save_artifact(out_dir: str, params, cfg: Config, vocab: Vocab,
                  platforms: Sequence[str] = ("cuda",),
                  batch_size: Optional[int] = None,
                  use_kernel: Optional[bool] = None,
                  batch_sizes: Optional[Sequence[int]] = None,
                  nbest: bool = False,
                  data_parallel: int = 0,
                  model_parallel: int = 0) -> Dict:
    """Export the decoder and write the full serving artifact directory.

    ``batch_sizes`` (e.g. ``(1, 64, 256)``) exports one graph per static
    batch size: bucketed serving, where the loader sends bulk chunks to
    the largest size and the remainder to the smallest size that fits, so
    a 1-video request runs the b=1 graph, not a padded 256-row batch.
    Default: one size (``batch_size`` or the config's decode_batch).

    ``nbest=True`` also exports an n-best graph per size (every beam
    hypothesis and both score variants); it needs beam_size > 1.

    ``data_parallel`` above 0 or ``model_parallel`` above 1 raise
    ``NotImplementedError`` (sharded serving graphs are not ported).

    Returns the manifest dict; its ``export_seconds`` gives each graph's
    trace-and-save time."""
    if int(data_parallel or 0) > 0 or int(model_parallel or 0) > 1:
        raise NotImplementedError(_PARALLEL)
    from .model.kernel import get_step_fn
    platforms = tuple(platforms)
    use_kernel = _resolve_kernel(platforms, use_kernel)
    if batch_sizes is None:
        batch_sizes = (batch_size or cfg.decode.decode_batch,)
    sizes = sorted(set(int(b) for b in batch_sizes))
    if not sizes or sizes[0] < 1:
        raise ValueError(f"batch_sizes must be positive ints: {batch_sizes}")
    step_fn = get_step_fn(use_kernel)
    programs = [("decode", _decode_run_fn(cfg, step_fn))]
    if nbest:
        programs.append(("nbest", _nbest_run_fn(cfg, step_fn)))
    os.makedirs(out_dir, exist_ok=True)
    inputs, ops, seconds = {}, set(), {}
    for b in sizes:
        spec = _input_spec(cfg, b)
        for p in platforms:
            for name, run in programs:
                t0 = time.perf_counter()
                ep = _export(run, params, spec, p)
                ops.update(custom_ops(ep))
                fname = f"{name}_b{b}_{p}"
                torch.export.save(ep, os.path.join(out_dir, fname + ".pt2"))
                seconds[fname] = time.perf_counter() - t0
        inputs[str(b)] = {k: [list(shape), str(dtype).replace("torch.", "")]
                          for k, (shape, dtype) in spec.items()}
    np.savez(os.path.join(out_dir, "params.npz"),
             **{k: _to_numpy(v) for k, v in params.items()})
    vocab.save_pickle(os.path.join(out_dir, "vocab.pkl"))
    cfg = dataclasses.replace(
        cfg, decode=dataclasses.replace(cfg.decode, decode_batch=sizes[-1]))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    manifest = {
        "format": FORMAT,
        "platforms": list(platforms),
        "torch_version": torch.__version__,
        "batch_sizes": sizes,
        "decode_batch": sizes[-1],
        "beam_size": cfg.decode.beam_size,
        "maxlen": cfg.decode.maxlen,
        "use_kernel": use_kernel,
        "nbest": bool(nbest),
        "data_parallel": 0,
        "model_parallel": 0,
        "param_count": int(sum(int(np.prod(tuple(v.shape)))
                               for v in params.values())),
        "inputs": inputs,
        "custom_ops": sorted(ops),
        "export_seconds": seconds,
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ExportedCaptioner(_api.BankResident):
    """Serve captions from an AOT artifact (see the module docstring).

    ``caption_batch`` / ``caption`` have the semantics of the live
    ``Captioner`` (same chunking helpers), ``caption_nbest`` / ``nbest``
    need an artifact saved with ``nbest=True``, and ``caption_ids`` /
    ``nbest_ids`` serve a bank made resident by ``attach_bank``.
    Stochastic sampling needs the live step: use ``Captioner``.  The
    graphs are called under ``torch.inference_mode``."""

    def __init__(self, exported: Dict[int, object], params, cfg: Config,
                 vocab: Vocab, manifest: Optional[Dict] = None,
                 nbest_exported: Optional[Dict[int, object]] = None,
                 mesh=None, *, device: torch.device | str = "cuda"):
        if mesh is not None:
            raise NotImplementedError(_PARALLEL)
        self.device = torch.device(device)
        self._exported = dict(exported)   # {batch_size: ExportedProgram}
        self._nbest = dict(nbest_exported or {})
        self._call_cache: Dict[int, object] = {}
        self.cfg = cfg
        self.vocab = vocab
        self.manifest = manifest or {}
        self.params = self._on_device(params)

    def attach_bank(self, bank, dtype: Optional[torch.dtype] = None,
                    mesh=None) -> int:
        """``BankResident.attach_bank`` on one device: a bank sharded
        under an artifact comes with sharded artifacts (item 8c)."""
        if mesh is not None:
            raise NotImplementedError(_PARALLEL)
        return super().attach_bank(bank, dtype)

    def _on_device(self, params) -> Dict[str, torch.Tensor]:
        """float32 weights on the device, in key order: the graphs take
        them as traced."""
        return {k: (params[k] if isinstance(params[k], torch.Tensor)
                    else torch.from_numpy(np.array(params[k], np.float32))
                    ).to(self.device, torch.float32)
                for k in sorted(params)}

    def swap_params(self, params) -> None:
        """Swap in weights of the same architecture without re-export:
        the key set and every shape must match; the new weights are cast
        to the graphs' float32.  The graphs and a resident bank are
        untouched."""
        params = dict(params)
        _api._check_swap_compatible(self.params, params)
        self.params = self._on_device(params)

    def _call_fn(self, exported):
        """The loaded graph as ``run(params, batch)``, memoized per
        graph: the batch is cut to the streams the graph takes, and the
        call runs under ``inference_mode``."""
        key = id(exported)
        run = self._call_cache.get(key)
        if run is None:
            module = exported.module()
            m = self.cfg.model
            keys = sorted(["frames", "frame_mask"]
                          + ["regions"] * m.use_spatial
                          + ["motion"] * m.use_motion)

            def run(params, batch, _module=module, _keys=keys):
                with torch.inference_mode():
                    return _module(params, {k: batch[k] for k in _keys})

            self._call_cache[key] = run
        return run

    def _buckets(self, n: int):
        """(graph size, first row, end row) of the bucketed routing: bulk
        chunks ride the largest size, the remainder the smallest size
        that fits."""
        sizes = sorted(self._exported)
        bmax = sizes[-1]
        nbulk = (n // bmax) * bmax
        if nbulk:
            yield bmax, 0, nbulk
        if n - nbulk:
            yield next(b for b in sizes if b >= n - nbulk), nbulk, n

    def caption_batch(self, batch: Dict[str, torch.Tensor]) -> List[str]:
        """Captions of a prepared device batch, routed over the exported
        sizes (a 1-video request on a (1, 64, 256) artifact runs the b=1
        graph)."""
        out: List[str] = []
        for b, s, e in self._buckets(int(batch["frames"].shape[0])):
            out += _api.chunked_caption(
                self._call_fn(self._exported[b]), self.params,
                {k: v[s:e] for k, v in batch.items()}, b, self.vocab)
        return out

    def _caption_rows(self, rows: np.ndarray) -> List[str]:
        """The id analogue of ``caption_batch``: resident-bank rows
        gathered on the device, routed over the exported sizes."""
        bank = self._resident()
        out: List[str] = []
        for b, s, e in self._buckets(int(rows.shape[0])):
            call = self._call_fn(self._exported[b])

            def run_ids(params, bank, idx, _call=call):
                return _call(params, {k: v.index_select(0, idx)
                                      for k, v in bank.items()})

            out += _api.chunked_caption_ids(run_ids, self.params, bank,
                                            rows[s:e], b, self.vocab)
        return out

    def caption(self, features: Union[np.ndarray, Sequence[np.ndarray]],
                regions: Optional[Sequence[np.ndarray]] = None,
                motion: Optional[Sequence[np.ndarray]] = None
                ) -> List[str]:
        # Captioner.caption reads only cfg.model, device and
        # caption_batch, which this class has: the packing is shared
        return _api.Captioner.caption(self, features, regions, motion)

    def caption_nbest(self, batch: Dict[str, torch.Tensor],
                      n: Optional[int] = None, norm: bool = True
                      ) -> List[List[tuple]]:
        """Every beam hypothesis per video from the n-best graphs,
        ``[(text, logprob), ...]`` best first, as
        ``Captioner.caption_nbest`` gives them; a request is decoded in
        ``padded_chunks`` of the largest n-best size."""
        if not self._nbest:
            raise ValueError(
                "artifact has no n-best graphs; re-export with "
                "save_artifact(..., nbest=True) / cli.export --nbest")
        bsz = sorted(self._nbest)[-1]
        call = self._call_fn(self._nbest[bsz])
        res: List[List[tuple]] = []
        for count, chunk in _api.padded_chunks(batch, bsz):
            all_toks, norm_scores, raw_scores = call(self.params, chunk)
            toks = all_toks[:count].cpu().numpy()
            scores = (norm_scores if norm
                      else raw_scores)[:count].cpu().numpy()
            k = n or toks.shape[1]
            for b in range(count):
                order = np.argsort(-scores[b])[:k]
                res.append([(" ".join(self.vocab.decode(toks[b, j])),
                             float(scores[b, j])) for j in order])
        return res

    def nbest(self, features: Union[np.ndarray, Sequence[np.ndarray]],
              regions: Optional[Sequence[np.ndarray]] = None,
              motion: Optional[Sequence[np.ndarray]] = None,
              n: Optional[int] = None, norm: bool = True
              ) -> List[List[tuple]]:
        """``caption_nbest`` of raw feature arrays (packed as ``caption``
        packs them)."""
        return self.caption_nbest(
            _api.pack_request(self.cfg.model, features, regions, motion,
                              device=self.device), n=n, norm=norm)


def load_artifact(path: str, params=None, *,
                  device: torch.device | str = "cuda"
                  ) -> ExportedCaptioner:
    """Load a saved artifact's graphs for ``device`` (its type must be
    one of the exported platforms; ``cuda`` without a card raises).
    ``params`` (a flat dict of arrays) overrides the shipped weights: a
    checkpoint of the same architecture needs no re-export."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    fmt = manifest.get("format")
    if fmt == JAX_FORMAT:
        raise ValueError(
            f"{path}: a JAX package artifact ({JAX_FORMAT}); the port "
            f"loads {FORMAT} (export with python -m stvd_torch.cli.export)")
    if fmt != FORMAT:
        raise ValueError(f"{path}: unknown artifact format {fmt!r} "
                         f"(expected {FORMAT})")
    dev = torch.device(device)
    if dev.type not in manifest["platforms"]:
        raise ValueError(
            f"{path}: artifact was exported for {manifest['platforms']} "
            f"but the device is {dev.type!r}; re-export with --platforms "
            f"{dev.type} (or include it in the list)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_artifact: no CUDA device; load a cpu "
                           "artifact with device='cpu'")
    if (int(manifest.get("data_parallel") or 0) > 0
            or int(manifest.get("model_parallel") or 0) > 1):
        raise NotImplementedError(_PARALLEL)
    def graph(name: str, b: int):
        return torch.export.load(
            os.path.join(path, f"{name}_b{b}_{dev.type}.pt2"))

    exported = {int(b): graph("decode", b) for b in manifest["batch_sizes"]}
    nbest = ({int(b): graph("nbest", b) for b in manifest["batch_sizes"]}
             if manifest.get("nbest") else {})
    with open(os.path.join(path, "config.json")) as f:
        cfg = Config.from_json(f.read())
    if params is None:
        with np.load(os.path.join(path, "params.npz")) as z:
            params = {k: z[k] for k in z.files}
    vocab = Vocab.load_pickle(os.path.join(path, "vocab.pkl"))
    return ExportedCaptioner(exported, params, cfg, vocab, manifest,
                             nbest_exported=nbest, device=dev)
