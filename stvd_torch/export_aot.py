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
finished caption only extends with EOS, at no cost).

Sharded artifacts (``save_artifact(data_parallel=N, model_parallel=M)``,
the JAX package's arguments and manifest keys) serve over a mesh of
ranks, SPMD: every rank of the world runs the export and the loader, and
makes each call with the same arguments (``train.parallel``).

* Data-parallel (``data_parallel=N``, a 1-D ``('data',)`` mesh of exactly
  N ranks): each graph is a per-rank graph at ``b / N`` rows with no
  collective inside; the loader gives each rank its slice of a chunk (or
  the rows a sharded bank scatters to it), runs the graph and gathers
  tokens and scores over the data axis, the JAX contract in which the
  batch and the outputs lie on ``data``.  The weights are whole on every
  rank.
* Tensor-parallel (``model_parallel=M``, a 2-D ``('data', 'model')``
  mesh of N x M ranks, N default 1): the graph of model rank m takes
  that rank's ``TP_RULES`` share of every weight and holds the model
  axis' collectives in their traceable spelling (``model.tp``), one
  file a model rank (``decode_b{N}_{platform}_m{m}.pt2``).  A
  cuda-only export runs the live TP decode's step (``make_tp_step``:
  kernel 1 whole on the replicated activations, kernel 2 per vocab
  shard, then the exact merge); the JAX package refuses kernels under a
  model axis, where a ``pallas_call`` does not auto-partition.
  ``torch.export`` records each collective's process group by name, and
  names count up in creation order, so the loader points every
  collective of a graph at its own model group (``bind_groups``).

The export runs on the ranks themselves (``torchrun --nproc-per-node
N*M -m stvd_torch.cli.export ...``): the data rows share the tracing
(every row's graphs are the same), rank 0 writes the shared files.
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
from .model import tp
from .train import parallel

FORMAT = "stvd-torch-aot-decode-v1"
JAX_FORMAT = "stvd-aot-decode-v1"
PLATFORMS = ("cuda", "cpu")


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
    (indexing, ``~``, ``contiguous``, ``copy_`` and ``zero_``) through
    explicit ops.  A build of
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
        if name in ("copy_", "zero_"):      # the padded layouts' fills
            return getattr(torch.ops.aten, name)(*args, **kwargs)
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


def _step(cfg: Config, use_kernel: bool, mesh):
    """The step of the exported program: the kernel or the plain step,
    under a model axis ``make_tp_step``'s (kernel 2 per vocab shard with
    the kernels, the gathered logits without)."""
    from .decode.parallel import make_tp_step
    from .model.kernel import get_step_fn
    step_fn = get_step_fn(use_kernel)
    if parallel.model_axis_size(mesh) <= 1:
        return step_fn
    tp.check_options(cfg.model, mesh)
    step = make_tp_step(mesh, step_fn)
    if not use_kernel:
        step.make_logit_tail = None
    return step


def _on_axis(run, axis: Optional[tp.Axis]):
    """``run`` under the model axis ``axis`` (None: as it is), its
    collectives in the spelling an exported graph holds."""
    if axis is None:
        return run

    def sharded(params, batch):
        with tp.using(axis), tp.functional_collectives():
            return run(params, batch)

    return sharded


def _model_axis(cfg: Config, mesh) -> Optional[tp.Axis]:
    """This rank's model axis on ``mesh`` (None without one)."""
    if parallel.model_axis_size(mesh) <= 1:
        return None
    return tp.Axis(parallel.model_group(mesh), parallel.model_axis_size(mesh),
                   parallel.model_rank(mesh), cfg.model.n_words)


def _rank_params(params, mesh) -> Dict[str, torch.Tensor]:
    """Meta tensors of the shapes of this rank's share of ``params``."""
    out = {}
    for k, v in params.items():
        shape = list(v.shape)
        ax = parallel.tp_spec_for(k, shape, mesh)
        if ax is not None:
            shape[ax] //= parallel.model_axis_size(mesh)
        out[k] = torch.empty(shape, device="meta")
    return out


def _rank_rows(b: int, mesh) -> int:
    """The rows of a rank's graph of global batch size ``b``: ``b`` over
    the data axis, which must divide it (the JAX package's error)."""
    dp = parallel.axis_size(mesh)
    if b % dp:
        raise ValueError(f"data_parallel={dp} requires divisible batch "
                         f"sizes; got {[b]}")
    return b // dp


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
    and dtypes instead of ``example_batch``'s.  ``mesh`` (a 1-D
    ``('data',)`` or 2-D ``('data', 'model')`` mesh, which this rank
    calls with the others) traces this rank's graph: its slice of the
    batch (``batch_size`` divides the data axis), and under a model axis
    its share of the weights with the collectives inside."""
    platforms = tuple(platforms)
    use_kernel = _resolve_kernel(platforms, use_kernel)
    b = int(_example["frames"].shape[0] if _example is not None
            else batch_size or cfg.decode.decode_batch)
    if mesh is not None:
        parallel.check_data_mesh(mesh)
        b = _rank_rows(b, mesh)
        params = _rank_params(params, mesh)
    run = _on_axis(_decode_run_fn(cfg, _step(cfg, use_kernel, mesh)),
                   _model_axis(cfg, mesh))
    spec = ({k: ((b,) + tuple(v.shape[1:]), v.dtype)
             for k, v in sorted(_example.items())}
            if _example is not None else _input_spec(cfg, b))
    return {p: _export(run, params, spec, p) for p in platforms}


def bind_groups(module, traced: Sequence[str], name: str):
    """Point every collective of a loaded graph at the process group
    ``name`` (this rank's model group), in place: each
    ``_c10d_functional`` call records the group it was traced with by
    name, and names count up in creation order, so a graph traced on one
    data row names a group the ranks of another are not in.  A
    collective whose group ``traced`` (the artifact's record) does not
    list, or a ``name`` that does not resolve to a group of this rank,
    raises ``ValueError``: a rank never calls a group it is not in."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    try:
        group = _resolve_process_group(name)
    except (RuntimeError, ValueError, KeyError) as e:
        raise ValueError(f"process group {name!r} does not resolve on rank "
                         f"{torch.distributed.get_rank()}: {e}") from None
    if torch.distributed.get_rank(group) < 0:
        raise ValueError(f"rank {torch.distributed.get_rank()} is not in "
                         f"process group {name!r}")
    for node in module.graph.nodes:
        target = node.target
        if (node.op != "call_function"
                or not isinstance(target, torch._ops.OpOverload)
                or target.namespace != "_c10d_functional"):
            continue
        names = [a.name for a in target._schema.arguments]
        if "group_name" not in names:
            continue
        i = names.index("group_name")
        args = list(node.args)
        old = args[i] if i < len(args) else node.kwargs["group_name"]
        if old not in traced:
            raise ValueError(
                f"collective {node.name} of the graph names process group "
                f"{old!r}, which the artifact does not record "
                f"({list(traced)})")
        if i < len(args):
            args[i] = name
            node.args = tuple(args)
        else:
            node.kwargs = dict(node.kwargs, group_name=name)
    module.recompile()
    return module


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v, np.float32)


def _serving_mesh(dp: int, mp: int, device):
    """The artifact's mesh: None for one device, else the 1-D data mesh
    of ``dp`` ranks or the 2-D mesh of ``dp`` x ``mp`` (``mp`` above 1),
    over exactly that many ranks of the process group."""
    kind = torch.device(device).type
    if mp > 1:
        return parallel.serving_mesh_2d(dp or 1, mp, kind)
    if dp:
        return parallel.serving_mesh(dp, kind)
    return None


def _all_ranks(payload, mesh) -> List:
    """Every rank's ``payload`` (picklable), in rank order; a lone
    process's own."""
    if mesh is None:
        return [payload]
    out = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(out, payload)
    return out


def _raise_any(errors: Sequence[Optional[str]]) -> None:
    bad = [(r, e) for r, e in enumerate(errors) if e]
    if bad:
        raise RuntimeError("; ".join(f"rank {r}: {e}" for r, e in bad))


def save_artifact(out_dir: str, params, cfg: Config, vocab: Vocab,
                  platforms: Sequence[str] = ("cuda",),
                  batch_size: Optional[int] = None,
                  use_kernel: Optional[bool] = None,
                  batch_sizes: Optional[Sequence[int]] = None,
                  nbest: bool = False,
                  data_parallel: int = 0,
                  model_parallel: int = 0, *,
                  device: torch.device | str = "cuda") -> Dict:
    """Export the decoder and write the full serving artifact directory.

    ``batch_sizes`` (e.g. ``(1, 64, 256)``) exports one graph per static
    batch size: bucketed serving, where the loader sends bulk chunks to
    the largest size and the remainder to the smallest size that fits, so
    a 1-video request runs the b=1 graph, not a padded 256-row batch.
    Default: one size (``batch_size`` or the config's decode_batch).

    ``nbest=True`` also exports an n-best graph per size (every beam
    hypothesis and both score variants); it needs beam_size > 1.

    ``data_parallel=N`` exports every graph for a 1-D data mesh of N
    ranks, and ``model_parallel=M`` (``data_parallel`` then defaulting
    to 1) for a 2-D mesh of N x M ranks with the weights sharded by
    ``TP_RULES`` (see the module docstring).  Every batch size must
    divide by N, and the process group must hold exactly N (x M) ranks,
    each of which calls this with the same arguments; ``device`` is the
    device type of the ranks (the mesh's, not the platform's).

    Returns the manifest dict; its ``export_seconds`` gives each graph's
    trace-and-save time."""
    platforms = tuple(platforms)
    use_kernel = _resolve_kernel(platforms, use_kernel)
    if batch_sizes is None:
        batch_sizes = (batch_size or cfg.decode.decode_batch,)
    sizes = sorted(set(int(b) for b in batch_sizes))
    if not sizes or sizes[0] < 1:
        raise ValueError(f"batch_sizes must be positive ints: {batch_sizes}")
    mp = int(model_parallel or 0)
    dp = int(data_parallel or 0) or (1 if mp > 1 else 0)
    bad = [b for b in sizes if dp and b % dp]
    if bad:
        raise ValueError(f"data_parallel={dp} requires divisible batch "
                         f"sizes; got {bad}")
    mesh = _serving_mesh(dp, mp, device)
    step_fn = _step(cfg, use_kernel, mesh)
    axis = _model_axis(cfg, mesh)
    programs = [("decode", _on_axis(_decode_run_fn(cfg, step_fn), axis))]
    if nbest:
        programs.append(("nbest", _on_axis(_nbest_run_fn(cfg, step_fn),
                                           axis)))
    suffix = f"_m{axis.rank}" if axis is not None else ""
    rank_params = _rank_params(params, mesh) if mesh is not None else params
    # every data row's graphs are the same (a model rank's under a model
    # axis), so the rows share the tracing: row d takes every n-th graph
    jobs = [(b, p, name, run) for b in sizes for p in platforms
            for name, run in programs]
    jobs = jobs[parallel.axis_rank(mesh)::parallel.axis_size(mesh)]
    ops, seconds, error = set(), {}, None
    try:
        os.makedirs(out_dir, exist_ok=True)
        for b, p, name, run in jobs:
            t0 = time.perf_counter()
            ep = _export(run, rank_params, _input_spec(cfg, b // (dp or 1)),
                         p)
            ops.update(custom_ops(ep))
            fname = f"{name}_b{b}_{p}{suffix}"
            torch.export.save(ep, os.path.join(out_dir, fname + ".pt2"))
            seconds[fname] = time.perf_counter() - t0
    except Exception as e:     # every rank raises below
        if mesh is None:
            raise
        error = f"{type(e).__name__}: {e}"
    # the name of the model group each tracing rank's collectives carry
    group = axis.group.group_name if axis is not None and jobs else None
    traced = _all_ranks((error, seconds, sorted(ops), group), mesh)
    _raise_any([t[0] for t in traced])
    for _, secs, names, _ in traced:
        seconds.update(secs)
        ops.update(names)
    cfg = dataclasses.replace(
        cfg, decode=dataclasses.replace(cfg.decode, decode_batch=sizes[-1]))
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
        "data_parallel": dp,
        "model_parallel": mp,
        "param_count": int(sum(int(np.prod(tuple(v.shape)))
                               for v in params.values())),
        "inputs": {str(b): {k: [list(shape), str(dtype).replace("torch.", "")]
                            for k, (shape, dtype)
                            in _input_spec(cfg, b).items()} for b in sizes},
        "custom_ops": sorted(ops),
        "export_seconds": dict(sorted(seconds.items())),
    }
    if axis is not None:
        manifest["group_names"] = sorted({t[3] for t in traced if t[3]})
    error = None
    if parallel.is_first_rank(mesh):
        try:
            np.savez(os.path.join(out_dir, "params.npz"),
                     **{k: _to_numpy(v) for k, v in params.items()})
            vocab.save_pickle(os.path.join(out_dir, "vocab.pkl"))
            with open(os.path.join(out_dir, "config.json"), "w") as f:
                f.write(cfg.to_json())
            with open(os.path.join(out_dir, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
        except Exception as e:
            if mesh is None:
                raise
            error = f"{type(e).__name__}: {e}"
    _raise_any(_all_ranks(error, mesh))
    return manifest


def _place_params(params, mesh, device: torch.device
                  ) -> Dict[str, torch.Tensor]:
    """float32 weights on ``device`` in key order, as the graphs take
    them: on a mesh rank 0's values on every rank (``replicate``), and
    under a model axis this rank's ``TP_RULES`` share of them."""
    out = {k: (params[k] if isinstance(params[k], torch.Tensor)
               else torch.from_numpy(np.array(params[k], np.float32))
               ).to(device, torch.float32)
           for k in sorted(params)}
    if mesh is None:
        return out
    out = parallel.replicate(out, mesh)
    return (parallel.shard_state(out, mesh)
            if parallel.has_model_axis(mesh) else out)


class ExportedCaptioner(_api.BankResident):
    """Serve captions from an AOT artifact (see the module docstring).

    ``caption_batch`` / ``caption`` have the semantics of the live
    ``Captioner`` (same chunking helpers), ``caption_nbest`` / ``nbest``
    need an artifact saved with ``nbest=True``, and ``caption_ids`` /
    ``nbest_ids`` serve a bank made resident by ``attach_bank``.
    Stochastic sampling needs the live step: use ``Captioner``.  The
    graphs are called under ``torch.inference_mode``.  On a ``mesh``
    (``load_artifact`` rebuilds the artifact's) every rank makes each
    call with the same arguments and gets every caption."""

    def __init__(self, exported: Dict[int, object], params, cfg: Config,
                 vocab: Vocab, manifest: Optional[Dict] = None,
                 nbest_exported: Optional[Dict[int, object]] = None,
                 mesh=None, *, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self._exported = dict(exported)   # {batch_size: ExportedProgram}
        self._nbest = dict(nbest_exported or {})
        self._graphs: Dict[int, object] = {}
        self._mesh = mesh
        self.cfg = cfg
        self.vocab = vocab
        self.manifest = manifest or {}
        self._shapes = {k: torch.empty(tuple(v.shape), device="meta")
                        for k, v in params.items()}
        self.params = _place_params(params, mesh, self.device)

    def attach_bank(self, bank, dtype: Optional[torch.dtype] = None,
                    mesh=None) -> int:
        """``BankResident.attach_bank``; a sharded artifact shards a bank
        only on a mesh of its own layout (the JAX package's bank rides the
        artifact's serving mesh)."""
        if mesh is not None and self._mesh is not None and (
                tuple(mesh.mesh_dim_names)
                != tuple(self._mesh.mesh_dim_names)
                or tuple(mesh.shape) != tuple(self._mesh.shape)):
            raise ValueError(
                f"a bank sharded over a {tuple(mesh.shape)} "
                f"{tuple(mesh.mesh_dim_names)} mesh cannot ride the "
                f"artifact's {tuple(self._mesh.shape)} "
                f"{tuple(self._mesh.mesh_dim_names)} serving mesh")
        return super().attach_bank(bank, dtype, mesh)

    def swap_params(self, params) -> None:
        """Swap in weights of the same architecture without re-export:
        the key set and every (full) shape must match; the new weights
        are cast to the graphs' float32 and placed as at load.  The
        graphs and a resident bank are untouched."""
        params = dict(params)
        _api._check_swap_compatible(self._shapes, params)
        self.params = _place_params(params, self._mesh, self.device)

    def _graph(self, exported):
        """The loaded graph as ``run(params, batch)`` on this rank's rows,
        memoized per graph: the batch is cut to the streams the graph
        takes, the call runs under ``inference_mode``, and a graph of the
        model axis calls this rank's model group."""
        key = id(exported)
        run = self._graphs.get(key)
        if run is None:
            module = exported.module()
            if parallel.has_model_axis(self._mesh):
                bind_groups(module, self.manifest.get("group_names", []),
                            parallel.model_group(self._mesh).group_name)
            m = self.cfg.model
            keys = sorted(["frames", "frame_mask"]
                          + ["regions"] * m.use_spatial
                          + ["motion"] * m.use_motion)

            def run(params, batch, _module=module, _keys=keys):
                with torch.inference_mode():
                    return _module(params, {k: batch[k] for k in _keys})

            self._graphs[key] = run
        return run

    def _gathered(self, out) -> tuple:
        return tuple(parallel.all_gather_rows(t, self._mesh) for t in out)

    def _call_fn(self, exported):
        """``run(params, batch)`` over a whole chunk: on a mesh each rank
        runs the graph on its data slice and the outputs are gathered
        over the data axis."""
        local = self._graph(exported)
        if self._mesh is None:
            return local

        def run(params, batch):
            rows = parallel.local_slice(int(batch["frames"].shape[0]),
                                        self._mesh)
            return self._gathered(local(params, {k: v[rows]
                                                 for k, v in batch.items()}))

        return run

    def _ids_call_fn(self, exported):
        """``run_ids(params, bank, rows)``: a chunk of resident-bank rows
        decoded.  A bank sharded on the artifact's mesh scatters each rank
        its slice of the chunk (the chunk divides the data axis); one
        sharded under a one-device artifact gathers the whole chunk on
        every rank (``api._bank_local_gather``)."""
        bmesh = self._bank_mesh
        if bmesh is None:
            call = self._call_fn(exported)
            return lambda params, bank, idx: call(
                params, {k: v.index_select(0, idx) for k, v in bank.items()})
        local = self._graph(exported)
        if self._mesh is None:
            return lambda params, bank, idx: local(
                params, _api._bank_local_gather(bank, idx, bmesh, False))
        return lambda params, bank, idx: self._gathered(local(
            params, _api._bank_local_gather(bank, idx, bmesh, True)))

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
            out += _api.chunked_caption_ids(
                self._ids_call_fn(self._exported[b]), self.params, bank,
                rows[s:e], b, self.vocab)
        return out

    def caption(self, features: Union[np.ndarray, Sequence[np.ndarray]],
                regions: Optional[Sequence[np.ndarray]] = None,
                motion: Optional[Sequence[np.ndarray]] = None
                ) -> List[str]:
        # Captioner.caption reads only cfg.model, device and
        # caption_batch, which this class has: the packing is shared
        return _api.Captioner.caption(self, features, regions, motion)

    def _nbest_size(self) -> int:
        if not self._nbest:
            raise ValueError(
                "artifact has no n-best graphs; re-export with "
                "save_artifact(..., nbest=True) / cli.export --nbest")
        return sorted(self._nbest)[-1]

    def _nbest_lists(self, out, count: int, n: Optional[int], norm: bool
                     ) -> List[List[tuple]]:
        all_toks, norm_scores, raw_scores = out
        return _api.Captioner._nbest_lists(
            self, all_toks[:count], (norm_scores if norm
                                     else raw_scores)[:count], n)

    def caption_nbest(self, batch: Dict[str, torch.Tensor],
                      n: Optional[int] = None, norm: bool = True
                      ) -> List[List[tuple]]:
        """Every beam hypothesis per video from the n-best graphs,
        ``[(text, logprob), ...]`` best first, as
        ``Captioner.caption_nbest`` gives them; a request is decoded in
        ``padded_chunks`` of the largest n-best size."""
        bsz = self._nbest_size()
        call = self._call_fn(self._nbest[bsz])
        res: List[List[tuple]] = []
        for count, chunk in _api.padded_chunks(batch, bsz):
            res += self._nbest_lists(call(self.params, chunk), count, n, norm)
        return res

    def _nbest_rows(self, rows: np.ndarray, n: Optional[int] = None,
                    norm: bool = True) -> List[List[tuple]]:
        """``nbest_ids`` over a sharded bank, in chunks of bank rows of
        the largest n-best size (short chunks repeat row 0)."""
        bsz = self._nbest_size()
        run = self._ids_call_fn(self._nbest[bsz])
        bank = self._resident()
        res: List[List[tuple]] = []
        for s in range(0, int(rows.shape[0]), bsz):
            part = rows[s:s + bsz]
            chunk = np.zeros(bsz, np.int64)
            chunk[:len(part)] = part
            res += self._nbest_lists(
                run(self.params, bank, torch.from_numpy(chunk).to(
                    self.device)), len(part), n, norm)
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
    checkpoint of the same architecture needs no re-export.  A sharded
    artifact rebuilds its mesh over exactly its N (x M) ranks (another
    world raises ``ValueError``); every rank calls this, and under a
    model axis loads its model rank's graphs."""
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
    mp = int(manifest.get("model_parallel") or 0)
    mesh = _serving_mesh(int(manifest.get("data_parallel") or 0), mp, dev)
    suffix = f"_m{parallel.model_rank(mesh)}" if mp > 1 else ""

    def graph(name: str, b: int):
        return torch.export.load(
            os.path.join(path, f"{name}_b{b}_{dev.type}{suffix}.pt2"))

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
                             nbest_exported=nbest, mesh=mesh, device=dev)
