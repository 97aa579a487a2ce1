"""Data and tensor parallelism over a device mesh (the port's copy of
stvd/train/parallel.py): the 1-D ``('data',)`` mesh, and the 2-D
``('data', 'model')`` mesh whose model axis shards the big weights by
``TP_RULES``.

The JAX package is single-controller: one process holds a ``Mesh``, the
weights are placed by ``TP_RULES`` and XLA inserts the gradient ``psum``
and one ``psum`` a sharded product.  The port is SPMD: one process per
device (launched by ``torchrun``, or by ``spawn`` below for ranks on one
host), a ``torch.distributed`` ``DeviceMesh`` whose dimensions are the
mesh's axes, and explicit collectives: each rank holds its slice of
every sharded weight (``shard_state``), and the products that read one
are written row-parallel or vocab-parallel in ``model.tp``.  Every
function here, and every function of the port that takes a ``mesh``, is
called by every rank of the mesh with the same arguments (apart from the
rank's own data), in the same order: a collective waits for all ranks.

The collectives are the ones NCCL takes and gloo takes for CUDA tensors
(``all_reduce``, ``broadcast`` and ``broadcast_object_list``, which is
built on it, ``all_gather``, ``reduce_scatter_tensor``), so one code
path serves NCCL across cards and gloo on one card or on the CPU.  The
backend is chosen explicitly (``make_mesh(backend=...)``); without a
choice it is NCCL on CUDA and gloo on the CPU.
"""

from __future__ import annotations

import datetime
import gc
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# parameter name -> the axis its model-axis slices cut (0: rows, the
# input features of a row-sharded product; 1: the vocab columns of
# ff_logit_W); a parameter not listed is replicated.  The JAX package's
# TP_RULES with each PartitionSpec written as its sharded axis.
TP_RULES: Dict[str, int] = {
    # gates products: row-sharded on their input axis
    "U": 0,                # (d, 4d) recurrent
    "W": 0,                # (dw, 4d) input projection
    "Wc": 0,               # (ctx, 4d) context projection
    # logit stack: row-sharded projections, vocab-column output
    "ff_logit_lstm_W": 0,  # (d, dw)
    "ff_logit_ctx_W": 0,   # (ctx, dw)
    "ff_logit_W": 1,       # (dw, V)
    "ff_logit_b": 0,       # (V,)
    # attention, selector and init projections
    "Wc_att": 0,           # (ctx, attn)
    "Wd_att": 0,           # (d, attn)
    "ff_state_W": 0,       # (ctx, d)
    "ff_memory_W": 0,      # (ctx, d)
    # spatial stream (presets 2 and 4)
    "Ws_att": 0,           # (Dr, s)
    "Wsd_att": 0,          # (d, s)
    "W_spat_fuse": 0,      # (Dr, ctx)
    # motion fusion and the frame-LSTM encoder
    "W_app": 0,
    "W_mot": 0,
    "enc_W": 0,
    "enc_U": 0,
}


def default_backend(device_type: str) -> str:
    """torch's own choice: NCCL for CUDA tensors, gloo for the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def _init_group(devices, backend: Optional[str]) -> str:
    """The device type of the ranks; joins the process group from
    ``torchrun``'s environment if there is none yet."""
    kind = torch.device(devices if devices is not None else "cuda").type
    if not dist.is_initialized():
        if kind == "cuda" and "LOCAL_RANK" in os.environ:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group(backend or default_backend(kind),
                                init_method="env://")
    elif backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not the requested {backend!r}")
    return kind


def rank_device(devices: Optional[str | torch.device] = None,
                backend: Optional[str] = None) -> torch.device:
    """This rank's device, after joining the process group as
    ``make_mesh`` does (from ``torchrun``'s environment when there is
    none yet, on ``cuda:LOCAL_RANK``): its current CUDA device, or the
    CPU."""
    kind = _init_group(devices, backend)
    if kind == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(kind)


def make_mesh(devices: Optional[str | torch.device] = None,
              backend: Optional[str] = None):
    """The 1-D data mesh over every rank of the process group, as a
    ``DeviceMesh`` with the one dimension ``'data'``.

    ``devices`` is the device type of the ranks: ``'cuda'`` (the default;
    each rank on its current CUDA device, ``cuda:LOCAL_RANK`` under
    ``torchrun``) or ``'cpu'``; a ``torch.device`` gives its type.  When
    no process group exists yet it is made from the environment that
    ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) with ``backend`` (default ``default_backend``); an
    existing group must have ``backend`` when one is given."""
    kind = _init_group(devices, backend)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(kind, (dist.get_world_size(),),
                            mesh_dim_names=(DATA_AXIS,))


def make_mesh_2d(devices=None, model_parallel: int = 1,
                 backend: Optional[str] = None):
    """The 2-D (data x model) mesh over every rank of the process group,
    a ``DeviceMesh`` of shape ``(world // model_parallel,
    model_parallel)`` with the dimensions ``('data', 'model')``: the rank
    at (d, m) is ``d * model_parallel + m``, as the JAX package's
    ``devs.reshape(n // mp, mp)``.  With ``model_parallel`` 1 it is still
    a 2-D mesh, on which the JAX package's train step is the TP one.
    ``devices`` and ``backend`` are ``make_mesh``'s; a world that
    ``model_parallel`` does not divide raises ``ValueError``."""
    kind = _init_group(devices, backend)
    world = dist.get_world_size()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} devices not divisible by "
                         f"model_parallel={model_parallel}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(kind, (world // model_parallel, model_parallel),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def has_model_axis(mesh) -> bool:
    """Whether ``mesh`` is a 2-D (data x model) mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    return names is not None and MODEL_AXIS in names


def check_data_mesh(mesh) -> None:
    """Raise ``ValueError`` unless ``mesh`` has a ``'data'`` axis: a 1-D
    ``('data',)`` mesh, or a 2-D ``('data', 'model')`` one, on which a
    bank is sharded over the data axis and replicated over the model
    axis (the JAX package's ``P('data')`` on either mesh)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None or tuple(names) not in ((DATA_AXIS,),
                                             (DATA_AXIS, MODEL_AXIS)):
        raise ValueError(
            f"sharded serving needs a ('data',) or ('data', 'model') mesh, "
            f"not one of axes {names!r}")


def visible_ranks() -> int:
    """The ranks of the process group, or of the one ``torchrun`` is
    about to make (``WORLD_SIZE``); 1 for a lone process."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def serving_mesh(data_parallel: int, devices=None,
                 backend: Optional[str] = None):
    """The 1-D ``('data',)`` mesh of a data-parallel artifact or bank
    over exactly ``data_parallel`` ranks (the JAX package's
    ``_serving_mesh`` over the first N devices: an SPMD world has no
    ranks to leave out).  A world of another size raises ``ValueError``;
    ``devices`` and ``backend`` are ``make_mesh``'s."""
    world = visible_ranks()
    if world != data_parallel:
        raise ValueError(f"data_parallel={data_parallel} needs "
                         f"{data_parallel} devices; only {world} visible")
    return make_mesh(devices, backend)


def serving_mesh_2d(data_parallel: int, model_parallel: int, devices=None,
                    backend: Optional[str] = None):
    """The 2-D ``('data', 'model')`` mesh of a tensor-parallel artifact
    over exactly ``data_parallel * model_parallel`` ranks (the JAX
    package's ``_serving_mesh_2d``); another world raises
    ``ValueError``."""
    need, world = data_parallel * model_parallel, visible_ranks()
    if world != need:
        raise ValueError(
            f"data_parallel={data_parallel} x model_parallel="
            f"{model_parallel} needs {need} devices; {world} visible")
    return make_mesh_2d(devices, model_parallel, backend)


def axis_size(mesh) -> int:
    """Ranks on the data axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(0)


def axis_rank(mesh) -> int:
    """This rank's place on the data axis (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(DATA_AXIS)


def _group(mesh):
    return mesh.get_group(DATA_AXIS)


def local_slice(n: int, mesh) -> slice:
    """This rank's contiguous share of ``n`` rows; ``n`` must divide the
    data axis (static shapes, as in the JAX package)."""
    size = axis_size(mesh)
    if n % size:
        raise ValueError(f"batch of {n} rows does not divide the mesh "
                         f"data-axis size {size}")
    share = n // size
    start = axis_rank(mesh) * share
    return slice(start, start + share)


def shard_batch(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's contiguous slice of every entry's leading axis (tensors
    or numpy arrays); the batch must divide the data axis."""
    n = len(next(iter(batch.values())))
    rows = local_slice(n, mesh)
    return {k: v[rows] for k, v in batch.items()}


def _leaves(tree, out: List[Any]) -> List[Any]:
    """The leaves of ``tree`` (dicts in sorted key order, tuples, lists)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _leaves(tree[k], out)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def _with_leaves(tree, leaves) -> Any:
    """``tree`` rebuilt with the leaves of the iterator ``leaves``, taken
    in ``_leaves``'s order."""
    if isinstance(tree, dict):
        new = {k: _with_leaves(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_with_leaves(v, leaves) for v in tree)
    return next(leaves)


def _from_rank_0(mesh):
    """(group, source) of each broadcast that takes rank 0's value to
    every rank: over the model axis from each model group's first rank,
    then over the data axis from each data group's first rank (ranks
    (0, m) then hold rank 0's)."""
    names = (MODEL_AXIS, DATA_AXIS) if has_model_axis(mesh) else (DATA_AXIS,)
    for name in names:
        group = mesh.get_group(name)
        yield group, dist.get_global_rank(group, 0)


def _broadcast(t: torch.Tensor, mesh) -> None:
    """Rank 0's ``t`` on every rank of the mesh, in place."""
    for group, src in _from_rank_0(mesh):
        dist.broadcast(t, src=src, group=group)


def broadcast_object(obj: Any, mesh) -> Any:
    """Rank 0's ``obj`` (any picklable value) on every rank of the mesh."""
    box = [obj]
    for group, src in _from_rank_0(mesh):
        dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


@torch.no_grad()
def replicate(tree: Any, mesh) -> Any:
    """Make every rank hold rank 0's values of ``tree`` (dicts, tuples
    and lists, as a train state: parameters, optimizer slots, a step
    count, the dropout generator), which has the same structure and
    tensor shapes on every rank.  Each tensor is broadcast in place, a
    ``torch.Generator`` takes rank 0's state, and every other leaf (a
    count) is rank 0's in the tree returned: use the returned tree."""
    leaves = _leaves(tree, [])
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            _broadcast(leaf.data, mesh)
        elif isinstance(leaf, torch.Generator):
            # NCCL moves only CUDA tensors: the state crosses on the device
            state = leaf.get_state().to(leaf.device)
            _broadcast(state, mesh)
            leaf.set_state(state.cpu())
    plain = broadcast_object(
        [None if isinstance(x, (torch.Tensor, torch.Generator)) else x
         for x in leaves], mesh)
    return _with_leaves(tree, iter(
        x if isinstance(x, (torch.Tensor, torch.Generator)) else y
        for x, y in zip(leaves, plain)))


@torch.no_grad()
def all_reduce_flat(tensors: Sequence[torch.Tensor], mesh
                    ) -> List[torch.Tensor]:
    """The sums over the data axis of ``tensors`` (each of any shape),
    reduced as ONE float32 buffer: one collective instead of one a
    tensor, which matters where gloo stages each call through host
    memory.  Returns new tensors of the inputs' shapes and dtypes."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=_group(mesh))
    out, start = [], 0
    for t in tensors:
        out.append(flat[start:start + t.numel()].view(t.shape).to(t.dtype))
        start += t.numel()
    return out


def psum_mean_grads(grads: Dict[str, torch.Tensor], mesh
                    ) -> Dict[str, torch.Tensor]:
    """The mean of each gradient over the data axis (one flat
    ``all_reduce``, then a divide by the axis size)."""
    keys = sorted(grads)
    summed = all_reduce_flat([grads[k] for k in keys], mesh)
    return {k: s / axis_size(mesh) for k, s in zip(keys, summed)}


@torch.no_grad()
def broadcast_value(value: float, mesh) -> float:
    """Rank 0's ``value`` on every rank (float64 on the mesh's device)."""
    t = torch.tensor([value], dtype=torch.float64,
                     device=_mesh_device(mesh))
    _broadcast(t, mesh)
    return float(t.item())


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@torch.no_grad()
def all_gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``t`` concatenated along the leading axis in rank
    order (each rank's ``t`` has the same shape)."""
    parts = [torch.empty_like(t) for _ in range(axis_size(mesh))]
    dist.all_gather(parts, t.contiguous(), group=_group(mesh))
    return torch.cat(parts)


@torch.no_grad()
def sum_rows(t: torch.Tensor, mesh, scatter: bool) -> torch.Tensor:
    """The sum of ``t`` over the data axis: all of it on every rank, or,
    with ``scatter``, only this rank's contiguous slice of the leading
    axis (``reduce_scatter_tensor``, the JAX package's ``psum_scatter``;
    the leading axis must divide the axis size)."""
    t = t.contiguous()
    if not scatter:
        dist.all_reduce(t, group=_group(mesh))
        return t
    out = t.new_empty((t.shape[0] // axis_size(mesh),) + t.shape[1:])
    dist.reduce_scatter_tensor(out, t, group=_group(mesh))
    return out


# ---------------------------------------------------------------------------
# The model axis: which rank holds which slice of each weight
# ---------------------------------------------------------------------------

def model_axis_size(mesh) -> int:
    """Ranks on the model axis (1 without a mesh or on a 1-D mesh)."""
    return mesh.size(1) if has_model_axis(mesh) else 1


def model_rank(mesh) -> int:
    """This rank's place on the model axis (0 without one)."""
    return mesh.get_local_rank(MODEL_AXIS) if has_model_axis(mesh) else 0


def model_group(mesh):
    """The process group of this rank's model axis (its data index)."""
    return mesh.get_group(MODEL_AXIS)


def is_first_rank(mesh) -> bool:
    """Rank 0 of the mesh (the one that writes files); True without one."""
    return axis_rank(mesh) == 0 and model_rank(mesh) == 0


def tp_spec_for(name: Optional[str], shape: Sequence[int], mesh
                ) -> Optional[int]:
    """The axis of ``TP_RULES[name]`` if the model axis divides the full
    ``shape`` there, else None (replicated), as the JAX package's
    ``_tp_spec_for`` (small configs may not divide every dimension)."""
    ax = TP_RULES.get(name) if name is not None else None
    if ax is None or not has_model_axis(mesh):
        return None
    if ax >= len(shape) or shape[ax] % model_axis_size(mesh):
        return None
    return ax


def _map_named(tree, fn, name=None):
    """``tree`` with each leaf ``x`` replaced by ``fn(name, x)``, ``name``
    the innermost dict key above it that ``TP_RULES`` lists (optimizer
    slots mirror the parameter dict, so a slot's key is its parameter's
    name)."""
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, k if k in TP_RULES else name)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_named(v, fn, name) for v in tree)
    return fn(name, tree)


def state_shardings(state: Any, mesh) -> Any:
    """The layout of a full (unsharded) train state, a parameter dict or
    any tree of them on ``mesh``: the same tree with each tensor leaf
    replaced by its sharded axis (``tp_spec_for``) or None, and every
    other leaf by None."""
    return _map_named(state, lambda name, x: (
        tp_spec_for(name, tuple(x.shape), mesh)
        if isinstance(x, torch.Tensor) else None))


def param_shardings(mcfg, mesh) -> Dict[str, Optional[int]]:
    """``state_shardings`` of the parameters of ``mcfg`` (shapes only:
    made on the meta device)."""
    from ..model.decoder import init_params
    return state_shardings(init_params(mcfg, torch.Generator(), "meta"),
                           mesh)


def _shard_leaf(x, ax, mesh):
    if ax is None or not isinstance(x, torch.Tensor):
        return x
    part = x.shape[ax] // model_axis_size(mesh)
    out = x.detach().narrow(ax, model_rank(mesh) * part, part).clone()
    return out.requires_grad_(x.requires_grad)


def shard_state(state: Any, mesh) -> Any:
    """This rank's share of a full train state (or parameter dict): the
    contiguous slice at its model index of every leaf that
    ``state_shardings`` shards, the whole of every other leaf (a new
    tree; the sharded leaves are new tensors)."""
    return _with_leaves(state, iter(
        _shard_leaf(x, ax, mesh) for x, ax in zip(
            _leaves(state, []), _leaves(state_shardings(state, mesh), []))))


@torch.no_grad()
def _gather_leaf(x, ax, mesh):
    if ax is None or not isinstance(x, torch.Tensor):
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(model_axis_size(mesh))]
    dist.all_gather(parts, x, group=model_group(mesh))
    return torch.cat(parts, dim=ax)


def gather_state(state: Any, mesh, shardings: Any) -> Any:
    """The full leaves of a sharded state: each leaf that ``shardings``
    (``state_shardings`` of the full state, which a sharded leaf's shape
    no longer tells) marks sharded is gathered over the model axis in
    rank order; every other leaf is returned as it is.  Every rank of
    the mesh calls it."""
    return _with_leaves(state, iter(
        _gather_leaf(x, ax, mesh) for x, ax in zip(
            _leaves(state, []), _leaves(shardings, []))))


# ---------------------------------------------------------------------------
# Ranks on one host without torchrun
# ---------------------------------------------------------------------------

def _rank_main(rank: int, fn: Callable, world_size: int, args: tuple,
               device: str, backend: Optional[str], timeout: float,
               root: str) -> None:
    # what torchrun tells a rank, so entry points see a launched rank
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world_size))
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(
        backend or default_backend(dev.type),
        init_method=f"file://{os.path.join(root, 'store')}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(make_mesh(dev.type), *args)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        # Objects of fn still held only by reference cycles (rank 0 of
        # cli.serve's daemon: its server and _MeshCalls reference each
        # other) are freed here, while the group they hold is alive.
        # Left to a later collection they can be freed as the
        # interpreter finalizes, after the group's teardown, and the
        # process then aborts ("terminate called without an active
        # exception") with its work done.
        gc.collect()
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, args: tuple = (), *,
          device: str = "cuda", backend: Optional[str] = None,
          timeout: float = 120.0) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``world_size`` new processes of this
    host (the ``spawn`` start method; ``fn`` must be importable by name)
    and return each rank's result, in rank order.

    The ranks meet through a file store in a fresh temporary directory.
    ``device='cuda'`` puts rank r on ``cuda:r % device_count`` (two ranks
    on one card need ``backend='gloo'``: NCCL refuses a card twice);
    ``'cuda:i'`` puts every rank on card i.  Each collective waits at
    most ``timeout`` seconds, and so does the launch: a rank that fails
    or hangs ends every rank and raises here."""
    import torch.multiprocessing as mp
    root = tempfile.mkdtemp(prefix="stvd_ranks_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, args, device, backend,
                              timeout, root),
            nprocs=world_size, start_method="spawn", join=False)
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"{world_size} ranks did not finish "
                                   f"within {timeout} s")
        return [torch.load(os.path.join(root, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
