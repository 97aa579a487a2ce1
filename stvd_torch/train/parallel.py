"""Data parallelism over a 1-D ``('data',)`` device mesh (the port's copy
of the data axis of stvd/train/parallel.py).

The JAX package is single-controller: one process holds a ``Mesh`` and
XLA inserts the gradient ``psum``.  The port is SPMD: one process per
device (launched by ``torchrun``, or by ``spawn`` below for ranks on one
host), a ``torch.distributed`` process group for the mesh's data axis
(``torch.distributed.device_mesh``), and explicit collectives.  Every
function here, and every function of the port that takes a ``mesh``, is
called by every rank of the mesh with the same arguments (apart from the
rank's own data), in the same order: a collective waits for all ranks.

The collectives are the ones NCCL takes and gloo takes for CUDA tensors
(``all_reduce``, ``broadcast`` and ``broadcast_object_list``, which is
built on it, ``all_gather``, ``reduce_scatter_tensor``), so one code
path serves NCCL across cards and gloo on one card or on the CPU.  The
backend is chosen explicitly (``make_mesh(backend=...)``); without a
choice it is NCCL on CUDA and gloo on the CPU.

The model axis of the JAX module (``TP_RULES``, ``make_mesh_2d`` with
``model_parallel > 1``, ``state_shardings``, ``shard_state``) is not
ported: ROADMAP.md Queue 1 item 8b.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
_MODEL_AXIS_TODO = ("tensor parallelism (a 'model' mesh axis) is not "
                    "ported yet (ROADMAP.md Queue 1 item 8b)")


def default_backend(device_type: str) -> str:
    """torch's own choice: NCCL for CUDA tensors, gloo for the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


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
    kind = torch.device(devices if devices is not None else "cuda").type
    if not dist.is_initialized():
        if kind == "cuda" and "LOCAL_RANK" in os.environ:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group(backend or default_backend(kind),
                                init_method="env://")
    elif backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"not the requested {backend!r}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(kind, (dist.get_world_size(),),
                            mesh_dim_names=(DATA_AXIS,))


def make_mesh_2d(devices=None, model_parallel: int = 1,
                 backend: Optional[str] = None):
    """The JAX package's 2-D (data x model) mesh: with ``model_parallel``
    1 it is the data mesh; above 1 it is not ported (item 8b)."""
    if model_parallel > 1:
        raise NotImplementedError(_MODEL_AXIS_TODO)
    return make_mesh(devices, backend)


def check_data_mesh(mesh) -> None:
    """Raise unless ``mesh`` is a 1-D ``('data',)`` mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None or tuple(names) != (DATA_AXIS,):
        raise NotImplementedError(
            f"only a 1-D ('data',) mesh is ported, not {names!r}; "
            + _MODEL_AXIS_TODO)


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


def broadcast_object(obj: Any, mesh) -> Any:
    """Rank 0's ``obj`` (any picklable value) on every rank."""
    group = _group(mesh)
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return box[0]


@torch.no_grad()
def replicate(tree: Any, mesh) -> Any:
    """Make every rank hold rank 0's values of ``tree`` (dicts, tuples
    and lists, as a train state: parameters, optimizer slots, a step
    count, the dropout generator), which has the same structure and
    tensor shapes on every rank.  Each tensor is broadcast in place, a
    ``torch.Generator`` takes rank 0's state, and every other leaf (a
    count) is rank 0's in the tree returned: use the returned tree."""
    group = _group(mesh)
    src = dist.get_global_rank(group, 0)
    leaves = _leaves(tree, [])
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            dist.broadcast(leaf.data, src=src, group=group)
        elif isinstance(leaf, torch.Generator):
            # NCCL moves only CUDA tensors: the state crosses on the device
            state = leaf.get_state().to(leaf.device)
            dist.broadcast(state, src=src, group=group)
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
    group = _group(mesh)
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
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
