"""Tensor-parallel products over the model axis of a 2-D mesh.

The JAX package places the big weights by ``TP_RULES`` and lets XLA
insert one ``psum`` a sharded product.  PyTorch propagates no shardings,
so the port writes the two products itself, and each site of the model
that multiplies by a weight ``TP_RULES`` lists calls them:

* row-parallel ``x @ W`` (``row``, ``row_sum``, ``row_split``), W sharded
  on its input rows: each rank multiplies its slice of x's features by
  its rows of W, and one ``all_reduce`` over the model axis sums the
  partial products.  A bias is added once, after the reduce, by the
  caller.  In the backward each rank forms its slice of dx and an
  ``all_gather`` gives the whole of it; dW stays on the rank.  A weight
  that is whole on the rank (an axis the model size does not divide) is
  the plain product, with no collective: that is the layout.
* vocab-column ``act @ W + b`` (``vocab``), W sharded on its columns:
  each rank takes its columns and an ``all_gather`` gives the full
  logits; the backward takes the rank's columns of dy and reduces dact.

Whether a product is sharded is read from the shapes: the local W has
fewer rows than x has features (or fewer columns than the vocab).  The
hand-derived sequence VJP (``seqgrad``), which runs outside autograd,
uses ``col`` / ``col_sum`` (dy @ W^T, then the gather) and ``wgrad``.

Activations stay replicated: every rank of a model group computes the
same bits after each reduce or gather (ring reductions in NCCL and gloo
give every rank the same sum), so the nonlinearities, the attention
kernels and the decode loops run whole on every rank.  The axis is set
for a block by ``model_axis(mesh, cfg)``; outside one, or on a mesh whose
model axis has one rank, every function here is the plain product.

The collectives have a second spelling that ``torch.export`` records
(``functional_collectives``, entered by a sharded artifact's export):
the same reductions on the same bytes, so the same bits.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..train import parallel
from . import step as step_mod


class Axis(NamedTuple):
    group: Any       # the model axis' process group
    size: int        # ranks on it
    rank: int        # this rank's place on it
    n_words: int     # the full vocab: ff_logit_W is sharded iff narrower


_AXIS: contextvars.ContextVar = contextvars.ContextVar("model_axis",
                                                       default=None)


def current() -> Optional[Axis]:
    """The model axis of the enclosing ``model_axis`` block, or None."""
    return _AXIS.get()


def check_options(cfg, mesh) -> None:
    """Refuse the kernels that cannot run under a model axis.  Kernels 3
    (gates + LSTM) and 6 (train-scan tail) each fuse a row-sharded
    product with the LSTM nonlinearity: a rank holds only a partial sum
    of the preactivation, which would have to be reduced inside the
    kernel, before the nonlinearity.  'auto' takes the plain products
    there, as the JAX package's TP paths run its plain step."""
    if parallel.model_axis_size(mesh) <= 1:
        return
    for name, what in (("gates_kernel", "gates+LSTM"),
                       ("train_tail_kernel", "train-scan tail")):
        if getattr(cfg, name) == "on":
            raise ValueError(
                f"{name}='on' cannot run under a model axis: the {what} "
                "kernel fuses a row-sharded product with the LSTM "
                "nonlinearity, and each rank holds only a partial sum of "
                "the preactivation; use 'off' or 'auto' with "
                "model_parallel > 1")


@contextlib.contextmanager
def model_axis(mesh, cfg):
    """Within the block, the products of the model run over the model
    axis of ``mesh`` (a model config ``cfg`` gives the vocab); a mesh
    without one, or with one rank on it, leaves them plain."""
    check_options(cfg, mesh)
    axis = None
    if parallel.model_axis_size(mesh) > 1:
        axis = Axis(parallel.model_group(mesh),
                    parallel.model_axis_size(mesh),
                    parallel.model_rank(mesh), cfg.n_words)
    with using(axis):
        yield axis


@contextlib.contextmanager
def using(axis: Optional[Axis]):
    """Within the block the products run over ``axis`` (None: plain).  A
    backward runs outside the forward's block, and on the card in
    autograd's own thread: a Function keeps ``current()`` from its
    forward and re-enters it here."""
    token = _AXIS.set(axis)
    try:
        yield axis
    finally:
        _AXIS.reset(token)


# ---------------------------------------------------------------------------
# Collectives (float32 on the wire for bf16: the gathers stay exact)
# ---------------------------------------------------------------------------

_FUNCTIONAL: contextvars.ContextVar = contextvars.ContextVar(
    "functional_collectives", default=False)

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

# the integer type of each float type's bits
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


@contextlib.contextmanager
def functional_collectives():
    """Within the block the collectives below take their traceable
    spelling, which ``torch.export`` records as ``_c10d_functional`` ops
    (an exported graph of the model axis holds them): the same
    reductions on the same bytes, so the same bits as the in-place c10d
    calls of the live path.  An export enters it."""
    token = _FUNCTIONAL.set(True)
    try:
        yield
    finally:
        _FUNCTIONAL.reset(token)


def _functional() -> bool:
    return _FUNCTIONAL.get() or torch.compiler.is_exporting()


def all_reduce(t: torch.Tensor, axis: Axis, op: str = "sum"
               ) -> torch.Tensor:
    """The sum (or, with ``op='max'``, the maximum) of ``t`` over the
    axis: in place of a contiguous ``t`` on the live path, a new tensor
    in the traceable spelling."""
    if _functional():
        from torch.distributed import _functional_collectives as funcol
        return _waited(funcol.all_reduce(t, op, axis.group))
    dist.all_reduce(t, op=_OPS[op], group=axis.group)
    return t


def _waited(t: torch.Tensor) -> torch.Tensor:
    """A functional collective's result as a plain tensor (run eagerly it
    is an ``AsyncCollectiveTensor``; traced, already one)."""
    from torch.distributed._functional_collectives import (
        AsyncCollectiveTensor)
    return t.wait() if isinstance(t, AsyncCollectiveTensor) else t


def _gather_by_sum(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The traceable gather: each rank places ``t`` in its own block of a
    zero buffer and one ``all_reduce`` sums the buffers, as the integers
    of their bits (adding zeros is exact, and an integer sum also keeps
    -0.0).  Gloo has no ``all_gather_into_tensor`` for CUDA tensors."""
    from torch.distributed import _functional_collectives as funcol
    dim = dim % t.dim()
    width = t.shape[dim]
    pad = [list(t.shape), list(t.shape)]
    pad[0][dim] = axis.rank * width
    pad[1][dim] = (axis.size - 1 - axis.rank) * width
    buf = torch.cat([t.new_zeros(pad[0]), t, t.new_zeros(pad[1])], dim=dim)
    bits = _BITS.get(buf.dtype)
    if bits is None:
        return _waited(funcol.all_reduce(buf, "sum", axis.group))
    return _waited(funcol.all_reduce(buf.view(bits), "sum",
                                     axis.group)).view(t.dtype)


def gather(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim``, in rank order."""
    wire = t.float() if t.dtype == torch.bfloat16 else t
    wire = wire.contiguous()
    if _functional():
        return _gather_by_sum(wire, axis, dim).to(t.dtype)
    parts = [torch.empty_like(wire) for _ in range(axis.size)]
    dist.all_gather(parts, wire, group=axis.group)
    return torch.cat(parts, dim=dim).to(t.dtype)


def gather_last(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The ranks' ``t`` concatenated along the last axis, in rank order."""
    return gather(t, axis, -1)


def _part(t: torch.Tensor, dim: int, part: int, axis: Axis) -> torch.Tensor:
    return t.narrow(dim, axis.rank * part, part)


class _Reduce(torch.autograd.Function):
    """all_reduce forward; the replicated cotangent passes back as is."""

    @staticmethod
    def forward(ctx, y, axis):
        return all_reduce(y.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Cols(torch.autograd.Function):
    """The rank's slice of the last axis; backward gathers the slices."""

    @staticmethod
    def forward(ctx, x, axis, part):
        ctx.axis = axis
        return _part(x, -1, part, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather(g, ctx.axis, -1), None, None


class _Rows(torch.autograd.Function):
    """The rank's rows of a replicated leaf; backward gathers the rows'
    gradients into the whole leaf's (each rank holds its own rows')."""

    @staticmethod
    def forward(ctx, w, axis, part):
        ctx.axis = axis
        return _part(w, 0, part, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather(g, ctx.axis, 0), None, None


class _GatherRows(torch.autograd.Function):
    """A row-sharded weight made whole; backward sums the ranks' partial
    gradients of the whole and keeps the rank's rows."""

    @staticmethod
    def forward(ctx, w, axis):
        ctx.axis = axis
        return gather(w, axis, 0)

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        wire = g.float().contiguous()
        out = wire.new_empty((g.shape[0] // axis.size,) + g.shape[1:])
        dist.reduce_scatter_tensor(out, wire, group=axis.group)
        return out.to(g.dtype), None


class _Copy(torch.autograd.Function):
    """Identity forward; backward sums the ranks' partial cotangents."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.axis), None


class _GatherLast(torch.autograd.Function):
    """Vocab columns gathered to the full width; backward keeps the
    rank's columns of the cotangent."""

    @staticmethod
    def forward(ctx, y, axis):
        ctx.axis = axis
        return gather_last(y, axis)

    @staticmethod
    def backward(ctx, g):
        axis = ctx.axis
        return _part(g, -1, g.shape[-1] // axis.size, axis).contiguous(), None


# ---------------------------------------------------------------------------
# The products
# ---------------------------------------------------------------------------

def _sharded(width: int, rows: int) -> Optional[Axis]:
    """The axis when a weight of ``rows`` local rows is a row slice of one
    that takes ``width`` input features, else None."""
    axis = current()
    if axis is None or rows == width:
        return None
    if rows * axis.size != width:
        raise ValueError(f"a weight of {rows} rows cannot take {width} "
                         f"features over {axis.size} model ranks")
    return axis


def row_sum(terms: Sequence[Tuple[torch.Tensor, torch.Tensor]],
            cdtype: torch.dtype) -> torch.Tensor:
    """``sum_i x_i @ W_i`` in float32 (``step._dot`` each), the sharded
    terms' partial sums reduced together: one ``all_reduce`` for all."""
    part = whole = None
    for x, w in terms:
        axis = _sharded(x.shape[-1], w.shape[0])
        if axis is None:
            y = step_mod._dot(x, w, cdtype)
            whole = y if whole is None else whole + y
        else:
            y = step_mod._dot(_Cols.apply(x, axis, w.shape[0]), w, cdtype)
            part = y if part is None else part + y
            red = axis
    if part is None:
        return whole
    part = _Reduce.apply(part, red)
    return part if whole is None else part + whole


def row(x: torch.Tensor, w: torch.Tensor, cdtype: torch.dtype
        ) -> torch.Tensor:
    """``x @ W`` in float32, row-parallel when W is a row slice."""
    return row_sum([(x, w)], cdtype)


def row_split(x: torch.Tensor, ws: Sequence[torch.Tensor],
              cdtype: torch.dtype) -> List[torch.Tensor]:
    """``[x @ W for W in ws]`` (weights of one row layout); sharded, the
    products run as one over the weights side by side, with one reduce."""
    if _sharded(x.shape[-1], ws[0].shape[0]) is None:
        return [row(x, w, cdtype) for w in ws]
    y = row(x, torch.cat(list(ws), dim=1), cdtype)
    return list(torch.split(y, [w.shape[1] for w in ws], dim=-1))


def rows_like(t: torch.Tensor, rows: int) -> torch.Tensor:
    """A replicated leaf cut to the ``rows`` rows of this rank, to stand
    beside row-sharded weights in a fused one (W_sel beside Wd_att); its
    gradient comes back whole."""
    axis = _sharded(t.shape[0], rows)
    return t if axis is None else _Rows.apply(t, axis, rows)


def whole_rows(w: torch.Tensor, width: int) -> torch.Tensor:
    """A weight of ``width`` input rows made whole on every rank (Wc_att
    composed with W_spat_fuse); its gradient is summed over the ranks and
    cut back to the rank's rows."""
    axis = _sharded(width, w.shape[0])
    return w if axis is None else _GatherRows.apply(w, axis)


def vocab(act: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          cdtype: torch.dtype) -> torch.Tensor:
    """The float32 logits ``act @ W + b``; with W sharded on its vocab
    columns each rank forms its columns and they are gathered to the
    full ``(..., V)``."""
    axis = current()
    if axis is None or w.shape[1] == axis.n_words:
        return step_mod._dot(act, w, cdtype) + b
    local = step_mod._dot(_Copy.apply(act, axis), w, cdtype) + b
    return _GatherLast.apply(local, axis)


# ---------------------------------------------------------------------------
# Outside autograd: the hand-derived sequence VJP and the region projection
# ---------------------------------------------------------------------------

def local_cols(x: torch.Tensor, rows: int) -> torch.Tensor:
    """x's features that a weight of ``rows`` local rows takes on this
    rank (all of them when the weight is whole), contiguous."""
    axis = _sharded(x.shape[-1], rows)
    return x if axis is None else _part(x, -1, rows, axis).contiguous()


def reduce_rows(y: torch.Tensor, width: int, rows: int) -> torch.Tensor:
    """``y``, a product of ``local_cols``' features, summed over the axis
    when the weight is a row slice."""
    axis = _sharded(width, rows)
    return y if axis is None else all_reduce(y.contiguous(), axis)


def col_sum(terms: Sequence[Tuple[torch.Tensor, torch.Tensor]], width: int,
            cdtype: torch.dtype) -> torch.Tensor:
    """``sum_i dy_i @ W_i^T`` (float32) over the ``width`` input features
    of the W_i (weights of one row layout): the rank's columns, then one
    ``all_gather`` when the weights are row slices."""
    y = None
    for dy, w in terms:
        t = step_mod._dot(dy, w.t(), cdtype)
        y = t if y is None else y + t
    axis = _sharded(width, terms[0][1].shape[0])
    return y if axis is None else gather_last(y, axis)


def col(dy: torch.Tensor, w: torch.Tensor, width: int, cdtype: torch.dtype
        ) -> torch.Tensor:
    """``dy @ W^T`` over W's ``width`` input features, gathered."""
    return col_sum([(dy, w)], width, cdtype)


def wgrad(x: torch.Tensor, dy: torch.Tensor, w: torch.Tensor,
          cdtype: torch.dtype) -> torch.Tensor:
    """dW = x^T @ dy for the rows of W on this rank (``x`` 2-D)."""
    return step_mod._dot(local_cols(x, w.shape[0]).t(), dy, cdtype)
