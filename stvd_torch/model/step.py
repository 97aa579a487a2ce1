"""The spatial-temporal attention + LSTM decoder step in plain PyTorch.

Counterpart of ``stvd/model/step.py``: the temporal model (preset 3), the
spatial stream over R regions per frame (preset 2), the W8A8 int8 gates
(``decode_quant='int8'``), and what the training forward shares with
decoding (``precompute``, ``init_state``, the logit stack with its train
dropout).  It is the correctness oracle for the CUDA kernels in
``kernel.py``: ``_attention_core``, ``_spatial_core`` and ``_gates_lstm``
here are the plain versions of the attention-core, spatial-core and
gates+LSTM kernels, and ``step_with_core`` swaps each for its kernel
through a hook.  The step also has the JAX step's teacher-forced branch
(``x_pre`` given), which the autodiff train scan runs; the default train
scan has its own step body with a hand-derived backward (``seqgrad.py``).

Layouts follow the JAX package at every public function: batch-major
``(B, K, D)`` context, a state batch ``Bs = Bc * nb`` that may carry
``nb`` beams per context row (the context is never tiled nb-fold), and
parameters as a dict keyed by the JAX names.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import tp

Params = Dict[str, torch.Tensor]

# (global rows, this rank's first row) of a data-parallel batch while
# ``global_rows`` holds; None on one device
_GLOBAL_ROWS: contextvars.ContextVar = contextvars.ContextVar(
    "global_rows", default=None)

_NEG_INF = -1e30


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def masked_softmax(e: torch.Tensor, mask: Optional[torch.Tensor],
                   dim: int = -1) -> torch.Tensor:
    """Numerically safe masked softmax; a fully-masked row gives zeros,
    not NaN (padded videos with no valid frame)."""
    if mask is not None:
        e = torch.where(mask > 0, e, torch.full_like(e, _NEG_INF))
    m = e.amax(dim=dim, keepdim=True)
    ex = torch.exp(e - m)
    if mask is not None:
        ex = ex * (mask > 0)
    denom = ex.sum(dim=dim, keepdim=True)
    return ex / denom.clamp_min(1e-20)


class StepState(NamedTuple):
    h: torch.Tensor        # (B, dim) f32
    c: torch.Tensor        # (B, dim) f32


class StepContext(NamedTuple):
    """Per-sequence tensors that are constant across decode steps (or
    train-scan steps), built once by ``precompute`` outside the loop."""

    ctx: torch.Tensor       # (Bc, K, ctx_dim) frame features
    pctx: torch.Tensor      # (Bc, K, attn_dim) f32: ctx @ Wc_att + b_att
    ctx_mask: torch.Tensor  # (Bc, K) f32
    mean_ctx: torch.Tensor  # (Bc, ctx_dim) f32 masked mean (for h0/c0)
    h_att_w: torch.Tensor   # (dim, attn_dim + 1 [+ s]) = [Wd_att | W_sel (| Wsd_att)]
    gates_w: Optional[torch.Tensor]  # decode: (dim_word + dim + ctx_dim, 4 dim) = [W; U; Wc], kmajor
    regions: Optional[torch.Tensor] = None    # (Bc, K, R, Dr) spatial only
    pregion: Optional[torch.Tensor] = None    # (Bc, K, R, s) f32
    w_sf_att: Optional[torch.Tensor] = None   # (Dr, attn_dim) f32 = W_spat_fuse @ Wc_att
    gates_w_q: Optional[torch.Tensor] = None  # int8 gates stack (decode_quant), K-major
    gates_scale: Optional[torch.Tensor] = None  # (4 dim,) f32 per-column scale
    h_proj_w: Optional[torch.Tensor] = None  # train: (dim, 4 dim + attn + 1 [+ s]) = [U | h_att_w]
    gates_w_pad: Optional[torch.Tensor] = None  # gates_w over Kx', zero past Kx


class StepOut(NamedTuple):
    h: torch.Tensor         # (B, dim)
    c: torch.Tensor         # (B, dim)
    ctx_t: torch.Tensor     # (B, ctx_dim) attended, gated context, f32
    alpha: torch.Tensor     # (B, K) temporal attention weights, f32
    alpha_s: Optional[torch.Tensor] = None  # (B, K, R) spatial weights, f32


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m, k) @ (k, n) of two bf16 matrices with a float32 result: on the
    card through cuBLAS with ``out_dtype``, on the CPU by upcasting the
    bf16 operands (their products are exact in float32, the sum
    accumulates in float32)."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _DotF32(torch.autograd.Function):
    """bf16 matmul with a float32 result, differentiable: cuBLAS's
    ``mm(..., out_dtype=)`` has no derivative, so the backward takes the
    two transposed products the same way, with the float32 cotangent
    rounded to bf16, and rounds each gradient to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = mm_f32(g, b.t()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = mm_f32(a.t(), g).to(b.dtype)
        return da, db


def _dot(a: torch.Tensor, b: torch.Tensor, cdtype: torch.dtype
         ) -> torch.Tensor:
    """Matmul with operands in the compute dtype and a float32 result,
    as JAX's ``preferred_element_type=float32`` gives it.  A bf16
    ``torch.matmul`` would round its output to bf16, so under bf16 the
    product goes through ``_DotF32``."""
    a = a.to(cdtype)
    b = b.to(cdtype)
    if cdtype == torch.float32:
        return a @ b
    lead = a.shape[:-1]
    out = _DotF32.apply(a.reshape(-1, a.shape[-1]), b)
    return out.reshape(*lead, b.shape[-1])


def cast_params(params: Params, cfg) -> Params:
    """Weights with ndim >= 2 go to the compute dtype once; biases,
    vectors and scalars stay float32 (they add into f32 sums)."""
    cdtype = compute_dtype(cfg)
    if cdtype == torch.float32:
        return params
    return {k: (v.to(cdtype) if v.ndim >= 2 else v)
            for k, v in params.items()}


def _check_options(cfg) -> None:
    """The decode options this port serves (``stvd.config.validate``
    checks them too, but a ModelConfig may be built without it)."""
    if cfg.decode_quant not in ("none", "int8"):
        raise ValueError(f"unknown decode_quant {cfg.decode_quant!r}")
    if cfg.gates_kernel not in ("auto", "on", "off"):
        raise ValueError(f"unknown gates_kernel {cfg.gates_kernel!r}")


def _h_att_weights(params: Params, cfg) -> torch.Tensor:
    """h-projection weights of the decode path:
    [Wd_att | W_sel (| Wsd_att under spatial attention)]."""
    w_sel = tp.rows_like(params["W_sel"], params["Wd_att"].shape[0])
    cols = [params["Wd_att"], w_sel[:, None].to(params["Wd_att"].dtype)]
    if cfg.use_spatial:
        cols.append(params["Wsd_att"])
    return torch.cat(cols, dim=1)


def _h_projection_weights(params: Params, cfg) -> torch.Tensor:
    """h-projection weights of the teacher-forced train scan:
    [U | Wd_att | W_sel (| Wsd_att)], one product per step gives the
    LSTM's recurrent term and the attention/selector inputs."""
    return torch.cat([params["U"], _h_att_weights(params, cfg)], dim=1)


def padded_buffer(rows: int, cols: int, dtype: torch.dtype, device
                  ) -> torch.Tensor:
    """A new (rows, cols') buffer, cols' = cols rounded up to a whole 128
    bytes of ``dtype``, whose columns past ``cols`` are zero."""
    per = 128 // dtype.itemsize
    wide = -(-cols // per) * per
    buf = torch.empty((rows, wide), dtype=dtype, device=device)
    if wide > cols:
        buf.narrow(1, cols, wide - cols).zero_()
    return buf


def padded(rows: int, cols: int, dtype: torch.dtype, device
           ) -> torch.Tensor:
    """The (rows, cols) view of a new ``padded_buffer``: rows a TMA map
    can step over (its row stride must be a multiple of 16 bytes) and
    whose starts stay on the 128-byte lines the maps' boxes read (a
    stride of 16 bytes but not 128 splits each box row across two lines,
    which made kernel 3 markedly slower on an H100).  A kernel's tensor
    map keeps the logical width, so no kernel reads the padding; it is
    zero for any other reader."""
    return padded_buffer(rows, cols, dtype, device).narrow(1, 0, cols)


def pad_cols(t: torch.Tensor) -> torch.Tensor:
    """``t`` (rows, cols) itself when its rows are dense and a whole 128
    bytes apart, else a copy in ``padded``'s layout."""
    per = 128 // t.dtype.itemsize
    if t.stride(1) == 1 and t.stride(0) % per == 0:
        return t
    out = padded(t.shape[0], t.shape[1], t.dtype, t.device)
    out.copy_(t)
    return out


def kmajor_padded(blocks, dtype: torch.dtype) -> torch.Tensor:
    """The (K', N) stack of the row blocks ``blocks`` (each (k_i, N)) in
    ``dtype``, K' = K rounded up to a whole 128 bytes, its rows past K
    zero: the view of a K-major (N, K') ``padded_buffer``, one copy, cast
    included.  ``kmajor`` is its first K rows."""
    k = sum(b.shape[0] for b in blocks)
    buf = padded_buffer(blocks[0].shape[1], k, dtype, blocks[0].device)
    o = 0
    for b in blocks:
        buf.narrow(1, o, b.shape[0]).copy_(b.t())
        o += b.shape[0]
    return buf.t()


def kmajor(blocks, dtype: torch.dtype) -> torch.Tensor:
    """The (K, N) stack of the row blocks ``blocks`` in ``dtype``, as the
    (K, N) view of its K-major (N, K) transpose with rows padded to 128
    bytes (``kmajor_padded``).  The gates kernel's wgmma route reads the
    transpose (a gate's block starts at a row, so any dim is served; a
    ragged K in padded rows); a plain product takes the view as it is."""
    k = sum(b.shape[0] for b in blocks)
    return kmajor_padded(blocks, dtype).narrow(0, 0, k)


def _gates_weights(params: Params,
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[W; U; Wc] stacked (Kx', 4 dim) in ``dtype`` (default W's) over
    the padded depth Kx' (``kmajor_padded``; its first Kx rows are the
    stack): decode computes the LSTM preactivation as one matmul over
    [emb_t | h_{t-1} | ctx_t].  Stored K-major with padded rows, the
    layout the gates kernel reads; the copy is the one a concatenation
    makes."""
    blocks = [params["W"], params["U"], params["Wc"]]
    return kmajor_padded(blocks, dtype or blocks[0].dtype)


def quantize_weights(w: torch.Tensor, reduce_max=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-column symmetric int8 grid of a (K, N) weight stack:
    (w_q int8, scale (N,) f32) with scale = max(max|w|, 1e-8) / 127 and
    w_q = clip(round(w / scale), +-127), round half to even as in JAX.
    ``w_q`` is the (K, N) view of a K-major (N, K) tensor whose rows are
    padded to 128 bytes (``kmajor``): the gates kernel's wgmma takes int8
    operands only K-major, and the plain path multiplies the view as it
    is (on the card cuBLASLt takes it as a transposed operand).
    ``reduce_max`` turns the column maxima of ``w`` into those of the
    whole stack when ``w`` holds some of its rows (the maximum over the
    model axis)."""
    w32 = w.to(torch.float32)
    amax = w32.abs().amax(dim=0)
    if reduce_max is not None:
        amax = reduce_max(amax)
    scale = amax.clamp_min(1e-8) / 127.0
    w_q = torch.clamp(torch.round(w32 / scale[None, :]), -127, 127)
    return kmajor([w_q], torch.int8), scale


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row int8 quantization of an activation:
    (x_q int8, s_r (rows, 1) f32), s_r = max(max|x|, 1e-8) / 127.  A
    division by s_r, not a multiply by its reciprocal, as in JAX.  x_q's
    rows are padded to 128 bytes (``padded``), as the gates kernel reads
    them."""
    x32 = x.to(torch.float32)
    s_r = x32.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / 127.0
    x_q = padded(x.shape[0], x.shape[1], torch.int8, x.device)
    x_q.copy_(torch.clamp(torch.round(x32 / s_r), -127, 127))
    return x_q, s_r


def precompute(params: Params, cfg, ctx: torch.Tensor,
               ctx_mask: torch.Tensor,
               regions: Optional[torch.Tensor] = None,
               train: bool = False) -> StepContext:
    """Hoist the h-independent work out of the decode loop or the train
    scan: the context and region projections and the stacked weights.
    The step's decode branch (decoding, and the scheduled-sampling train
    scan) reads the gates weights [W; U; Wc], stacked here in the compute
    dtype and, under ``decode_quant='int8'``, quantized once (from the
    compute-dtype stack, as in JAX); the teacher-forced scans (``train``:
    the hand-derived VJP and the autodiff scan, whose step takes
    ``x_pre``) read the fused h-projection [U | h_att_w] instead.  JAX
    builds both and lets XLA drop the unused one; run eagerly, each would
    cost a copy of U (117 MB in bf16 at preset widths).  Both stacks are
    differentiable: gradients reach W, U and Wc through the cast copy."""
    _check_options(cfg)
    cdtype = compute_dtype(cfg)
    pctx = tp.row(ctx, params["Wc_att"], cdtype) + params["b_att"]
    denom = ctx_mask.sum(dim=1, keepdim=True).clamp_min(1.0)
    mean_ctx = (ctx * ctx_mask[..., None]).sum(dim=1) / denom
    pregion = w_sf_att = None
    if cfg.use_spatial:
        if regions is None:
            raise ValueError("use_spatial=True but no region features given")
        from .kernel import region_projection   # kernel.py imports step
        # the spatial backward's switch also picks the dWs_att GEMM kernel
        pregion = region_projection(regions, params["Ws_att"],
                                    params["bs_att"], cdtype,
                                    cfg.spatial_bwd_kernel != "off")
        # pctx'_t = pctx + spat_t @ (W_spat_fuse @ Wc_att): the composed
        # (Dr, attn_dim) weight saves one matmul per step; under a model
        # axis its rows are those of the rank's W_spat_fuse, composed
        # with the whole Wc_att
        w_sf_att = _dot(params["W_spat_fuse"],
                        tp.whole_rows(params["Wc_att"], ctx.shape[-1]),
                        cdtype)
    gates_w = gates_w_pad = gates_w_q = gates_scale = h_proj_w = None
    kx = sum(params[n].shape[0] for n in ("W", "U", "Wc"))
    if train:
        h_proj_w = _h_projection_weights(params, cfg)
    elif tp.current() is not None:
        # the step takes W, U and Wc apart, each row-parallel; under int8
        # this rank's rows of [W; U; Wc] go on the whole stack's grid, its
        # column maxima reduced over the model axis
        if cfg.decode_quant == "int8":
            axis = tp.current()
            gates_w_q, gates_scale = quantize_weights(
                _gates_weights(params).narrow(0, 0, kx),
                lambda m: tp.all_reduce(m.contiguous(), axis, "max"))
    else:
        gates_w_pad = _gates_weights(params, cdtype)
        gates_w = gates_w_pad.narrow(0, 0, kx)
        if cfg.decode_quant == "int8":
            gates_w_q, gates_scale = quantize_weights(gates_w)
    return StepContext(ctx=ctx, pctx=pctx, ctx_mask=ctx_mask,
                       mean_ctx=mean_ctx,
                       h_att_w=_h_att_weights(params, cfg),
                       gates_w=gates_w, regions=regions, pregion=pregion,
                       w_sf_att=w_sf_att, gates_w_q=gates_w_q,
                       gates_scale=gates_scale, h_proj_w=h_proj_w,
                       gates_w_pad=gates_w_pad)


def init_state(params: Params, cfg, sc: StepContext) -> StepState:
    """h0/c0 from the masked mean context through tanh layers."""
    cdtype = compute_dtype(cfg)
    ph, pc = tp.row_split(sc.mean_ctx, [params["ff_state_W"],
                                        params["ff_memory_W"]], cdtype)
    h0 = torch.tanh(ph + params["ff_state_b"])
    c0 = torch.tanh(pc + params["ff_memory_b"])
    return StepState(h=h0, c=c0)


def _attention_core(h_att, beta_logit, pctx, ctx, ctx_mask, u_att, c_att,
                    b_sel, selector: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Temporal attention + selector gate: the plain version of the
    attention-core kernel, all math in float32.

    ``h_att`` (Bs, A) may carry nb = Bs // Bc beams per context row of
    ``pctx`` (Bc, K, A) / ``ctx`` (Bc, K, Dc); the reduction broadcasts
    over the beam axis instead of tiling the context.
    Returns (ctx_t (Bs, Dc), alpha (Bs, K)), both float32.
    """
    bs, a = h_att.shape
    bc, k, _ = pctx.shape
    nb = bs // bc
    f32 = torch.float32
    hk = h_att.to(f32).reshape(bc, nb, 1, a)
    e = torch.tanh(pctx.to(f32)[:, None] + hk)              # (Bc,nb,K,A)
    scores = (e * u_att.to(f32)).sum(dim=-1) + c_att.to(f32)
    alpha = masked_softmax(scores, ctx_mask.to(f32)[:, None, :], dim=-1)
    ctx_t = torch.einsum("bjk,bkd->bjd", alpha, ctx.to(f32))
    alpha = alpha.reshape(bs, k)
    ctx_t = ctx_t.reshape(bs, ctx.shape[-1])
    if selector:
        beta = torch.sigmoid(beta_logit.to(f32) + b_sel.to(f32))
        ctx_t = ctx_t * beta[:, None]
    return ctx_t, alpha


def _spatial_core(h_satt, pregion, regions, u_s, c_s, cdtype
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spatial attention over R regions per frame: the plain version of
    the spatial-core kernel (port of ``_spatial_core_jnp``).

    ``h_satt`` (Bs, s) carries nb = Bs // Bc beams per context row of
    ``pregion`` (Bc, K, R, s) / ``regions`` (Bc, K, R, Dr); the region
    bank is never tiled nb-fold.  The two contractions run in ``cdtype``
    as the JAX einsums do.  Returns (spat (Bc, nb, K, Dr),
    alpha_s (Bc, nb, K, R) f32).
    """
    bc = pregion.shape[0]
    bs = h_satt.shape[0]
    nb = bs // bc
    hsk = h_satt.to(torch.float32).reshape(bc, nb, 1, 1, h_satt.shape[-1])
    e_s = torch.tanh(pregion[:, None] + hsk)            # (Bc, nb, K, R, s)
    e_s = torch.einsum("bjkrd,d->bjkr", e_s.to(cdtype), u_s.to(cdtype))
    # c_s is a 0-d float32 tensor: added after the upcast, since torch
    # would not promote a bf16 tensor for it (JAX does)
    alpha_s = masked_softmax(e_s.to(torch.float32) + c_s, None, dim=-1)
    spat = torch.einsum("bjkr,bkrd->bjkd", alpha_s.to(cdtype),
                        regions.to(cdtype))               # (Bc, nb, K, Dr)
    return spat, alpha_s


def _int8_mm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 operands.  On the card through
    ``torch._int_mm`` (cuBLASLt), which refuses shapes whose rows are not
    a multiple of 16 (at least 32), or whose depth and width are not
    multiples of 8: zero rows and columns pad the operands where needed,
    which leaves every sum unchanged.  On the CPU an int32 matmul."""
    if not x_q.is_cuda:
        return x_q.to(torch.int32) @ w_q.to(torch.int32)
    m, k = x_q.shape
    n = w_q.shape[1]
    pm, pk, pn = max(32, -(-m // 16) * 16) - m, -k % 8, -n % 8
    if pm or pk:
        x_q = torch.nn.functional.pad(x_q, (0, pk, 0, pm))
    if pk or pn:
        w_q = torch.nn.functional.pad(w_q, (0, pn, 0, pk))
    return torch._int_mm(x_q, w_q)[:m, :n]


def lstm_update(preact: torch.Tensor, c: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LSTM pointwise from the (rows, 4 dim) float32 preactivation,
    gate order i, f, o, g: returns (h_t, c_t)."""
    dim = preact.shape[1] // 4
    i = torch.sigmoid(preact[:, 0 * dim: 1 * dim])
    f = torch.sigmoid(preact[:, 1 * dim: 2 * dim])
    o = torch.sigmoid(preact[:, 2 * dim: 3 * dim])
    g = torch.tanh(preact[:, 3 * dim: 4 * dim])
    c_t = f * c + i * g
    return o * torch.tanh(c_t), c_t


def _gates_lstm(x, w, b, c, s_r=None, scale=None, padded_ops=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LSTM gates and state update: the plain version of the gates+LSTM
    kernel.  ``x`` (rows, Kx) is the [emb | h | ctx_t] row block and ``w``
    (Kx, 4 dim) the [W; U; Wc] stack, both in the compute dtype, or both
    int8 with the row scales ``s_r`` (rows, 1) and column scales ``scale``
    (4 dim,) of W8A8.  The preactivation is the float32 sum (int32 under
    int8, dequantized as ``acc * (s_r * scale)``) plus ``b``; gate order
    i, f, o, g.  Returns (h_t, c_t), float32.

    ``padded_ops``, from ``step_with_core``: (x', w') over the padded
    depth Kx' (a whole 128-byte row), x and w followed by zero columns and
    rows, which the float32 product is then taken over: the same sum, and
    at a ragged Kx cuBLAS declines its Hopper kernels for an sm80 one
    about 2.5x slower on an H100."""
    if w.dtype == torch.int8:
        acc = _int8_mm(x, w)
        preact = acc.to(torch.float32) * (s_r * scale[None, :]) + b
    else:
        if padded_ops is not None:
            x, w = padded_ops
        preact = _dot(x, w, w.dtype) + b
    return lstm_update(preact, c)


def _int8_gates_sharded(params: Params, sc: StepContext,
                        emb_t: torch.Tensor, h: torch.Tensor,
                        ctx_t: torch.Tensor, cdtype: torch.dtype
                        ) -> torch.Tensor:
    """The W8A8 preactivation under a model axis, equal to one device's:
    the row scale of the whole [emb | h | ctx] row (replicated, so taken
    before the rank's features are cut), this rank's features of each
    block against its int8 rows of [W; U; Wc] (``precompute``), the
    partial int32 sums reduced as int32 (exact: the float32 sum of K
    products of up to 127^2 would round), then one dequantization.  A
    block whose weight is whole on every rank (a width the model axis
    does not divide) counts on rank 0 alone."""
    axis = tp.current()
    x_q, s_r = quantize_rows(torch.cat(
        [emb_t.to(cdtype), h.to(cdtype), ctx_t.to(cdtype)], dim=1))
    blocks = torch.split(x_q, [emb_t.shape[1], h.shape[1], ctx_t.shape[1]],
                         dim=1)
    cols = []
    for x, name in zip(blocks, ("W", "U", "Wc")):
        rows = params[name].shape[0]
        if rows == x.shape[1] and axis.rank:
            x = torch.zeros_like(x)
        cols.append(tp.local_cols(x, rows))
    acc = tp.all_reduce(_int8_mm(torch.cat(cols, dim=1),
                                 sc.gates_w_q).contiguous(), axis)
    return (acc.to(torch.float32) * (s_r * sc.gates_scale[None, :])
            + params["b"])


def step_with_core(params: Params, cfg, state: StepState, sc: StepContext,
                   emb_t: torch.Tensor, x_pre: Optional[torch.Tensor] = None,
                   attention_core=_attention_core,
                   spatial_core=_spatial_core,
                   gates_core=_gates_lstm) -> StepOut:
    """One decoder step; ``emb_t`` (B, dim_word) is the previous word's
    embedding.  Without ``x_pre`` (decoding, and the scheduled-sampling
    train scan) the h-projection takes only the attention and selector
    columns, and the gates are one product over [emb_t | h | ctx_t]
    through ``gates_core``.  With ``x_pre`` (B, 4 dim), the input
    projection ``emb_t @ W + b`` that the teacher-forced autodiff scan
    takes for all T steps in one product, the h-projection also gives
    the recurrent term ``h @ U`` and the preactivation is ``x_pre +
    h @ U + ctx_t @ Wc``, as in the JAX step.  The three hooks take the
    plain cores by default and the CUDA kernels in
    ``kernel.step_kernels``."""
    cdtype = compute_dtype(cfg)
    attn = cfg.attn_dim
    h, c = state
    if x_pre is None:
        hp = tp.row(h, sc.h_att_w, cdtype)           # (B, attn + 1 [+ s])
        off = 0
    else:
        hp = tp.row(h, sc.h_proj_w, cdtype)   # (B, 4 dim + attn + 1 [+ s])
        off = 4 * cfg.dim
    # beam broadcast: context tensors keep their (Bc, ...) batch; only
    # the recurrent state carries the beam axis (Bs = Bc * nb)
    bs = h.shape[0]
    nb = bs // sc.ctx.shape[0]
    ctx_k, pctx_k, ctx_mask = sc.ctx, sc.pctx, sc.ctx_mask
    alpha_s = None
    if cfg.use_spatial:
        spat, alpha_s = spatial_core(
            hp[:, off + attn + 1:], sc.pregion, sc.regions,
            params["Us_att"], params["cs_att"], cdtype)
        # the fused context differs per beam: (Bs, K, .) from here on,
        # and the attention core runs with nb = 1 on Bs rows
        k_f = ctx_k.shape[1]
        fuse, pfuse = tp.row_split(spat, [params["W_spat_fuse"],
                                          sc.w_sf_att], cdtype)
        ctx_k = (ctx_k[:, None] + fuse).reshape(bs, k_f, -1)
        pctx_k = (pctx_k[:, None] + pfuse).reshape(bs, k_f, -1)
        alpha_s = alpha_s.reshape(bs, k_f, -1)
        if nb > 1:
            ctx_mask = ctx_mask.repeat_interleave(nb, dim=0)
    ctx_t, alpha = attention_core(
        hp[:, off:off + attn], hp[:, off + attn], pctx_k, ctx_k, ctx_mask,
        params["U_att"], params["c_att"], params["b_sel"], cfg.selector)
    preact = None
    if x_pre is not None:
        preact = x_pre + hp[:, :off] + tp.row(ctx_t, params["Wc"], cdtype)
    elif tp.current() is not None:
        # under a model axis the gates are three row-parallel products
        # with one reduce; the gates kernel, which fuses them with the
        # LSTM, is refused there (tp.check_options)
        if sc.gates_w_q is not None:
            preact = _int8_gates_sharded(params, sc, emb_t, h, ctx_t, cdtype)
        else:
            preact = tp.row_sum([(emb_t, params["W"]), (h, params["U"]),
                                 (ctx_t, params["Wc"])], cdtype) + params["b"]
    if preact is not None:
        h_t, c_t = lstm_update(preact, c)
        return StepOut(h=h_t, c=c_t, ctx_t=ctx_t, alpha=alpha,
                       alpha_s=alpha_s)
    # [emb_t | h | ctx_t] in rows padded to 128 bytes, as the gates
    # kernel reads them: the copies (and casts) a concatenation makes
    parts = (emb_t, h, ctx_t)
    kx = sum(p.shape[1] for p in parts)
    x_pad = padded_buffer(bs, kx, cdtype, h.device)
    x_cat = x_pad.narrow(1, 0, kx)
    o = 0
    for p in parts:
        x_cat.narrow(1, o, p.shape[1]).copy_(p)
        o += p.shape[1]
    if sc.gates_w_q is not None:
        # W8A8: the activation is quantized here, once, so the kernel and
        # the plain core see the same x_q and s_r
        x_q, s_r = quantize_rows(x_cat)
        h_t, c_t = gates_core(x_q, sc.gates_w_q, params["b"], c, s_r,
                              sc.gates_scale)
    else:
        # both operands were built with zero tails (here and in
        # ``precompute``): the plain core may multiply over their padding
        ops = None if sc.gates_w_pad is None else (x_pad, sc.gates_w_pad)
        h_t, c_t = gates_core(x_cat, sc.gates_w, params["b"], c,
                              padded_ops=ops)
    return StepOut(h=h_t, c=c_t, ctx_t=ctx_t, alpha=alpha, alpha_s=alpha_s)


def step(params: Params, cfg, state: StepState, sc: StepContext,
         emb_t: torch.Tensor, x_pre: Optional[torch.Tensor] = None
         ) -> StepOut:
    """The plain decoder step (the oracle of the kernel step)."""
    return step_with_core(params, cfg, state, sc, emb_t, x_pre)


def topk_rows(x: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k ordered by value descending, ties to the lowest
    index (``lax.top_k`` order; ``torch.topk`` documents no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@contextlib.contextmanager
def global_rows(total: int, start: int):
    """Within the block, every random draw of the train forward (dropout
    masks, scheduled-sampling coins) is made for a batch of ``total`` rows
    and cut to this rank's rows from ``start``: a data-parallel rank then
    draws what the single-device update over the global batch draws, and
    the ranks' generators stay in step."""
    token = _GLOBAL_ROWS.set((total, start))
    try:
        yield
    finally:
        _GLOBAL_ROWS.reset(token)


def rand_rows(shape, batch_axis: int, generator: torch.Generator, device
              ) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator``, drawn for the global
    batch along ``batch_axis`` inside ``global_rows`` and cut to this
    rank's rows."""
    rows = _GLOBAL_ROWS.get()
    if rows is None:
        return torch.rand(shape, generator=generator, device=device)
    total, start = rows
    full = list(shape)
    full[batch_axis] = total
    return torch.rand(full, generator=generator, device=device).narrow(
        batch_axis, start, shape[batch_axis])


def dropout_keep(cfg, shape, generator: torch.Generator, device,
                 batch_axis: int = 0) -> torch.Tensor:
    """The train dropout's keep mask (True = kept, with probability
    ``1 - cfg.dropout_rate``), drawn from ``generator`` (``rand_rows``:
    the batch on axis ``batch_axis``)."""
    return (rand_rows(shape, batch_axis, generator, device)
            < 1.0 - cfg.dropout_rate)


def logit_activation(params: Params, cfg, h: torch.Tensor,
                     ctx_t: torch.Tensor, emb: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     train: bool = False,
                     keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (.., dim_word) pre-vocab activation:
    tanh(h W_lstm + b + ctx_t W_ctx [+ emb]), then, in training with
    ``cfg.use_dropout``, inverted dropout with the keep mask ``keep`` or,
    without one, a mask drawn from ``generator`` (which must live on the
    activation's device).  ``emb`` is added raw: a bf16 embedding
    promotes to float32 in the sum, as in JAX."""
    cdtype = compute_dtype(cfg)
    logit = (tp.row_sum([(h, params["ff_logit_lstm_W"]),
                         (ctx_t, params["ff_logit_ctx_W"])], cdtype)
             + params["ff_logit_lstm_b"])
    if cfg.prev_word_logit:
        logit = logit + emb
    logit = torch.tanh(logit)
    if cfg.use_dropout and train:
        if keep is None:
            if generator is None:
                raise ValueError("train dropout requires a generator")
            keep = dropout_keep(cfg, logit.shape, generator, logit.device)
        logit = torch.where(keep, logit / (1.0 - cfg.dropout_rate),
                            torch.zeros_like(logit))
    return logit


def logits_from_states(params: Params, cfg, h: torch.Tensor,
                       ctx_t: torch.Tensor, emb: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       train: bool = False,
                       keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Vocab logits (float32) from the decoder state; leading axes are
    free, so the train path projects all (B, T) states in one product."""
    cdtype = compute_dtype(cfg)
    act = logit_activation(params, cfg, h, ctx_t, emb, generator, train,
                           keep)
    return tp.vocab(act, params["ff_logit_W"], params["ff_logit_b"], cdtype)
