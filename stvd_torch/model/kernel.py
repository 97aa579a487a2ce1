"""The port's CUDA kernels, each beside its plain PyTorch version.

Counterpart of ``stvd/model/kernel.py`` (and of the dWs_att GEMM of
``tools/probe_dws_gemm.py``).  Serving: the temporal-attention core, the
spatial-attention core (preset 2), the fused gates+LSTM step (bf16 or
W8A8 int8, engaged by ``cfg.gates_kernel``) and the fused logit tail.
Training: the spatial backward step (preset 2), the train-scan tail
(``cfg.train_tail_kernel``) and the region projection's weight gradient
``dWs_att = regions^T @ d(pregion)``.  Sources are in
``stvd_torch/csrc``; ``_build`` compiles them for sm_90a on first use.

Each wrapper runs the plain version for tensors on the CPU and launches
its kernel for tensors on a CUDA device, raising on what the kernel does
not take.  Each keeps a plain-integer ``launches`` count that grows by one
per kernel call (a call that takes a second reduction pass, as the logit
tail, the spatial backward step and the dWs_att GEMM do, counts once), so
a run can show that the main path went through the kernels.  The
kernels with more than one route (the attention core: cluster or simple;
the spatial core: tma or simple; the logit tail, the gates+LSTM step,
the train-scan tail and the dWs_att GEMM: wgmma, wmma or float32; the
spatial backward step: 16-byte or element loads) pick it from shapes,
dtype and alignment in a pure function and also count launches by route
in ``launches_by_route``.

Kernels 1-4, the serving kernels, are also custom ops
(``stvd_torch::attention_core``, ``::logit_tail``, ``::spatial_core``,
``::gates_lstm``; CUDA only): while a graph is exported
(``torch.compiler.is_exporting()``, see ``export_aot.py``) their wrappers
call the op instead of launching directly.  The op's implementation is
the wrapper's launch, with its route and its counts, and its fake checks
the shapes and dtypes the kernel takes, so an exported graph holds the
op, an export at shapes the kernel refuses fails at export time, and
every call of the loaded graph launches and counts the kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import step as step_mod
from . import tp
from .. import _build
from ..utils.profiling import spanned


def _launch_stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


_SMEM_LIMIT = 232448     # 227 KB: the most shared memory a block may use
# beams a context row the attention and spatial cores take (csrc:
# kMaxBeams); the custom ops' fakes check it without the library
MAX_BEAMS = 8


def score_chunks(width: int) -> int:
    """The 256-column chunks a score row is cut into for the attention
    cores' TMA routes, rounded up to a power of two (csrc:
    score_chunks)."""
    nq = 1
    while nq * 256 < width:
        nq *= 2
    return nq


# ---------------------------------------------------------------------------
# Kernel 1: temporal-attention core (csrc/attn_core.cu)
# ---------------------------------------------------------------------------

# index = the route's number in csrc/attn_core.cu
ATTENTION_CORE_ROUTES = ("cluster", "simple")


_BEAM_CTAS = 2        # CTAs a row from 3 beams up (csrc: attn_core.cu)
_SM_SMEM = 233472     # shared memory of an SM; each CTA also takes 1 KB
_WIDE = 2048          # A and Dc the eight-warp CTA covers (csrc)


def _cluster_smem(nb: int, kc: int, a: int, dc: int, ctx_bytes: int) -> int:
    """Route 'cluster''s shared memory a CTA (csrc: cluster_smem): the
    mbarrier, the ctx slice of ``kc`` frames or the partial sums of its
    nb beams over it, partial scores, scores and five nb-vectors."""
    return (16 + max(kc * dc * ctx_bytes, 4 * nb * dc)
            + 4 * (nb * kc * (score_chunks(a) + 1) + 5 * nb))


def attention_core_split(k: int, nb: int, a: int = 0, dc: int = 0,
                         ctx_bytes: int = 2) -> Tuple[int, int]:
    """Route 'cluster''s plan for K frames of ``nb`` beams: (CTAs per
    row, frames per CTA).  Up to 4 CTAs a row, frames as even as whole
    frames allow and no CTA empty.  From 3 beams up a CTA holds 2^(C h)
    of every beam in registers (~96 a thread, about 5 CTAs an SM), so 2
    CTAs a row, one wave of ~512 CTAs at a decode batch of 256: K 28 at
    5 beams -> (2, 14); at 1 beam -> (4, 7) - unless that plan's shared
    memory (A, Dc and the ctx element's ``ctx_bytes`` given) leaves room
    for one CTA an SM: preset 4's 14 float32 frames of 2048 (115 KB) take
    4 CTAs of 7 frames instead.

    The plan does not depend on the number of rows: it sets the order in
    which a row's frames are summed, so a row's context, and the beams'
    near-ties that follow from it, are the same whether the row is
    decoded in a batch of 256 or in a data-parallel rank's share of it.
    ``chip_smoke.py --profile`` times every split at the paths' shapes
    (split_ms)."""
    want = min(4, k)
    if nb >= 3:
        few = min(want, _BEAM_CTAS)
        smem = _cluster_smem(nb, -(-k // few), a, dc, ctx_bytes)
        if 2 * (smem + 1024) <= _SM_SMEM:
            want = few
    kc = -(-k // want)
    return -(-k // kc), kc


def attention_core_route(nb: int, k: int, a: int, dc: int, ctx_dtype,
                         pctx_ptr: int, ctx_ptr: int,
                         kc: Optional[int] = None) -> str:
    """The attention core's route, from shapes, dtype and alignment alone:
    'cluster' when A and Dc are multiples of 8 (16-byte rows, whole TMA
    spans) and at most 2048 (four warps a CTA up to 1024 columns, eight
    above; one 256-column score chunk a warp, a thread per 8 columns of
    Dc), pctx and ctx start 16-byte aligned and a CTA's shared memory (its
    ctx slice of ``kc`` frames, by default ``attention_core_split``'s, or
    the partial sums of its nb beams over it) fits; else 'simple'."""
    if (a % 8 or dc % 8 or a > _WIDE or dc > _WIDE or pctx_ptr % 16
            or ctx_ptr % 16):
        return "simple"
    el = 2 if ctx_dtype == torch.bfloat16 else 4
    if kc is None:
        kc = attention_core_split(k, nb, a, dc, el)[1]
    return ("cluster" if _cluster_smem(nb, kc, a, dc, el) <= _SMEM_LIMIT
            else "simple")


def _attention_core_check(h_att, beta_logit, pctx, ctx, ctx_mask, u_att,
                          c_att, b_sel, max_beams: int) -> None:
    """What the attention-core kernel takes: shapes, dtypes, strides and
    one CUDA device (the kernel's wrapper and its custom op's fake both
    check it)."""
    f32 = torch.float32
    bs, a = h_att.shape
    bc, k, a2 = pctx.shape
    _require(a2 == a and ctx.shape[:2] == (bc, k)
             and tuple(ctx_mask.shape) == (bc, k)
             and tuple(u_att.shape) == (a,) and beta_logit.shape == (bs,),
             "attention_core: inconsistent shapes")
    _require(bs % bc == 0 and bs // bc <= max_beams,
             f"attention_core: state batch {bs} is not 1..8 beams of {bc}")
    _require(h_att.dtype == f32 and beta_logit.dtype == f32
             and h_att.stride(1) == 1,
             "attention_core: h_att/beta_logit must be float32 rows")
    _require(pctx.dtype == f32 and ctx.dtype in (f32, torch.bfloat16),
             "attention_core: pctx must be float32, ctx float32 or bf16")
    tensors = (h_att, beta_logit, pctx, ctx, ctx_mask, u_att, c_att, b_sel)
    _require(h_att.is_cuda and all(t.device == h_att.device for t in tensors),
             "attention_core: all operands must be on one CUDA device")


def _attention_core_cuda(h_att, beta_logit, pctx, ctx, ctx_mask, u_att,
                         c_att, b_sel, selector: bool, route=None,
                         splits=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on ``attention_core_route``'s route, or on ``route``
    when given, and route 'cluster' with ``attention_core_split``'s CTAs
    a row or ``splits`` of them (to time one plan against another on the
    same operands)."""
    f32 = torch.float32
    bs, a = h_att.shape
    bc, k, _ = pctx.shape
    dc = ctx.shape[-1]
    lib = _build.lib()
    _attention_core_check(h_att, beta_logit, pctx, ctx, ctx_mask, u_att,
                          c_att, b_sel, lib.stvd_attn_core_max_beams())
    pctx = pctx.contiguous()
    ctx = ctx.contiguous()
    mask = ctx_mask.to(f32).contiguous()
    u = u_att.to(f32).contiguous()
    c_att = c_att.to(f32).reshape(())
    b_sel = b_sel.to(f32).reshape(())
    nb = bs // bc
    kc = (attention_core_split(k, nb, a, dc, ctx.element_size())[1]
          if splits is None else -(-k // splits))
    if route is None:
        route = attention_core_route(nb, k, a, dc, ctx.dtype,
                                     pctx.data_ptr(), ctx.data_ptr(), kc)
    ctx_t = torch.empty((bs, dc), dtype=f32, device=h_att.device)
    alpha = torch.empty((bs, k), dtype=f32, device=h_att.device)
    err = lib.stvd_attn_core(
        h_att.data_ptr(), h_att.stride(0), beta_logit.data_ptr(),
        beta_logit.stride(0), pctx.data_ptr(), ctx.data_ptr(),
        int(ctx.dtype == torch.bfloat16), mask.data_ptr(), u.data_ptr(),
        c_att.data_ptr(), b_sel.data_ptr(), int(bool(selector)),
        ctx_t.data_ptr(), alpha.data_ptr(), bc, nb, k, a, dc,
        ATTENTION_CORE_ROUTES.index(route), kc, _launch_stream())
    _build.check(err, "attention-core kernel")
    attention_core.launches += 1
    attention_core.launches_by_route[route] += 1
    return ctx_t, alpha


@torch.library.custom_op("stvd_torch::attention_core", mutates_args=(),
                         device_types="cuda")
def _attention_core_op(h_att: torch.Tensor, beta_logit: torch.Tensor,
                       pctx: torch.Tensor, ctx: torch.Tensor,
                       ctx_mask: torch.Tensor, u_att: torch.Tensor,
                       c_att: torch.Tensor, b_sel: torch.Tensor,
                       selector: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 1 as an opaque op of an exported graph: the graph holds
    the op, and each call of the loaded graph runs the kernel."""
    return _attention_core_cuda(h_att, beta_logit, pctx, ctx, ctx_mask,
                                u_att, c_att, b_sel, selector)


@_attention_core_op.register_fake
def _(h_att, beta_logit, pctx, ctx, ctx_mask, u_att, c_att, b_sel, selector):
    _attention_core_check(h_att, beta_logit, pctx, ctx, ctx_mask, u_att,
                          c_att, b_sel, MAX_BEAMS)
    bs, k = h_att.shape[0], pctx.shape[1]
    return h_att.new_empty((bs, ctx.shape[-1])), h_att.new_empty((bs, k))


def _attention_core_fwd(h_att, beta_logit, pctx, ctx, ctx_mask, u_att,
                        c_att, b_sel, selector: bool):
    if h_att.device.type == "cpu":
        return step_mod._attention_core(h_att, beta_logit, pctx, ctx,
                                        ctx_mask, u_att, c_att, b_sel,
                                        selector)
    if torch.compiler.is_exporting():
        return _attention_core_op(h_att, beta_logit, pctx, ctx, ctx_mask,
                                  u_att, c_att, b_sel, selector)
    return _attention_core_cuda(h_att, beta_logit, pctx, ctx, ctx_mask,
                                u_att, c_att, b_sel, selector)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _plain_vjp(ctx, plain, inputs, grads):
    """The cotangents of ``inputs`` (those ``ctx.needs_input_grad``
    marks; None for the rest) of ``plain(*inputs)`` against ``grads``,
    each cast to its input's dtype: the plain version is run again with
    autograd and differentiated."""
    want = [i for i, t in enumerate(inputs)
            if ctx.needs_input_grad[i] and t is not None]
    res = [None] * len(inputs)
    if not want:
        return res
    leaves = [t.detach().requires_grad_(i in want) if t is not None else t
              for i, t in enumerate(inputs)]
    with torch.enable_grad():
        out = plain(*leaves)
    got = torch.autograd.grad(out, [leaves[i] for i in want], grads,
                              allow_unused=True)
    for i, gr in zip(want, got):
        res[i] = (torch.zeros_like(inputs[i]) if gr is None
                  else gr.to(inputs[i].dtype))
    return res


class AttentionCore(torch.autograd.Function):
    """Kernel 1 under a gradient (the JAX package's ``_core_diff``
    custom VJP).  Forward: the kernel for CUDA tensors, the plain version
    for CPU tensors, with autograd off; only the inputs are saved.
    Backward: the plain version run again with autograd, and its VJP.
    There is no backward kernel, as the JAX package has none.  Gradients
    go to h_att, beta_logit, pctx, ctx, U_att, c_att and b_sel, each in
    its input's dtype; ``ctx_mask`` gets none."""

    @staticmethod
    def forward(ctx, h_att, beta_logit, pctx, ctx_, ctx_mask, u_att, c_att,
                b_sel, selector):
        ctx.save_for_backward(h_att, beta_logit, pctx, ctx_, ctx_mask,
                              u_att, c_att, b_sel)
        ctx.selector = selector
        return _attention_core_fwd(h_att, beta_logit, pctx, ctx_, ctx_mask,
                                   u_att, c_att, b_sel, selector)

    @staticmethod
    def backward(ctx, g_ctx, g_alpha):
        ins = ctx.saved_tensors
        mask, sel = ins[4], ctx.selector

        def plain(h, beta, pctx, ctx_, _mask, u, c_att, b_sel):
            return step_mod._attention_core(h, beta, pctx, ctx_, mask, u,
                                            c_att, b_sel, sel)

        grads = _plain_vjp(ctx, plain, ins, (g_ctx, g_alpha))
        grads[4] = None
        return (*grads, None)


@spanned("stvd.kernel.attention_core")
def attention_core(h_att, beta_logit, pctx, ctx, ctx_mask, u_att, c_att,
                   b_sel, selector: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``step._attention_core`` (same contract, beam
    broadcast over an un-tiled context).  CPU tensors take the plain
    version; CUDA tensors take the kernel on the route
    ``attention_core_route`` picks.  When a gradient must pass, the call
    goes through ``AttentionCore``, whose backward is the plain
    version's VJP."""
    args = (h_att, beta_logit, pctx, ctx, ctx_mask, u_att, c_att, b_sel)
    if _needs_grad(*args):
        return AttentionCore.apply(*args, selector)
    return _attention_core_fwd(*args, selector)


attention_core.launches = 0
attention_core.launches_by_route = dict.fromkeys(ATTENTION_CORE_ROUTES, 0)


# ---------------------------------------------------------------------------
# Kernel 2: fused logit tail (csrc/logit_tail.cu)
# ---------------------------------------------------------------------------

def _logit_tail_plain(x, w, b, k_sel: int):
    """(vals (rows, k), idx (rows, k) int64, lse (rows,)) of the float32
    logits ``x @ w + b``, x rounded to w's dtype first."""
    logits = step_mod._dot(x, w, w.dtype) + b.to(torch.float32)
    vals, idx = step_mod.topk_rows(logits, k_sel)
    return vals, idx, torch.logsumexp(logits, dim=-1)


# index = the route's number in csrc/logit_tail.cu
LOGIT_TAIL_ROUTES = ("wgmma", "wmma", "f32")


def logit_tail_route(rows: int, dw: int, v: int, dtype, x_ptr: int,
                     w_ptr: int, ldx: Optional[int] = None,
                     ldw: Optional[int] = None) -> str:
    """The logit tail's route, from shapes, strides, dtype and alignment
    alone: 'f32' for float32 operands; for bf16 'wgmma' (TMA tiles need
    row strides of whole 16 bytes and 16-byte aligned bases) when the
    row strides of x and W, ``ldx`` and ``ldw`` (default dw and V: dense
    rows), are multiples of 8 and both bases are aligned, else 'wmma'.
    A ragged dw or V takes wgmma from rows padded to 128 bytes
    (``step.pad_cols``)."""
    if dtype == torch.float32:
        return "f32"
    ldx = dw if ldx is None else ldx
    ldw = v if ldw is None else ldw
    if ldx % 8 == 0 and ldw % 8 == 0 and x_ptr % 16 == 0 and w_ptr % 16 == 0:
        return "wgmma"
    return "wmma"


def _logit_tail_check(x, w, b, k_sel: int) -> None:
    """What the logit-tail kernel takes (checked by its wrapper and by
    its custom op's fake)."""
    dw = x.shape[1]
    v = w.shape[1]
    _require(1 <= k_sel <= 8, f"logit_tail: k_sel={k_sel} outside 1..8")
    _require(w.shape[0] == dw and tuple(b.shape) == (v,),
             "logit_tail: inconsistent shapes")
    _require(w.dtype in (torch.float32, torch.bfloat16),
             "logit_tail: W must be float32 or bf16")
    _require(x.is_cuda and x.device == w.device == b.device,
             "logit_tail: all operands must be on one CUDA device")
    _require(v >= k_sel, f"logit_tail: vocab {v} smaller than k={k_sel}")


def _logit_tail_cuda(x, w, b, k_sel: int, route=None):
    """The kernel on ``logit_tail_route``'s route, or on ``route`` when
    given (to time one route against another on the same operands).
    Operands may be row-strided (``stride(1) == 1``), and their strides
    pick the route: W as it comes (a ragged vocab takes wgmma when its
    rows are padded, as ``make_logit_tail`` pads them once a decode
    call), x as it comes in W's dtype, else cast into rows padded to 128
    bytes, the copy the cast makes anyway."""
    rows, dw = x.shape
    v = w.shape[1]
    lib = _build.lib()
    _logit_tail_check(x, w, b, k_sel)
    if x.dtype != w.dtype:
        x = step_mod.padded(rows, dw, w.dtype, x.device).copy_(x)
    elif x.stride(1) != 1:
        x = x.contiguous()
    if w.stride(1) != 1:
        w = w.contiguous()
    b = b.to(torch.float32).contiguous()
    if route is None:
        route = logit_tail_route(rows, dw, v, w.dtype, x.data_ptr(),
                                 w.data_ptr(), x.stride(0), w.stride(0))
    code = LOGIT_TAIL_ROUTES.index(route)
    nt = lib.stvd_logit_tail_ntiles(v, code)
    dev = x.device
    f32 = torch.float32
    part_m = torch.empty((rows, nt), dtype=f32, device=dev)
    part_s = torch.empty((rows, nt), dtype=f32, device=dev)
    part_v = torch.empty((rows, nt, k_sel), dtype=f32, device=dev)
    part_i = torch.empty((rows, nt, k_sel), dtype=torch.int32, device=dev)
    vals = torch.empty((rows, k_sel), dtype=f32, device=dev)
    idx = torch.empty((rows, k_sel), dtype=torch.int64, device=dev)
    lse = torch.empty((rows,), dtype=f32, device=dev)
    err = lib.stvd_logit_tail(
        x.data_ptr(), w.data_ptr(), code, b.data_ptr(), part_m.data_ptr(),
        part_s.data_ptr(), part_v.data_ptr(), part_i.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), lse.data_ptr(), rows, dw, v, k_sel,
        x.stride(0), w.stride(0), _launch_stream())
    _build.check(err, "logit-tail kernel")
    logit_tail.launches += 1
    logit_tail.launches_by_route[route] += 1
    return vals, idx, lse


@torch.library.custom_op("stvd_torch::logit_tail", mutates_args=(),
                         device_types="cuda")
def _logit_tail_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   k_sel: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 2 as an opaque op of an exported graph."""
    return _logit_tail_cuda(x, w, b, k_sel)


@_logit_tail_op.register_fake
def _(x, w, b, k_sel):
    _logit_tail_check(x, w, b, k_sel)
    rows = x.shape[0]
    f32 = torch.float32
    return (x.new_empty((rows, k_sel), dtype=f32),
            x.new_empty((rows, k_sel), dtype=torch.int64),
            x.new_empty((rows,), dtype=f32))


@spanned("stvd.kernel.logit_tail")
def logit_tail(x, w, b, k_sel: int):
    """Activation (rows, dw) -> (top-k raw logits, their vocab ids,
    logsumexp per row); top-k log-probs are ``vals - lse[:, None]``.
    CPU tensors take the plain version; CUDA tensors take the kernel on
    the route ``logit_tail_route`` picks, through its custom op while a
    graph is exported."""
    if k_sel < 1 or k_sel > 8:
        raise ValueError(f"logit_tail: k_sel={k_sel} outside 1..8")
    if x.device.type == "cpu":
        return _logit_tail_plain(x, w, b, k_sel)
    if torch.compiler.is_exporting():
        return _logit_tail_op(x, w, b, k_sel)
    return _logit_tail_cuda(x, w, b, k_sel)


logit_tail.launches = 0
logit_tail.launches_by_route = dict.fromkeys(LOGIT_TAIL_ROUTES, 0)


def make_logit_tail(w, b, k_sel: int):
    """The fused logit-tail closure for the decode loops, built once per
    decode call (mirror of the JAX ``make_logit_tail``), or ``None`` when
    ``k_sel > 8``: the kernel keeps at most eight candidates a row, and
    the caller then takes the materialized logits, as the JAX package's
    callers do.  W's rows are padded to 128 bytes here, once a decode
    call (``step.pad_cols``: a copy only for a ragged vocab, 12 MB at the
    reference recipes' 468 x 13010 in bf16), so the kernel's wgmma route
    reads them; columns past the vocab are masked inside the kernel."""
    if k_sel > 8:
        return None
    w = step_mod.pad_cols(w)
    b = b.to(torch.float32)

    def tail(act):
        return logit_tail(act, w, b, k_sel)

    return tail


# ---------------------------------------------------------------------------
# Kernel 4: spatial-attention core (csrc/spatial_core.cu)
# ---------------------------------------------------------------------------

# index = the route's number in csrc/spatial_core.cu
SPATIAL_CORE_ROUTES = ("tma", "simple")


def spatial_core_frames(k: int) -> int:
    """Route 'tma''s frames per block: at most 7, as even as whole frames
    allow (K 28 -> 7, four blocks a context row)."""
    return -(-k // -(-k // 7))


def spatial_core_route(nb: int, r: int, s: int, dr: int, regions_dtype,
                       pregion_ptr: int, regions_ptr: int) -> str:
    """The spatial core's route, from shapes, dtype and alignment alone:
    'tma' when s and Dr are multiples of 8 (16-byte rows, whole TMA
    spans), s <= 2048 (eight warps, one 256-column chunk each), pregion
    and regions start 16-byte aligned and a frame's regions slab with the
    block's partial scores fits shared memory; else 'simple'."""
    if (s % 8 or dr % 8 or s > 2048 or pregion_ptr % 16
            or regions_ptr % 16):
        return "simple"
    el = 2 if regions_dtype == torch.bfloat16 else 4
    smem = 16 + r * dr * el + 4 * nb * r * (score_chunks(s) + 1)
    return "tma" if smem <= _SMEM_LIMIT else "simple"


def _spatial_core_check(h_satt, pregion, regions, u_s, c_s,
                        max_beams: int) -> None:
    """What the spatial-core kernel takes (checked by its wrapper and by
    its custom op's fake)."""
    f32 = torch.float32
    bs, s = h_satt.shape
    bc, k, r, s2 = pregion.shape
    _require(s2 == s and tuple(regions.shape[:3]) == (bc, k, r)
             and tuple(u_s.shape) == (s,),
             "spatial_core: inconsistent shapes")
    _require(bs % bc == 0 and bs // bc <= max_beams,
             f"spatial_core: state batch {bs} is not 1..8 beams of {bc}")
    _require(h_satt.dtype == f32 and h_satt.stride(1) == 1,
             "spatial_core: h_satt must be float32 rows")
    _require(pregion.dtype == f32
             and regions.dtype in (f32, torch.bfloat16),
             "spatial_core: pregion must be float32, regions float32 or bf16")
    tensors = (h_satt, pregion, regions, u_s, c_s)
    _require(h_satt.is_cuda and all(t.device == h_satt.device
                                    for t in tensors),
             "spatial_core: all operands must be on one CUDA device")


def _spatial_core_cuda(h_satt, pregion, regions, u_s, c_s, route=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on ``spatial_core_route``'s route, or on ``route`` when
    given (to time one route against another on the same operands)."""
    f32 = torch.float32
    bs, s = h_satt.shape
    bc, k, r, _ = pregion.shape
    dr = regions.shape[-1]
    lib = _build.lib()
    _spatial_core_check(h_satt, pregion, regions, u_s, c_s,
                        lib.stvd_spatial_core_max_beams())
    nb = bs // bc
    pregion = pregion.contiguous()
    regions = regions.contiguous()
    u = u_s.to(f32).contiguous()
    c_s = c_s.to(f32).reshape(())
    if route is None:
        route = spatial_core_route(nb, r, s, dr, regions.dtype,
                                   pregion.data_ptr(), regions.data_ptr())
    spat = torch.empty((bc, nb, k, dr), dtype=f32, device=h_satt.device)
    alpha = torch.empty((bc, nb, k, r), dtype=f32, device=h_satt.device)
    err = lib.stvd_spatial_core(
        h_satt.data_ptr(), h_satt.stride(0), pregion.data_ptr(),
        regions.data_ptr(), int(regions.dtype == torch.bfloat16),
        u.data_ptr(), c_s.data_ptr(), spat.data_ptr(), alpha.data_ptr(),
        bc, nb, k, r, s, dr, SPATIAL_CORE_ROUTES.index(route),
        spatial_core_frames(k), _launch_stream())
    _build.check(err, "spatial-core kernel")
    spatial_core.launches += 1
    spatial_core.launches_by_route[route] += 1
    return spat, alpha


@torch.library.custom_op("stvd_torch::spatial_core", mutates_args=(),
                         device_types="cuda")
def _spatial_core_op(h_satt: torch.Tensor, pregion: torch.Tensor,
                     regions: torch.Tensor, u_s: torch.Tensor,
                     c_s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 4 as an opaque op of an exported graph."""
    return _spatial_core_cuda(h_satt, pregion, regions, u_s, c_s)


@_spatial_core_op.register_fake
def _(h_satt, pregion, regions, u_s, c_s):
    _spatial_core_check(h_satt, pregion, regions, u_s, c_s, MAX_BEAMS)
    bc, k, r, _ = pregion.shape
    nb = h_satt.shape[0] // bc
    return (h_satt.new_empty((bc, nb, k, regions.shape[-1])),
            h_satt.new_empty((bc, nb, k, r)))


def _spatial_core_fwd(h_satt, pregion, regions, u_s, c_s, cdtype):
    if h_satt.device.type == "cpu":
        return step_mod._spatial_core(h_satt, pregion, regions, u_s, c_s,
                                      cdtype)
    if torch.compiler.is_exporting():
        return _spatial_core_op(h_satt, pregion, regions, u_s, c_s)
    return _spatial_core_cuda(h_satt, pregion, regions, u_s, c_s)


class SpatialCore(torch.autograd.Function):
    """Kernel 4 under a gradient (the JAX package's ``_spatial_diff``
    custom VJP).  Forward: the kernel for CUDA tensors, the plain version
    for CPU tensors, with autograd off; only the inputs are saved.
    Backward: the plain version run again with autograd at float32 (as
    JAX's ``_spatial_bwd`` runs its oracle), and its VJP.  There is no
    backward kernel, as the JAX package has none.  Gradients go to
    h_satt, pregion, regions, Us_att and cs_att, each in its input's
    dtype."""

    @staticmethod
    def forward(ctx, h_satt, pregion, regions, u_s, c_s, cdtype):
        ctx.save_for_backward(h_satt, pregion, regions, u_s, c_s)
        return _spatial_core_fwd(h_satt, pregion, regions, u_s, c_s, cdtype)

    @staticmethod
    def backward(ctx, g_spat, g_alpha):
        def plain(h, pre, reg, u, c):
            return step_mod._spatial_core(h, pre, reg, u, c, torch.float32)

        return (*_plain_vjp(ctx, plain, ctx.saved_tensors,
                            (g_spat, g_alpha)), None)


@spanned("stvd.kernel.spatial_core")
def spatial_core(h_satt, pregion, regions, u_s, c_s, cdtype
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``step._spatial_core`` (same contract, beam broadcast
    over an un-tiled region bank).  CPU tensors take the plain version;
    CUDA tensors take the kernel on the route ``spatial_core_route``
    picks, whose sums are float32 whatever ``cdtype`` (bf16 regions are
    upcast in registers) and whose ``spat`` is float32.  When a gradient
    must pass, the call goes through ``SpatialCore``, whose backward is
    the plain version's VJP."""
    args = (h_satt, pregion, regions, u_s, c_s)
    if _needs_grad(*args):
        return SpatialCore.apply(*args, cdtype)
    return _spatial_core_fwd(*args, cdtype)


spatial_core.launches = 0
spatial_core.launches_by_route = dict.fromkeys(SPATIAL_CORE_ROUTES, 0)


# ---------------------------------------------------------------------------
# Kernel 3: fused gates + LSTM step (csrc/gates_lstm.cu)
# ---------------------------------------------------------------------------

_GATES_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# index = the route's number in csrc/gates_lstm.cu
GATES_ROUTES = ("wgmma", "wmma", "f32")


def gates_route(rows: int, kx: int, dim: int, dtype, x_ptr: int,
                w_ptr: int, ldx: Optional[int] = None,
                ldw: Optional[int] = None) -> str:
    """The gates+LSTM kernel's route, from shapes, strides, dtype and
    alignment alone: 'f32' for float32 operands; 'wgmma' for bf16 and
    int8 when TMA can describe x and the stack's K-major (4 dim, Kx)
    transpose, which that route reads: their row strides ``ldx`` and
    ``ldw`` (default Kx: dense rows) whole 16 bytes and both bases
    16-byte aligned.  A gate's block starts at a row of the transpose,
    so any dim is served; a Kx off the 16-byte grid takes wgmma from
    rows padded to it (``step.padded``, ``step.kmajor``).  Else 'wmma'.
    ``w_ptr`` is the address of the transpose."""
    if dtype == torch.float32:
        return "f32"
    per = 16 // dtype.itemsize
    ldx = kx if ldx is None else ldx
    ldw = kx if ldw is None else ldw
    if x_ptr % 16 or w_ptr % 16 or ldx % per or ldw % per:
        return "wmma"
    return "wgmma"


def _gates_lstm_check(x, w, b, c, s_r, scale) -> None:
    """What the gates+LSTM kernel takes (checked by its wrapper and by
    its custom op's fake)."""
    rows, kx = x.shape
    n4 = w.shape[1]
    dim = n4 // 4
    _require(w.shape[0] == kx and n4 == 4 * dim and dim > 0
             and tuple(b.shape) == (n4,) and tuple(c.shape) == (rows, dim),
             "gates_lstm: inconsistent shapes")
    _require(w.dtype in _GATES_MODES and x.dtype == w.dtype,
             "gates_lstm: x and w must both be float32, bf16 or int8")
    quant = w.dtype == torch.int8
    _require(not quant or (s_r is not None and scale is not None
                           and s_r.numel() == rows
                           and tuple(scale.shape) == (n4,)),
             "gates_lstm: int8 operands need row and column scales")
    tensors = [x, w, b, c] + ([s_r, scale] if quant else [])
    _require(x.is_cuda and all(t.device == x.device for t in tensors),
             "gates_lstm: all operands must be on one CUDA device")


def _gates_lstm_cuda(x, w, b, c, s_r=None, scale=None, route=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel on ``gates_route``'s route, or on ``route`` when given
    (to time one route against another on the same operands).  The wgmma
    route reads x and the stack's K-major transpose, each in rows a whole
    16 bytes apart: x's strides pick the route (``step_with_core`` and
    ``step.quantize_rows`` pad its rows to 128 bytes), and a stack not
    stored so (as ``step.precompute`` and ``step.quantize_weights`` store
    it, when this is a view) is copied to it.  The wmma and f32 routes
    read dense x and the dense (Kx, 4 dim) stack."""
    f32 = torch.float32
    rows, kx = x.shape
    n4 = w.shape[1]
    dim = n4 // 4
    lib = _build.lib()
    _gates_lstm_check(x, w, b, c, s_r, scale)
    quant = w.dtype == torch.int8
    if route in (None, "wgmma"):
        x_read = x if x.stride(1) == 1 else x.contiguous()
        w_read = step_mod.pad_cols(w.t())
        if route is None:
            route = gates_route(rows, kx, dim, w.dtype, x_read.data_ptr(),
                                w_read.data_ptr(), x_read.stride(0),
                                w_read.stride(0))
    if route == "wgmma":
        ldx, ldw = x_read.stride(0), w_read.stride(0)
    else:
        x_read, w_read = x.contiguous(), w.contiguous()
        ldx, ldw = kx, n4
    b = b.to(f32).contiguous()
    c = c.to(f32).contiguous()
    if quant:
        s_r = s_r.to(f32).reshape(rows).contiguous()
        scale = scale.to(f32).contiguous()
    else:
        s_r = scale = b                  # not read outside int8 mode
    h_t = torch.empty((rows, dim), dtype=f32, device=x.device)
    c_t = torch.empty((rows, dim), dtype=f32, device=x.device)
    err = lib.stvd_gates_lstm(
        x_read.data_ptr(), w_read.data_ptr(), _GATES_MODES[w.dtype],
        GATES_ROUTES.index(route), b.data_ptr(), s_r.data_ptr(),
        scale.data_ptr(), c.data_ptr(), h_t.data_ptr(), c_t.data_ptr(), rows,
        kx, dim, ldx, ldw, _launch_stream())
    _build.check(err, "gates+LSTM kernel")
    gates_lstm.launches += 1
    gates_lstm.launches_by_route[route] += 1
    return h_t, c_t


@torch.library.custom_op("stvd_torch::gates_lstm", mutates_args=(),
                         device_types="cuda")
def _gates_lstm_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, s_r: Optional[torch.Tensor],
                   scale: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 3 as an opaque op of an exported graph."""
    return _gates_lstm_cuda(x, w, b, c, s_r, scale)


@_gates_lstm_op.register_fake
def _(x, w, b, c, s_r, scale):
    _gates_lstm_check(x, w, b, c, s_r, scale)
    shape = (x.shape[0], w.shape[1] // 4)
    f32 = torch.float32
    return x.new_empty(shape, dtype=f32), x.new_empty(shape, dtype=f32)


@spanned("stvd.kernel.gates_lstm")
def gates_lstm(x, w, b, c, s_r=None, scale=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop-in for ``step._gates_lstm``: (h_t, c_t) from the row block
    ``x`` and the gates stack ``w`` (float32, bf16, or int8 with its row
    and column scales), the (rows, 4 dim) preactivation never leaving the
    kernel.  CPU tensors take the plain version; CUDA tensors take the
    kernel on the route ``gates_route`` picks, which masks ragged rows,
    depths and dims itself (through its custom op while a graph is
    exported)."""
    if x.device.type == "cpu":
        return step_mod._gates_lstm(x, w, b, c, s_r, scale)
    if torch.compiler.is_exporting():
        return _gates_lstm_op(x, w, b, c, s_r, scale)
    return _gates_lstm_cuda(x, w, b, c, s_r, scale)


gates_lstm.launches = 0
gates_lstm.launches_by_route = dict.fromkeys(GATES_ROUTES, 0)


# ---------------------------------------------------------------------------
# Kernel 6: train-scan tail (csrc/train_tail.cu)
# ---------------------------------------------------------------------------

def _train_tail_plain(ctx_t, x_pre_t, h_gates, c, wc, cdtype
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One train-scan step's tail: preact = (x_pre_t + h_gates) + ctx_t @
    Wc (row-parallel under a model axis, ``tp.row``), then the LSTM
    pointwise.  Returns (h_t, c_t, preact), float32."""
    preact = x_pre_t + h_gates + tp.row(ctx_t, wc, cdtype)
    return (*step_mod.lstm_update(preact, c), preact)


# index = the route's number in csrc/train_tail.cu
TRAIN_TAIL_ROUTES = ("wgmma", "wmma", "f32")


def train_tail_route(rows: int, dc: int, dim: int, dtype, x_ptr: int,
                     w_ptr: int) -> str:
    """The train-scan tail kernel's route, from shapes, dtype and
    alignment alone: 'f32' for float32 operands; 'wgmma' for bf16 when
    TMA can describe ctx_t and Wc: dc and dim multiples of 8 (rows of
    whole 16 bytes, and each gate's column block g dim + d0 of Wc
    starting on a 16-byte boundary), 16-byte aligned bases ``x_ptr`` and
    ``w_ptr``; else 'wmma'."""
    if dtype == torch.float32:
        return "f32"
    if x_ptr % 16 or w_ptr % 16 or dc % 8 or dim % 8:
        return "wmma"
    return "wgmma"


def _train_tail_cuda(ctx_t, x_pre_t, h_gates, c, wc, cdtype, route=None):
    """The kernel on ``train_tail_route``'s route, or on ``route`` when
    given (to time one route against another on the same operands)."""
    f32 = torch.float32
    rows, dc = ctx_t.shape
    n4 = wc.shape[1]
    dim = n4 // 4
    dev = ctx_t.device
    _require(wc.shape[0] == dc and n4 == 4 * dim and dim > 0
             and x_pre_t.shape == (rows, n4) and h_gates.shape == (rows, n4)
             and c.shape == (rows, dim),
             "train_tail: inconsistent shapes")
    _require(cdtype in (f32, torch.bfloat16),
             "train_tail: compute dtype must be float32 or bf16")
    _require(x_pre_t.dtype == f32 and h_gates.dtype == f32
             and x_pre_t.stride(1) == 1 and h_gates.stride(1) == 1,
             "train_tail: x_pre and h_gates must be float32 rows")
    _require(dev.type == "cuda" and x_pre_t.device == dev
             and h_gates.device == dev and c.device == dev
             and wc.device == dev,
             "train_tail: all operands must be on one CUDA device")
    x = ctx_t.to(cdtype).contiguous()
    w = wc.to(cdtype).contiguous()
    c = c.to(f32).contiguous()
    if route is None:
        route = train_tail_route(rows, dc, dim, cdtype, x.data_ptr(),
                                 w.data_ptr())
    _require((route == "f32") == (cdtype == f32),
             f"train_tail: route {route} does not take {cdtype}")
    # one allocation for the three outputs: pre (rows, 4 dim), h_t, c_t
    out = torch.empty(rows * 6 * dim, dtype=f32, device=dev)
    pre = out[:rows * n4].view(rows, n4)
    h_t = out[rows * n4:rows * 5 * dim].view(rows, dim)
    c_t = out[rows * 5 * dim:].view(rows, dim)
    err = _build.lib().stvd_train_tail(
        x.data_ptr(), w.data_ptr(), TRAIN_TAIL_ROUTES.index(route),
        x_pre_t.data_ptr(), x_pre_t.stride(0), h_gates.data_ptr(),
        h_gates.stride(0), c.data_ptr(), h_t.data_ptr(), c_t.data_ptr(),
        pre.data_ptr(), rows, dc, dim, _launch_stream())
    _build.check(err, "train-tail kernel")
    train_tail.launches += 1
    train_tail.launches_by_route[route] += 1
    return h_t, c_t, pre


@spanned("stvd.kernel.train_tail")
def train_tail(ctx_t, x_pre_t, h_gates, c, wc, cdtype
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(h_t, c_t, preact) of one train-scan step, the preactivation kept
    for the hand-derived backward.  CPU tensors take the plain version;
    CUDA tensors take the kernel on the route ``train_tail_route`` picks,
    which masks ragged rows and widths itself."""
    if ctx_t.device.type == "cpu":
        return _train_tail_plain(ctx_t, x_pre_t, h_gates, c, wc, cdtype)
    return _train_tail_cuda(ctx_t, x_pre_t, h_gates, c, wc, cdtype)


train_tail.launches = 0
train_tail.launches_by_route = dict.fromkeys(TRAIN_TAIL_ROUTES, 0)


# ---------------------------------------------------------------------------
# Kernel 5: spatial backward step (csrc/spatial_bwd.cu)
# ---------------------------------------------------------------------------

SPATIAL_BWD_ROUTES = ("vector", "element")


def spatial_bwd_route(s: int, dr: int, cdtype, ptrs) -> str:
    """Kernel 5's load route, from widths, dtype and alignment alone:
    'vector' (16-byte loads) when s and Dr are whole 16-byte vectors of
    the compute dtype and every streamed operand (pregion, regions, Dpe,
    spat_prev; addresses in ``ptrs``) starts 16-byte aligned, else
    'element'."""
    per_vec = 16 // cdtype.itemsize
    if s % per_vec == 0 and dr % per_vec == 0 and all(p % 16 == 0
                                                       for p in ptrs):
        return "vector"
    return "element"


def _spatial_bwd_plain(h_satt, pregion_c, regions_c, alpha_s, alpha_prev,
                       dspat, u_s, dpe_acc):
    """One reverse step of the spatial stage at nb = 1, in the compute
    dtype of ``pregion_c`` / ``regions_c`` with float32 sums (the Pallas
    kernel's contract).  Adds this step's pregion cotangent into
    ``dpe_acc`` (B, K, R, s) in place and returns (dh_satt (B, s) f32,
    du_s (s,) f32, dss (B, K, R) f32, spat_prev (B, K, Dr) compute dtype),
    ``spat_prev`` being the previous step's attended regions."""
    cd = pregion_c.dtype
    f32 = torch.float32
    e_s = torch.tanh(pregion_c + h_satt.to(cd)[:, None, None, :])
    dalpha = torch.einsum("bkrd,bkd->bkr", regions_c.to(f32),
                          dspat.to(f32))
    al = alpha_s.to(f32)
    dss = al * (dalpha - (al * dalpha).sum(dim=-1, keepdim=True))
    du = torch.einsum("bkr,bkrd->d", dss, e_s.to(f32))
    dpe = (dss[..., None] * u_s.to(f32)).to(cd) * (1.0 - e_s * e_s)
    dpe_acc.add_(dpe.to(dpe_acc.dtype))
    dh = dpe.to(f32).sum(dim=(1, 2))
    # bf16 operands are exact in float32: float32 sums, one rounding
    spat_prev = torch.einsum("bkr,bkrd->bkd", alpha_prev.to(cd).to(f32),
                             regions_c.to(f32)).to(cd)
    return dh, du, dss, spat_prev


def _spatial_bwd_cuda(h_satt, pregion_c, regions_c, alpha_s, alpha_prev,
                      dspat, u_s, dpe_acc):
    f32, bf16 = torch.float32, torch.bfloat16
    b, k, r, s = pregion_c.shape
    dr = regions_c.shape[-1]
    cd = pregion_c.dtype
    _require(tuple(h_satt.shape) == (b, s)
             and tuple(regions_c.shape[:3]) == (b, k, r)
             and tuple(alpha_s.shape) == (b, k, r)
             and tuple(alpha_prev.shape) == (b, k, r)
             and tuple(dspat.shape) == (b, k, dr)
             and tuple(u_s.shape) == (s,)
             and tuple(dpe_acc.shape) == (b, k, r, s),
             "spatial_bwd: inconsistent shapes")
    _require(cd in (f32, bf16) and regions_c.dtype == cd,
             "spatial_bwd: pregion and regions must share float32 or bf16")
    _require(dpe_acc.dtype in (f32, bf16) and (cd == bf16
                                               or dpe_acc.dtype == f32),
             "spatial_bwd: the accumulator is float32, or bf16 under bf16")
    _require(dpe_acc.is_contiguous(),
             "spatial_bwd: the accumulator must be contiguous (in place)")
    tensors = (h_satt, pregion_c, regions_c, alpha_s, alpha_prev, dspat,
               u_s, dpe_acc)
    _require(h_satt.is_cuda and all(t.device == h_satt.device
                                    for t in tensors),
             "spatial_bwd: all operands must be on one CUDA device")
    dev = h_satt.device
    h = h_satt.to(f32).contiguous()
    pre = pregion_c.contiguous()
    reg = regions_c.contiguous()
    spat_prev = torch.empty((b, k, dr), dtype=cd, device=dev)
    route = spatial_bwd_route(s, dr, cd, (pre.data_ptr(), reg.data_ptr(),
                                          dpe_acc.data_ptr(),
                                          spat_prev.data_ptr()))
    al = alpha_s.to(f32).contiguous()
    alp = alpha_prev.to(f32).contiguous()
    dsp = dspat.to(f32).contiguous()
    u = u_s.to(f32).contiguous()
    parts = torch.empty((2, b * k, s), dtype=f32, device=dev)
    du_b = torch.empty((b, s), dtype=f32, device=dev)
    dh = torch.empty((b, s), dtype=f32, device=dev)
    du = torch.empty((s,), dtype=f32, device=dev)
    dss = torch.empty((b, k, r), dtype=f32, device=dev)
    err = _build.lib().stvd_spatial_bwd(
        h.data_ptr(), pre.data_ptr(), reg.data_ptr(), int(cd == bf16),
        al.data_ptr(), alp.data_ptr(), dsp.data_ptr(), u.data_ptr(),
        dpe_acc.data_ptr(), int(dpe_acc.dtype == bf16), parts[0].data_ptr(),
        parts[1].data_ptr(), du_b.data_ptr(), dh.data_ptr(), du.data_ptr(),
        dss.data_ptr(), spat_prev.data_ptr(), b, k, r, s, dr,
        int(route == "vector"), _launch_stream())
    _build.check(err, "spatial-backward kernel")
    spatial_bwd.launches += 1
    spatial_bwd.launches_by_route[route] += 1
    return dh, du, dss, spat_prev


@spanned("stvd.kernel.spatial_bwd")
def spatial_bwd(h_satt, pregion_c, regions_c, alpha_s, alpha_prev, dspat,
                u_s, dpe_acc):
    """The spatial sequence VJP's reverse step (contract of
    ``_spatial_bwd_plain``): ``dpe_acc`` is updated in place.  CPU tensors
    take the plain version; CUDA tensors take the kernel, whose per-block
    partial sums are reduced in a fixed order (no atomics)."""
    if h_satt.device.type == "cpu":
        return _spatial_bwd_plain(h_satt, pregion_c, regions_c, alpha_s,
                                  alpha_prev, dspat, u_s, dpe_acc)
    return _spatial_bwd_cuda(h_satt, pregion_c, regions_c, alpha_s,
                             alpha_prev, dspat, u_s, dpe_acc)


spatial_bwd.launches = 0
spatial_bwd.launches_by_route = dict.fromkeys(SPATIAL_BWD_ROUTES, 0)


# ---------------------------------------------------------------------------
# Kernel 7: dWs_att GEMM (csrc/dws_gemm.cu) and the region projection
# ---------------------------------------------------------------------------

def _dws_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T @ b, (N, Dr) x (N, s) -> (Dr, s) float32, operands in their
    (shared) dtype."""
    return step_mod._dot(a.t(), b, a.dtype)


# index = the route's number in csrc/dws_gemm.cu
DWS_ROUTES = ("wgmma", "mma", "f32")


def dws_route(n: int, dr: int, s: int, dtype, a_ptr: int, b_ptr: int
              ) -> str:
    """The dWs_att GEMM's route, from shapes, dtype and alignment alone:
    'f32' for float32 operands; for bf16 'wgmma' (TMA tiles need row
    strides of whole 16 bytes, 16-byte aligned bases and int32 row
    coordinates) when Dr and s are multiples of 8 and both bases are
    aligned, else 'mma'."""
    if dtype == torch.float32:
        return "f32"
    if (dr % 8 == 0 and s % 8 == 0 and a_ptr % 16 == 0 and b_ptr % 16 == 0
            and n < 2 ** 31):
        return "wgmma"
    return "mma"


def _dws_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    f32, bf16 = torch.float32, torch.bfloat16
    n, dr = a.shape
    s = b.shape[1]
    _require(b.shape[0] == n, "dws_gemm: a and b must share their rows")
    _require(a.dtype == b.dtype and a.dtype in (f32, bf16),
             "dws_gemm: operands must both be float32 or bf16")
    _require(a.is_cuda and b.device == a.device,
             "dws_gemm: operands must be on one CUDA device")
    lib = _build.lib()
    a = a.contiguous()
    b = b.contiguous()
    route = dws_route(n, dr, s, a.dtype, a.data_ptr(), b.data_ptr())
    code = DWS_ROUTES.index(route)
    splits = lib.stvd_dws_splits(n, dr, s, code)
    part = torch.empty((splits, dr, s), dtype=f32, device=a.device)
    out = torch.empty((dr, s), dtype=f32, device=a.device)
    err = lib.stvd_dws_gemm(a.data_ptr(), b.data_ptr(), code,
                            part.data_ptr(), out.data_ptr(), n, dr, s, splits,
                            _launch_stream())
    _build.check(err, "dWs_att GEMM kernel")
    dws_gemm.launches += 1
    dws_gemm.launches_by_route[route] += 1
    return out


@spanned("stvd.kernel.dws_gemm")
def dws_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^T @ b`` with a float32 result: the region projection's weight
    gradient.  CPU tensors take the plain version; CUDA tensors take the
    kernel on the route ``dws_route`` picks (split over N, splits summed
    in a fixed order)."""
    if a.device.type == "cpu":
        return _dws_plain(a, b)
    return _dws_cuda(a, b)


dws_gemm.launches = 0
dws_gemm.launches_by_route = dict.fromkeys(DWS_ROUTES, 0)


class RegionProjection(torch.autograd.Function):
    """pregion = regions @ Ws_att + bs_att (float32), the product taken in
    the compute dtype.  Its backward forms dWs_att from the compute-dtype
    operands with ``dws_gemm`` (``use_kernel``) or its plain version,
    dbs_att as a float32 sum, and d(regions) only when regions require a
    gradient.  Under a model axis with Ws_att row-sharded the product is
    row-parallel (``tp``): the rank's contiguous Dr slice of the regions
    times its rows, one reduce, then the bias; dWs_att is the GEMM kernel
    on that slice, and d(regions) is gathered."""

    @staticmethod
    def forward(ctx, regions, w, b, cdtype, use_kernel):
        width = regions.shape[-1]
        part = tp.local_cols(regions, w.shape[0])
        ctx.save_for_backward(part, w)
        ctx.cdtype = cdtype
        ctx.wgrad = dws_gemm if use_kernel else _dws_plain
        ctx.regions = (regions.shape, regions.dtype)
        ctx.axis = tp.current()
        y = step_mod._dot(part, w, cdtype)
        return tp.reduce_rows(y, width, w.shape[0]) + b

    @staticmethod
    def backward(ctx, g):
        part, w = ctx.saved_tensors
        cd = ctx.cdtype
        shape, dtype = ctx.regions
        g2 = g.reshape(-1, g.shape[-1])
        d_reg = d_w = d_b = None
        if ctx.needs_input_grad[1]:
            d_w = ctx.wgrad(part.reshape(-1, part.shape[-1]).to(cd),
                            g2.to(cd)).to(w.dtype)
        if ctx.needs_input_grad[2]:
            d_b = g2.sum(dim=0)
        if ctx.needs_input_grad[0]:
            with tp.using(ctx.axis):
                d_reg = tp.col(g2, w, shape[-1], cd).reshape(shape).to(dtype)
        return d_reg, d_w, d_b, None, None


def region_projection(regions, w, b, cdtype, use_kernel: bool = True
                      ) -> torch.Tensor:
    """(B, K, R, Dr) regions -> (B, K, R, s) float32 pregion; the weight
    gradient goes through the dWs_att GEMM kernel for CUDA tensors when
    ``use_kernel``, else through its plain version."""
    return RegionProjection.apply(regions, w, b, cdtype, use_kernel)


# ---------------------------------------------------------------------------
# Step selection
# ---------------------------------------------------------------------------

def _gates_core(cfg):
    """The gates hook of ``step_kernels``: the kernel when
    ``cfg.gates_kernel`` is 'on' or 'auto' (both mean the kernel for
    CUDA tensors), the plain cuBLAS gates for 'off'.  The kernel has no
    backward, as in the JAX package, whose ``gates_lstm_pallas`` cannot
    be differentiated: when a gradient must pass through it ('on' on any
    device, 'auto' on CUDA tensors) the call raises rather than swap in
    the plain gates.  'auto' on CPU tensors keeps the plain gates, as
    JAX's 'auto' declines off the TPU."""
    if cfg.gates_kernel == "off":
        return step_mod._gates_lstm

    def gates(x, w, b, c, s_r=None, scale=None, padded_ops=None):
        if _needs_grad(x, w, b, c):
            if cfg.gates_kernel == "on" or x.is_cuda:
                raise ValueError(
                    f"gates_kernel={cfg.gates_kernel!r}: the gates+LSTM "
                    "kernel has no backward; train with "
                    "gates_kernel='off'")
            return step_mod._gates_lstm(x, w, b, c, s_r, scale, padded_ops)
        # the kernel's tensor maps take the logical depth
        return gates_lstm(x, w, b, c, s_r, scale)

    return gates


def step_kernels(params, cfg, state, sc, emb_t, x_pre=None):
    """Decoder step through the kernels (drop-in for ``step.step``): the
    attention core always, the spatial core under spatial attention, the
    gates+LSTM kernel when ``cfg.gates_kernel`` is 'on' or 'auto' (both
    mean the kernel for CUDA tensors; 'off', every preset's default,
    keeps the cuBLAS gates) on the decode branch (no ``x_pre``).  Under a
    gradient (the autodiff and scheduled-sampling train scans) the
    attention and spatial cores carry it through their autograd
    Functions; the gates kernel raises (``_gates_core``).  Decode loops
    take the fused logit tail from its ``make_logit_tail`` attribute.

    This step plays the role of the JAX package's ``step_pallas_spatial``,
    not of ``step_pallas``: the JAX package kept XLA's fusion of the
    spatial chain because its Pallas kernel lost on a TPU, where XLA
    never materialized the tanh intermediate.  Eager PyTorch has no such
    fusion: the plain core builds ``e_s`` of shape (Bc, nb, K, R, s) in
    float32 every step (7.2 GB at decode batch 256, beam 5), so on the
    card the kernel is the only path that keeps it out of memory."""
    return step_mod.step_with_core(params, cfg, state, sc, emb_t, x_pre,
                                   attention_core=attention_core,
                                   spatial_core=spatial_core,
                                   gates_core=_gates_core(cfg))


step_kernels.make_logit_tail = make_logit_tail


def get_step_fn(use_kernels=None, device=None):
    """``None`` = auto: the kernel step when ``device`` (or, without one,
    the default device) is CUDA, the plain step otherwise."""
    if use_kernels is None:
        if device is None:
            use_kernels = torch.cuda.is_available()
        else:
            use_kernels = torch.device(device).type == "cuda"
    return step_kernels if use_kernels else step_mod.step
