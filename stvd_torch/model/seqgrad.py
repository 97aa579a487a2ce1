"""Hand-derived sequence VJP of the teacher-forced train scan
(counterpart of stvd/model/seqgrad.py).

Two ``torch.autograd.Function``s run the decoder over all T steps in
their forward and take the reverse scan by hand in their backward,
instead of letting autograd record and replay 30 steps of small ops:

* ``FusedSequence``: the temporal model (fused h-projection, masked
  softmax attention over the precomputed ``pctx``, selector, LSTM);
* ``FusedSequenceSpatial``: the same with spatial attention over R
  regions per frame inside each step.

The backward loop computes only each step's preactivation cotangent
``dhp_t`` and stacks it; the big weight gradients are then two products
over all T*B rows,

    d[U | Wd_att | W_sel (| Wsd_att)] = h_prev_stack^T @ dhp_stack
    dWc                               = ctx_t_stack^T  @ dpre_stack

The spatial backward keeps one large accumulator, ``Dpe`` = the
cotangent of ``pregion`` (B, K, R, s), in ``spatial_wgrad_dtype`` (bf16
by default, float32 whenever compute is float32), and carries each
step's attended region vector ``spat`` backwards: the spatial
backward-step kernel recomputes ``e_s``, runs the region-softmax
backward, adds into ``Dpe`` in place and forms the previous step's
``spat`` from the same region rows.

Semantics are those of the JAX functions, with ``pregion`` cast to the
compute dtype once before the scan.  Every parameter's gradient is held
against ``jax.grad`` of the JAX loss in the tests.

Kernel switches, each 'auto'/'on' = the kernel for CUDA tensors (the
wrappers run their plain versions for CPU tensors), 'off' = the plain
version everywhere: ``spatial_bwd_kernel`` (default 'auto'; it also
picks the dWs_att GEMM of the region projection's backward, in
``step.precompute``), ``train_tail_kernel`` and ``train_fwd_kernel``
(the attention-core kernel in the forward scan; both default 'off').
The forward scan's region attention stays plain PyTorch: the spatial
core kernel reads a float32 pregion, and the scan reads it in the
compute dtype.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from . import kernel as kernel_mod
from . import step as step_mod
from . import tp
from .step import compute_dtype, masked_softmax


class Opts(NamedTuple):
    """Non-tensor arguments of the two Functions."""

    dim: int
    attn: int
    selector: bool
    cdtype: torch.dtype
    attention_core: Callable     # step._attention_core or its kernel
    train_tail: Callable         # kernel._train_tail_plain or the kernel
    spatial_bwd: Optional[Callable] = None   # spatial backward step
    acc_dtype: Optional[torch.dtype] = None  # Dpe accumulator dtype


def _gates(preact: torch.Tensor, dim: int):
    i = torch.sigmoid(preact[:, 0 * dim: 1 * dim])
    f = torch.sigmoid(preact[:, 1 * dim: 2 * dim])
    o = torch.sigmoid(preact[:, 2 * dim: 3 * dim])
    g = torch.tanh(preact[:, 3 * dim: 4 * dim])
    return i, f, o, g


def _split_hp(hp: torch.Tensor, dim: int, attn: int):
    """(h_gates, h_att, beta_logit, h_satt) column views of the fused
    h-projection [U | Wd_att | W_sel | Wsd_att?]."""
    off = 4 * dim + attn
    return hp[:, :4 * dim], hp[:, 4 * dim:off], hp[:, off], hp[:, off + 1:]


def _lstm_bwd(dh_tot, dc, preact, c_t, c_prev, dim):
    """Cotangents of the cell: (dpre (B, 4 dim), dc_prev)."""
    i, f, o, gg = _gates(preact, dim)
    tc = torch.tanh(c_t)
    dct = dc + dh_tot * o * (1.0 - tc * tc)
    do = dh_tot * tc
    dpre = torch.cat([dct * gg * i * (1.0 - i),
                      dct * c_prev * f * (1.0 - f),
                      do * o * (1.0 - o),
                      dct * i * (1.0 - gg * gg)], dim=1)
    return dpre, dct * f


def _selector_bwd(dctx_t, ctxw, blogit, b_sel, selector: bool):
    """(d of the unscaled context, d beta_logit (B,), d b_sel)."""
    if not selector:
        return dctx_t, torch.zeros_like(blogit), torch.zeros_like(b_sel)
    beta = torch.sigmoid(blogit.float() + b_sel)
    dbeta = (dctx_t * ctxw).sum(dim=1)
    dblogit = dbeta * beta * (1.0 - beta)
    return dctx_t * beta[:, None], dblogit, dblogit.sum()


def _attn_bwd(dalpha, alpha, mask_f, e, u32):
    """Masked-softmax and tanh-score backward of the temporal attention:
    (ds (B, K), dpe (B, K, A)); ``e`` is the recomputed tanh."""
    ds = alpha * (dalpha - (alpha * dalpha).sum(dim=1, keepdim=True))
    ds = ds * mask_f
    dpe = (ds[:, :, None] * u32).to(e.dtype) * (1.0 - e * e)
    return ds, dpe


def _weight_grads(h_prev, dhp_stack, ctxs, hw, wc, dim, cdtype):
    """The two post-scan products over all T*B rows: (dhw, dwc, dx_pre);
    under a model axis each takes the rows of its weight on the rank."""
    t, b, p = dhp_stack.shape
    dhp_flat = dhp_stack.reshape(t * b, p).to(cdtype)
    dhw = tp.wgrad(h_prev.reshape(t * b, -1), dhp_flat, hw,
                   cdtype).to(hw.dtype)
    dwc = tp.wgrad(ctxs.reshape(t * b, -1), dhp_flat[:, :4 * dim], wc,
                   cdtype).to(wc.dtype)
    return dhw, dwc, dhp_stack[:, :, :4 * dim]


class FusedSequence(torch.autograd.Function):
    """Teacher-forced temporal scan.  Inputs: fused h weights ``hw``, Wc,
    U_att, c_att, b_sel, ctx (B, K, Dc), pctx (B, K, A) f32, ctx_mask,
    h0, c0 and the time-major input projection ``x_pre_all`` (T, B, 4
    dim).  Returns (hs, ctxs, alphas), time-major."""

    @staticmethod
    def forward(ctx, opts: Opts, hw, wc, u_att, c_att, b_sel, ctxt, pctx,
                ctx_mask, h0, c0, x_pre_all):
        cd = opts.cdtype
        h, c = h0, c0
        ys = {k: [] for k in ("h", "c", "ctx", "alpha", "pre", "h_att",
                              "blogit")}
        for t in range(x_pre_all.shape[0]):
            hp = tp.row(h, hw, cd)
            h_gates, h_att, blogit, _ = _split_hp(hp, opts.dim, opts.attn)
            ctx_t, alpha = opts.attention_core(
                h_att, blogit, pctx, ctxt, ctx_mask, u_att, c_att, b_sel,
                opts.selector)
            h, c, preact = opts.train_tail(ctx_t, x_pre_all[t], h_gates, c,
                                           wc, cd)
            for k, v in (("h", h), ("c", c), ("ctx", ctx_t),
                         ("alpha", alpha), ("pre", preact),
                         ("h_att", h_att), ("blogit", blogit)):
                ys[k].append(v)
        st = {k: torch.stack(v) for k, v in ys.items()}
        ctx.opts = opts
        ctx.axis = tp.current()
        ctx.save_for_backward(hw, wc, u_att, c_att, b_sel, ctxt, pctx,
                              ctx_mask, h0, c0, st["h"], st["c"], st["ctx"],
                              st["alpha"], st["pre"], st["h_att"],
                              st["blogit"])
        return st["h"], st["ctx"], st["alpha"]

    @staticmethod
    def backward(ctx, dhs, dctxs, dalphas):
        with tp.using(ctx.axis):
            return FusedSequence._backward(ctx, dhs, dctxs, dalphas)

    @staticmethod
    def _backward(ctx, dhs, dctxs, dalphas):
        opts = ctx.opts
        cd, dim = opts.cdtype, opts.dim
        (hw, wc, u_att, c_att, b_sel, ctxt, pctx, ctx_mask, h0, c0, hs, cs,
         ctxs, alphas, preacts, h_atts, blogits) = ctx.saved_tensors
        T = hs.shape[0]
        h_prev = torch.cat([h0[None], hs[:-1]])
        c_prev = torch.cat([c0[None], cs[:-1]])
        dc_w, d_w = ctxt.shape[-1], h0.shape[-1]
        u32 = u_att.to(pctx.dtype)
        mask_f = (ctx_mask > 0).float()
        f32 = torch.float32
        dh, dc = torch.zeros_like(h0), torch.zeros_like(c0)
        du_att = torch.zeros(opts.attn, dtype=f32, device=hs.device)
        dc_att = torch.zeros((), dtype=f32, device=hs.device)
        db_sel = torch.zeros((), dtype=f32, device=hs.device)
        dpctx = torch.zeros_like(pctx, dtype=f32)
        dctx = torch.zeros(ctxt.shape, dtype=f32, device=hs.device)
        dhp_stack = torch.empty((T,) + hs.shape[1:2]
                                + (hw.shape[1],), dtype=f32,
                                device=hs.device)
        for t in reversed(range(T)):
            dpre, dc = _lstm_bwd(dh + dhs[t], dc, preacts[t], cs[t],
                                 c_prev[t], dim)
            dctx_t = dctxs[t] + tp.col(dpre, wc, dc_w, cd)
            alpha = alphas[t]
            ctxw = torch.einsum("bk,bkd->bd", alpha.to(ctxt.dtype),
                                ctxt).float()
            dctxw, dblogit, dbs = _selector_bwd(dctx_t, ctxw, blogits[t],
                                                b_sel, opts.selector)
            db_sel = db_sel + dbs
            dalpha = (torch.einsum("bd,bkd->bk", dctxw.to(ctxt.dtype),
                                   ctxt).float() + dalphas[t])
            dctx += (alpha.to(ctxt.dtype)[:, :, None]
                     * dctxw.to(ctxt.dtype)[:, None, :])
            e = torch.tanh(pctx + h_atts[t][:, None, :])
            ds, dpe = _attn_bwd(dalpha, alpha, mask_f, e, u32)
            dc_att = dc_att + ds.sum()
            du_att += torch.einsum("bk,bka->a", ds, e.float())
            dpctx += dpe
            dhp = torch.cat([dpre, dpe.sum(dim=1).float(), dblogit[:, None]],
                            dim=1)
            dhp_stack[t] = dhp
            dh = tp.col(dhp, hw, d_w, cd)
        dhw, dwc, dx_pre = _weight_grads(h_prev, dhp_stack, ctxs, hw, wc,
                                         dim, cd)
        return (None, dhw, dwc, du_att.to(u_att.dtype), dc_att.to(c_att.dtype),
                db_sel.to(b_sel.dtype), dctx.to(ctxt.dtype),
                dpctx.to(pctx.dtype), None, dh, dc, dx_pre)


def spatial_stage(h_satt, pregion_c, regions_c, u_s, c_s, cdtype):
    """The train forward's region attention at nb = 1 (JAX
    ``_spatial_step_fwd``): e_s in the compute dtype from the pre-cast
    pregion.  Returns (spat (B, K, Dr) compute dtype, alpha_s (B, K, R)
    f32)."""
    e_s = torch.tanh(pregion_c + h_satt.to(cdtype)[:, None, None, :])
    ss = torch.einsum("bkrd,d->bkr", e_s, u_s.to(cdtype)).float() + c_s
    alpha_s = masked_softmax(ss, None, dim=-1)
    spat = torch.einsum("bkr,bkrd->bkd", alpha_s.to(cdtype), regions_c)
    return spat, alpha_s


class FusedSequenceSpatial(torch.autograd.Function):
    """Teacher-forced scan with spatial attention.  Inputs as
    ``FusedSequence`` plus Us_att, cs_att, W_spat_fuse (``w_sf``), the
    composed W_spat_fuse @ Wc_att (``w_sfa``), pregion (B, K, R, s) and
    regions (B, K, R, Dr).  Returns (hs, ctxs, alphas), time-major."""

    @staticmethod
    def forward(ctx, opts: Opts, hw, wc, u_att, c_att, b_sel, u_s, c_s,
                w_sf, w_sfa, ctxt, pctx, pregion, regions, ctx_mask, h0, c0,
                x_pre_all):
        cd = opts.cdtype
        pregion_c = pregion.to(cd)
        regions_c = regions.to(cd)
        h, c = h0, c0
        ys = {k: [] for k in ("h", "c", "ctx", "alpha", "pre", "h_att",
                              "blogit", "h_satt", "alpha_s")}
        for t in range(x_pre_all.shape[0]):
            hp = tp.row(h, hw, cd)
            h_gates, h_att, blogit, h_satt = _split_hp(hp, opts.dim,
                                                       opts.attn)
            spat, alpha_s = spatial_stage(h_satt, pregion_c, regions_c, u_s,
                                          c_s, cd)
            fuse, pfuse = tp.row_split(spat, [w_sf, w_sfa], cd)
            ctx_k, pctx_k = ctxt + fuse, pctx + pfuse
            ctx_t, alpha = opts.attention_core(
                h_att, blogit, pctx_k, ctx_k, ctx_mask, u_att, c_att, b_sel,
                opts.selector)
            h, c, preact = opts.train_tail(ctx_t, x_pre_all[t], h_gates, c,
                                           wc, cd)
            for k, v in (("h", h), ("c", c), ("ctx", ctx_t),
                         ("alpha", alpha), ("pre", preact),
                         ("h_att", h_att), ("blogit", blogit),
                         ("h_satt", h_satt), ("alpha_s", alpha_s)):
                ys[k].append(v)
        st = {k: torch.stack(v) for k, v in ys.items()}
        ctx.opts = opts
        ctx.axis = tp.current()
        ctx.save_for_backward(
            hw, wc, u_att, c_att, b_sel, u_s, c_s, w_sf, w_sfa, ctxt, pctx,
            pregion_c, regions_c, ctx_mask, h0, c0, st["h"], st["c"],
            st["ctx"], st["alpha"], st["pre"], st["h_att"], st["blogit"],
            st["h_satt"], st["alpha_s"])
        ctx.pregion_dtype = pregion.dtype
        ctx.regions_dtype = regions.dtype
        return st["h"], st["ctx"], st["alpha"]

    @staticmethod
    def backward(ctx, dhs, dctxs, dalphas):
        with tp.using(ctx.axis):
            return FusedSequenceSpatial._backward(ctx, dhs, dctxs, dalphas)

    @staticmethod
    def _backward(ctx, dhs, dctxs, dalphas):
        opts = ctx.opts
        cd, dim = opts.cdtype, opts.dim
        (hw, wc, u_att, c_att, b_sel, u_s, c_s, w_sf, w_sfa, ctxt, pctx,
         pregion_c, regions_c, ctx_mask, h0, c0, hs, cs, ctxs, alphas,
         preacts, h_atts, blogits, h_satts, alpha_ss) = ctx.saved_tensors
        T, B = hs.shape[0], hs.shape[1]
        K = regions_c.shape[1]
        dev = hs.device
        f32 = torch.float32
        want_dregions = ctx.needs_input_grad[12]
        h_prev = torch.cat([h0[None], hs[:-1]])
        c_prev = torch.cat([c0[None], cs[:-1]])
        dc_w, d_w, dr_w = ctxt.shape[-1], h0.shape[-1], regions_c.shape[-1]
        u32 = u_att.to(pctx.dtype)
        mask_f = (ctx_mask > 0).float()
        dh, dc = torch.zeros_like(h0), torch.zeros_like(c0)
        du_att = torch.zeros(opts.attn, dtype=f32, device=dev)
        du_s = torch.zeros(u_s.shape, dtype=f32, device=dev)
        dc_att = torch.zeros((), dtype=f32, device=dev)
        db_sel = torch.zeros((), dtype=f32, device=dev)
        dc_s = torch.zeros((), dtype=f32, device=dev)
        dpctx = torch.zeros(pctx.shape, dtype=f32, device=dev)
        dctx = torch.zeros(ctxt.shape, dtype=f32, device=dev)
        dw_sf = torch.zeros(w_sf.shape, dtype=f32, device=dev)
        dw_sfa = torch.zeros(w_sfa.shape, dtype=f32, device=dev)
        dpe_acc = torch.zeros(pregion_c.shape, dtype=opts.acc_dtype,
                              device=dev)
        dhp_stack = torch.empty((T, B, hw.shape[1]), dtype=f32, device=dev)
        dspat_stack = ([None] * T) if want_dregions else None
        zeros_r = torch.zeros_like(alpha_ss[0])
        # spat of the last step; each backward step forms the one before
        spat = torch.einsum("bkr,bkrd->bkd", alpha_ss[-1].to(cd), regions_c)
        for t in reversed(range(T)):
            h_att, blogit, alpha = h_atts[t], blogits[t], alphas[t]
            fuse, pfuse = tp.row_split(spat, [w_sf, w_sfa], cd)
            ctx_k, pctx_k = ctxt + fuse, pctx + pfuse
            e = torch.tanh(pctx_k + h_att[:, None, :])
            dpre, dc = _lstm_bwd(dh + dhs[t], dc, preacts[t], cs[t],
                                 c_prev[t], dim)
            dctx_t = dctxs[t] + tp.col(dpre, wc, dc_w, cd)
            ctxw = torch.einsum("bk,bkd->bd", alpha.to(ctx_k.dtype),
                                ctx_k).float()
            dcw, dblogit, dbs = _selector_bwd(dctx_t, ctxw, blogit, b_sel,
                                              opts.selector)
            db_sel = db_sel + dbs
            dalpha = (torch.einsum("bd,bkd->bk", dcw, ctx_k.float())
                      + dalphas[t])
            dck = alpha[:, :, None] * dcw[:, None, :]
            ds, dpk = _attn_bwd(dalpha, alpha, mask_f, e, u32)
            dc_att = dc_att + ds.sum()
            du_att += torch.einsum("bk,bka->a", ds, e.float())
            dctx += dck
            dpctx += dpk
            dck_f = dck.reshape(B * K, -1).to(cd)
            dpk_f = dpk.reshape(B * K, -1).to(cd)
            sp_f = spat.reshape(B * K, -1).to(cd)
            dw_sf += tp.wgrad(sp_f, dck_f, w_sf, cd)
            dw_sfa += tp.wgrad(sp_f, dpk_f, w_sfa, cd)
            dspat = tp.col_sum([(dck_f, w_sf), (dpk_f, w_sfa)], dr_w,
                               cd).reshape(B, K, -1)
            alpha_prev = alpha_ss[t - 1] if t > 0 else zeros_r
            dh_satt, du_c, dss, spat = opts.spatial_bwd(
                h_satts[t], pregion_c, regions_c, alpha_ss[t], alpha_prev,
                dspat, u_s, dpe_acc)
            du_s += du_c
            dc_s = dc_s + dss.sum()
            dhp_stack[t] = torch.cat([dpre, dpk.sum(dim=1).float(),
                                      dblogit[:, None], dh_satt], dim=1)
            dh = tp.col(dhp_stack[t], hw, d_w, cd)
            if want_dregions:
                dspat_stack[t] = dspat.to(cd)
        dhw, dwc, dx_pre = _weight_grads(h_prev, dhp_stack, ctxs, hw, wc,
                                         dim, cd)
        dregions = None
        if want_dregions:
            # the spat route only; the e_s route reaches regions through
            # the region projection's own backward
            # (bf16 operands are exact in float32: float32 sums)
            dregions = torch.einsum(
                "tbkr,tbkd->bkrd", alpha_ss.to(cd).float(),
                torch.stack(dspat_stack).float()).to(ctx.regions_dtype)
        return (None, dhw, dwc, du_att.to(u_att.dtype),
                dc_att.to(c_att.dtype), db_sel.to(b_sel.dtype),
                du_s.to(u_s.dtype), dc_s.to(c_s.dtype),
                dw_sf.to(w_sf.dtype), dw_sfa.to(w_sfa.dtype),
                dctx.to(ctxt.dtype), dpctx.to(pctx.dtype),
                dpe_acc.to(ctx.pregion_dtype), dregions, None, dh, dc, dx_pre)


def _kernel_on(switch: str) -> bool:
    """'auto' and 'on' both pick the kernel wrapper, which takes the plain
    version for CPU tensors and the kernel for CUDA tensors."""
    return switch in ("auto", "on")


def _opts(cfg, spatial: bool) -> Opts:
    """The scans' options; under a model axis the train-scan tail is the
    plain one, whose ``ctx_t @ Wc`` is row-parallel ('on' is refused by
    ``tp.check_options``)."""
    cd = compute_dtype(cfg)
    acc = None
    if spatial:
        acc = (torch.bfloat16 if (cfg.spatial_wgrad_dtype == "bfloat16"
                                  and cd != torch.float32)
               else torch.float32)
    return Opts(
        dim=cfg.dim, attn=cfg.attn_dim, selector=bool(cfg.selector),
        cdtype=cd,
        attention_core=(kernel_mod.attention_core
                        if _kernel_on(cfg.train_fwd_kernel)
                        else step_mod._attention_core),
        train_tail=(kernel_mod.train_tail
                    if _kernel_on(cfg.train_tail_kernel)
                    and tp.current() is None
                    else kernel_mod._train_tail_plain),
        spatial_bwd=((kernel_mod.spatial_bwd
                      if _kernel_on(cfg.spatial_bwd_kernel)
                      else kernel_mod._spatial_bwd_plain)
                     if spatial else None),
        acc_dtype=acc)


def run(params, cfg, sc, state0, x_pre_all_tm):
    """The temporal scan from ``decoder.forward_train``; ``x_pre_all_tm``
    is time-major (T, B, 4 dim)."""
    return FusedSequence.apply(
        _opts(cfg, False), sc.h_proj_w, params["Wc"], params["U_att"],
        params["c_att"], params["b_sel"], sc.ctx, sc.pctx, sc.ctx_mask,
        state0.h, state0.c, x_pre_all_tm)


def run_spatial(params, cfg, sc, state0, x_pre_all_tm):
    """The spatial scan (preset 2) from ``decoder.forward_train``."""
    return FusedSequenceSpatial.apply(
        _opts(cfg, True), sc.h_proj_w, params["Wc"], params["U_att"],
        params["c_att"], params["b_sel"], params["Us_att"],
        params["cs_att"], params["W_spat_fuse"], sc.w_sf_att, sc.ctx,
        sc.pctx, sc.pregion, sc.regions, sc.ctx_mask, state0.h, state0.c,
        x_pre_all_tm)
