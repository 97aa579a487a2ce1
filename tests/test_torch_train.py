"""The port's teacher-forced training path against the JAX package's.

The same synthetic batch (both packages make it from one seed) and the
same numpy weights go through ``stvd.train.loss.loss_fn`` /
``make_train_step`` and their counterparts in ``stvd_torch``, at float32
on the CPU, where every port kernel wrapper runs its plain version.

Bars: forward tensors within 1e-5; the loss within 1e-5 relative; each
parameter's gradient within 1e-5 of the largest gradient entry of the
model (both sum in float32, in different orders; a relative bar per
entry would fail on gradients that are zero up to rounding, such as
``c_att``'s, which a softmax is invariant to).  The plain versions of
the three training kernels are held against the Pallas kernels in
interpret mode (the dWs_att GEMM against ``jnp.dot``, see its test).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stvd.data.batching import gather_batch as jgather_batch
from stvd.data.batching import synthetic_dataset as jsynthetic_dataset
from stvd.model import kernel as jkernel
from stvd.model import seqgrad as jseqgrad
from stvd.model import step as jstep
from stvd.model.decoder import forward_train as jforward_train
from stvd.train import loop as jloop
from stvd.train.loss import loss_fn as jloss_fn
from stvd_torch import config as tconfig
from stvd_torch.data.bank import to_device
from stvd_torch.data.batching import gather_batch, synthetic_dataset
from stvd_torch.model import kernel as tkernel
from stvd_torch.model import step as tstep
from stvd_torch.model.convert import params_from_numpy
from stvd_torch.model.decoder import forward_train
from stvd_torch.train import loop as tloop
from stvd_torch.train.loss import loss_fn

from conftest import small_cfg
from test_torch_step import numpy_params

SPATIAL = dict(use_spatial=True, n_regions=4, region_dim=16)
VARIANTS = {
    "temporal": {},
    "temporal_no_selector": dict(selector=False),
    "temporal_alpha_c": dict(alpha_c=0.5),
    "spatial": SPATIAL,
    "spatial_no_selector_alpha_c": dict(SPATIAL, selector=False,
                                        alpha_c=0.5),
}
N_VIDEOS = 4
MAXLEN = 10


def configs(**kw):
    """(JAX ModelConfig, the port's ModelConfig) with the same fields."""
    jcfg = small_cfg(use_dropout=False, **kw)
    return jcfg, tconfig.ModelConfig(**dataclasses.asdict(jcfg))


def batches(cfg):
    """The same batch from both packages' synthetic datasets; ragged
    frame counts, and the last example weighted 0."""
    kw = dict(n_videos=N_VIDEOS, k=cfg.n_frames, d=cfg.ctx_dim,
              maxlen=MAXLEN, seed=0,
              n_regions=cfg.n_regions if cfg.use_spatial else 0,
              region_dim=cfg.region_dim)
    jds, tds = jsynthetic_dataset(**kw), synthetic_dataset(**kw)
    idx = np.array([0, 3, 5, 6], np.int32)
    weight = np.array([1, 1, 1, 0], np.float32)
    jb = jgather_batch(jds.bank.to_device(), jds.captions, idx)
    tb = gather_batch(to_device(tds.bank, "cpu"), tds.captions, idx)
    jb["weight"] = jnp.asarray(weight)
    tb["weight"] = torch.from_numpy(weight)
    return jb, tb


def jax_params(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def leaf_params(p):
    tp = params_from_numpy(p, "cpu")
    for v in tp.values():
        v.requires_grad_(True)
    return tp


def assert_grads_close(got, ref, rel):
    """Every leaf within ``rel`` of the largest gradient entry."""
    assert sorted(got) == sorted(ref)
    scale = max(float(np.abs(np.asarray(r, np.float32)).max())
                for r in ref.values())
    for k in sorted(ref):
        err = float(np.abs(np.asarray(got[k], np.float32)
                           - np.asarray(ref[k], np.float32)).max())
        assert err <= rel * scale, (k, err, scale)


@pytest.mark.parametrize("spatial", [False, True])
def test_gather_batch_matches_jax(spatial):
    jb, tb = batches(configs(**(SPATIAL if spatial else {}))[0])
    assert sorted(jb) == sorted(tb)
    assert ("regions" in tb) == spatial
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), k)


@pytest.mark.parametrize("spatial", [False, True])
def test_train_precompute_stacks_the_h_projection(spatial):
    """Training's precompute builds the fused h-projection weights
    [U | Wd_att | W_sel (| Wsd_att)] of JAX's ``precompute`` and no
    decode gates stack; decoding's builds the gates stack only."""
    from stvd.model import step as jstep
    jcfg, tcfg = configs(**(SPATIAL if spatial else {}))
    p = numpy_params(jcfg)
    jb, tb = batches(jcfg)
    jsc = jstep.precompute(jax_params(p), jcfg, jb["frames"],
                           jb["frame_mask"], jb.get("regions"))
    tp = params_from_numpy(p, "cpu")
    args = (tp, tcfg, tb["frames"], tb["frame_mask"], tb.get("regions"))
    train_sc = tstep.precompute(*args, train=True)
    np.testing.assert_array_equal(train_sc.h_proj_w.numpy(),
                                  np.asarray(jsc.h_proj_w))
    assert train_sc.gates_w is None
    decode_sc = tstep.precompute(*args)
    assert decode_sc.h_proj_w is None and decode_sc.gates_w is not None


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_train_matches_jax(variant):
    jcfg, tcfg = configs(**VARIANTS[variant])
    p = numpy_params(jcfg)
    jb, tb = batches(jcfg)
    ref = jforward_train(jax_params(p), jcfg, jb, train=False)
    got = forward_train(params_from_numpy(p, "cpu"), tcfg, tb, train=False)
    for name in ("logits", "alphas", "nll_per_example"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loss_and_grads_match_jax(variant):
    """The loss and the gradient of every parameter against
    ``jax.grad(stvd.train.loss.loss_fn)``: the hand-derived sequence VJP
    (and, on the spatial path, the region projection's backward) reach
    every leaf through precompute and init_state."""
    jcfg, tcfg = configs(**VARIANTS[variant])
    p = numpy_params(jcfg)
    jb, tb = batches(jcfg)
    (jl, jaux), jg = jax.value_and_grad(
        lambda q: jloss_fn(q, jcfg, jb, train=False), has_aux=True)(
            jax_params(p))
    tp = leaf_params(p)
    tl, taux = loss_fn(tp, tcfg, tb, train=False)
    tl.backward()
    tl = tl.detach()
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    for k in ("nll", "nll_per_token"):
        assert abs(float(taux[k].detach()) - float(jaux[k])) <= 1e-5 * abs(
            float(jaux[k]))
    assert_grads_close({k: v.grad.numpy() for k, v in tp.items()},
                       {k: np.asarray(v) for k, v in jg.items()}, 1e-5)


@pytest.mark.parametrize("spatial", [False, True])
def test_bf16_loss_and_grads_near_jax(spatial):
    """bf16 compute: both round matmul operands to bf16 with float32
    sums, but at other places (JAX rounds alpha to bf16 before the
    context sum, the port keeps it float32; the JAX spatial backward
    casts dspat to bf16).  Measured here: the same loss, every gradient
    within 4.4e-3 of the largest entry; the bars are 1e-4 relative and
    2e-2."""
    jcfg, tcfg = configs(compute_dtype="bfloat16",
                         **(SPATIAL if spatial else {}))
    p = numpy_params(jcfg)
    jb, tb = batches(jcfg)
    jl, jg = jax.value_and_grad(
        lambda q: jloss_fn(q, jcfg, jb, train=False)[0])(jax_params(p))
    tp = leaf_params(p)
    tl, _ = loss_fn(tp, tcfg, tb, train=False)
    tl.backward()
    tl = tl.detach()
    assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))
    assert_grads_close({k: v.grad.numpy() for k, v in tp.items()},
                       {k: np.asarray(v) for k, v in jg.items()}, 2e-2)


# ---------------------------------------------------------------------------
# Plain versions of the three training kernels
# ---------------------------------------------------------------------------

def spatial_bwd_inputs(b=2, k=3, r=5, s=12, dr=10, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *shape: np.asarray(rng.randn(*shape), np.float32)
    soft = lambda x: np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    return dict(h_satt=f(b, s), pregion=0.5 * f(b, k, r, s),
                regions=f(b, k, r, dr), alpha_s=soft(f(b, k, r)),
                alpha_prev=soft(f(b, k, r)), dspat=f(b, k, dr),
                u_s=f(s) / np.sqrt(s), dpe_acc=0.1 * f(b, k, r, s))


@pytest.mark.parametrize("cd,acc,tol", [
    ("float32", "float32", 1e-5), ("bfloat16", "float32", 1e-2),
    ("bfloat16", "bfloat16", 1e-2)])
def test_spatial_bwd_plain_matches_pallas(cd, acc, tol):
    """Kernel 5's plain version against ``spatial_bwd_pallas`` in
    interpret mode, as tests/test_seqgrad.py runs it.  The Dpe
    accumulator is updated in place.  bf16: e_s and dpe are rounded at
    the same places; tanh may differ by one bf16 ulp between XLA and
    torch, so outputs are held within ``tol`` of their largest entry
    (measured: 2.8e-3)."""
    x = spatial_bwd_inputs()
    jcd, tcd = jnp.dtype(cd), getattr(torch, cd)
    jacc, tacc = jnp.dtype(acc), getattr(torch, acc)
    ref = jkernel.spatial_bwd_pallas(
        jnp.asarray(x["h_satt"]), jnp.asarray(x["pregion"]).astype(jcd),
        jnp.asarray(x["regions"]).astype(jcd), jnp.asarray(x["alpha_s"]),
        jnp.asarray(x["alpha_prev"]), jnp.asarray(x["dspat"]),
        jnp.asarray(x["u_s"]), jnp.asarray(x["dpe_acc"]).astype(jacc), cd)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    # a copy: JAX may still be reading x["dpe_acc"] (dispatch is
    # asynchronous, and on the CPU it may share the numpy buffer) when the
    # plain version accumulates into dpe in place
    dpe = t["dpe_acc"].to(tacc, copy=True)
    got = tkernel.spatial_bwd(t["h_satt"], t["pregion"].to(tcd),
                              t["regions"].to(tcd), t["alpha_s"],
                              t["alpha_prev"], t["dspat"], t["u_s"], dpe)
    assert dpe.dtype == tacc
    for name, g, r in zip(("dpe", "dh_satt", "du_s", "dss", "spat_prev"),
                          (dpe, *got), ref):
        r = np.asarray(r, np.float32)
        assert tuple(g.shape) == r.shape, name
        err = float(np.abs(g.float().numpy() - r).max())
        assert err <= tol * float(np.abs(r).max()), (name, err)


def train_tail_operands(rows, dc, dim, seed=0):
    """ctx_t, x_pre, the h-projection (h_gates is its first 4 dim
    columns, a column view as in the scan), c and Wc, from a seed."""
    rng = np.random.RandomState(seed)
    f = lambda *s: np.asarray(rng.randn(*s), np.float32)
    return (f(rows, dc), f(rows, 4 * dim), f(rows, 4 * dim + 9),
            f(rows, dim), f(dc, 4 * dim) / np.sqrt(dc))


@pytest.mark.parametrize("rows,dc,dim", [(1, 128, 128), (37, 256, 128),
                                         (64, 128, 256), (130, 128, 128)])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_train_tail_plain_matches_pallas(cd, rows, dc, dim):
    """Kernel 6's plain version against ``train_tail_pallas`` in
    interpret mode (it takes dims that are multiples of 128 only and
    pads rows to a multiple of 8: 1, 37 and 130 rows are padded, 64 is
    the training batch); the h_gates operand is a column view of a wider
    projection, as in the scan.  Both take the product with float32 sums
    over the same bf16 operands."""
    ctx_t, x_pre, hp, c, wc = train_tail_operands(rows, dc, dim)
    ref = jkernel.train_tail_pallas(
        jnp.asarray(ctx_t), jnp.asarray(x_pre), jnp.asarray(hp)[:, :4 * dim],
        jnp.asarray(c), jnp.asarray(wc), cd)
    got = tkernel.train_tail(
        torch.from_numpy(ctx_t), torch.from_numpy(x_pre),
        torch.from_numpy(hp)[:, :4 * dim], torch.from_numpy(c),
        torch.from_numpy(wc), getattr(torch, cd))
    for name, g, r in zip(("h", "c", "preact"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("rows,dc,dim", [(1, 16, 8), (37, 272, 100),
                                         (130, 277, 35)])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_train_tail_plain_matches_scan_body_tail(cd, rows, dc, dim):
    """Kernel 6's plain version against the JAX scan body's inline tail
    (``stvd/model/seqgrad.py``: ``x_pre + h_gates + _dot(ctx_t, wc)``,
    then ``_gates`` and the LSTM), at ragged shapes where
    ``train_tail_pallas`` declines and the scan takes that tail."""
    ctx_t, x_pre, hp, c, wc = train_tail_operands(rows, dc, dim, seed=1)
    h_gates = jnp.asarray(hp)[:, :4 * dim]
    assert jkernel.train_tail_pallas(jnp.asarray(ctx_t), jnp.asarray(x_pre),
                                     h_gates, jnp.asarray(c),
                                     jnp.asarray(wc), cd) is None
    preact = (jnp.asarray(x_pre) + h_gates
              + jstep._dot(jnp.asarray(ctx_t), jnp.asarray(wc),
                           jnp.dtype(cd)))
    i, f, o, g = jseqgrad._gates(preact, dim)
    c_ref = f * jnp.asarray(c) + i * g
    ref = (o * jnp.tanh(c_ref), c_ref, preact)
    got = tkernel.train_tail(
        torch.from_numpy(ctx_t), torch.from_numpy(x_pre),
        torch.from_numpy(hp)[:, :4 * dim], torch.from_numpy(c),
        torch.from_numpy(wc), getattr(torch, cd))
    for name, g_, r in zip(("h", "c", "preact"), got, ref):
        np.testing.assert_allclose(g_.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_dws_plain_matches_jnp_dot(cd):
    """Kernel 7's plain version.  The Pallas dWs_att kernel is a closure
    inside ``main()`` of tools/probe_dws_gemm.py, so it cannot be called
    here; the probe's own parity reference is ``jnp.dot(a.T, b,
    preferred_element_type=float32)`` (probe_dws_gemm.py:63-64, 129),
    and that is what this holds the plain version to."""
    rng = np.random.RandomState(0)
    a = np.asarray(rng.randn(300, 24), np.float32)
    b = np.asarray(rng.randn(300, 40), np.float32)
    jcd, tcd = jnp.dtype(cd), getattr(torch, cd)
    ref = jnp.dot(jnp.asarray(a).astype(jcd).T, jnp.asarray(b).astype(jcd),
                  preferred_element_type=jnp.float32)
    got = tkernel.dws_gemm(torch.from_numpy(a).to(tcd),
                           torch.from_numpy(b).to(tcd))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)


def test_region_projection_backward_matches_autograd():
    """The region projection's hand-written backward (dWs_att through the
    dWs_att GEMM's wrapper, dbs_att, d(regions) when asked for) against
    autograd of the plain product, float32."""
    rng = np.random.RandomState(1)
    regions = torch.from_numpy(np.asarray(rng.randn(2, 3, 5, 8), np.float32))
    w = torch.from_numpy(np.asarray(rng.randn(8, 6), np.float32))
    b = torch.from_numpy(np.asarray(rng.randn(6), np.float32))
    g = torch.from_numpy(np.asarray(rng.randn(2, 3, 5, 6), np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (regions, w, b)]
    ref = torch.autograd.grad((leaves[0] @ leaves[1] + leaves[2]), leaves, g)
    leaves = [t.clone().requires_grad_(True) for t in (regions, w, b)]
    out = tkernel.region_projection(*leaves, torch.float32)
    np.testing.assert_allclose(out.detach().numpy(),
                               (regions @ w + b).numpy(), rtol=1e-6)
    got = torch.autograd.grad(out, leaves, g)
    for x, y in zip(got, ref):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# Train step and dropout
# ---------------------------------------------------------------------------

def train_configs(**kw):
    """JAX and port TrainConfigs with the same fields."""
    from stvd.config import TrainConfig as JTrainConfig
    base = dict(batch_size=N_VIDEOS, clip_c=1.0, **kw)
    return JTrainConfig(**base), tconfig.TrainConfig(**base)


@pytest.mark.parametrize("variant,accum", [
    ("temporal", 1), ("spatial", 1), ("spatial", 2)])
def test_train_step_matches_jax(variant, accum):
    """One ``make_train_step`` update (adadelta, global-norm clip 1.0,
    which triggers here) from the same numpy weights, without dropout;
    with ``grad_accum=2`` both packages sum two microbatches' gradients
    before one weighted-mean divide."""
    jcfg, tcfg = configs(**VARIANTS[variant])
    jtc, ttc = train_configs(grad_accum=accum)
    p = numpy_params(jcfg)
    jb, tb = batches(jcfg)
    jp = jax_params(p)
    jstate = {"params": jp, "opt_state": jloop.make_optimizer(jtc).init(jp),
              "step": jnp.zeros((), jnp.int32),
              "rng": jax.random.PRNGKey(0)}
    jnew, jm = jloop.make_train_step(jcfg, jtc)(jstate, jb)
    tp = leaf_params(p)
    tstate = {"params": tp, "opt_state": tloop.make_optimizer(ttc).init(tp),
              "step": 0, "generator": torch.Generator().manual_seed(0)}
    tnew, tm = tloop.make_train_step(tcfg, ttc)(tstate, tb)
    assert tnew["step"] == 1
    for k in ("loss", "nll", "nll_per_token", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    assert float(jm["grad_norm"]) > jtc.clip_c     # the clip is exercised
    ref = {k: np.asarray(v) for k, v in jnew["params"].items()}
    got = {k: v.detach().numpy() for k, v in tnew["params"].items()}
    for k in ref:
        # adadelta's first step moves each entry by ~sqrt(eps): hold the
        # step itself within 1e-4 of its size, plus the two float32
        # roundings of p + step
        step = np.abs(ref[k] - p[k]).max()
        ulp = np.spacing(np.abs(p[k]).max().astype(np.float32))
        err = np.abs(got[k] - ref[k]).max()
        assert err <= 1e-4 * step + 2 * ulp, (k, err, step)


def test_train_dropout_draws_from_the_generator():
    """Inverted dropout on the logit activation: keep bits from the
    generator (same seed, same mask), kept entries scaled by 1/keep, a
    keep share near 1 - dropout_rate; no generator, no train dropout."""
    jcfg, tcfg = configs()
    tcfg = dataclasses.replace(tcfg, use_dropout=True, dropout_rate=0.5)
    p = params_from_numpy(numpy_params(jcfg), "cpu")
    _, tb = batches(jcfg)
    rng = np.random.RandomState(3)
    h = torch.from_numpy(np.asarray(rng.randn(64, tcfg.dim), np.float32))
    ctx = torch.from_numpy(np.asarray(rng.randn(64, tcfg.ctx_dim),
                                      np.float32))
    emb = torch.from_numpy(np.asarray(rng.randn(64, tcfg.dim_word),
                                      np.float32))
    plain = tstep.logit_activation(p, tcfg, h, ctx, emb)
    act = [tstep.logit_activation(p, tcfg, h, ctx, emb,
                                  torch.Generator().manual_seed(s), True)
           for s in (5, 5, 6)]
    assert torch.equal(act[0], act[1]) and not torch.equal(act[0], act[2])
    kept = act[0] != 0
    torch.testing.assert_close(act[0][kept], plain[kept] / 0.5)
    assert 0.4 < float(kept.float().mean()) < 0.6
    with pytest.raises(ValueError):
        tstep.logit_activation(p, tcfg, h, ctx, emb, None, True)
    out = forward_train(p, tcfg, tb, torch.Generator().manual_seed(0),
                        train=True)
    assert bool(torch.isfinite(out.nll_per_example).all())


def tiny_config(save_dir, **train):
    model = tconfig.ModelConfig(n_words=48, dim_word=16, dim=24,
                                ctx_dim=32, n_frames=6,
                                compute_dtype="float32")
    kw = dict(batch_size=4, metric="nll", disp_freq=1, valid_freq=2,
              save_freq=0, save_dir=str(save_dir))
    tc = tconfig.TrainConfig(**{**kw, **train})
    return tconfig.Config(model=model, train=tc)


def test_fit_checkpoints_and_resumes(tmp_path):
    """``fit`` on the synthetic dataset: train records every update, NLL
    validation, a checkpoint of params, optimizer slots, step and
    generator; a second ``fit`` with ``reload_`` resumes at its step."""
    cfg = tiny_config(tmp_path)
    ds = synthetic_dataset(n_videos=6, k=6, d=32, maxlen=MAXLEN, seed=0)
    first = tloop.fit(cfg, ds, ds, max_updates=3, device="cpu")
    assert [r["update"] for r in first.log] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in first.log)
    assert first.history and np.isfinite(first.best_metric)
    assert (tmp_path / "ckpt.pt").is_file()
    assert (tmp_path / "ckpt_best.pt").is_file()
    resumed = tloop.fit(cfg.replace(train=dataclasses.replace(
        cfg.train, reload_=True)), ds, ds, max_updates=5, device="cpu")
    assert resumed.state["step"] == 5
    assert [r["update"] for r in resumed.log] == [4, 5]
    for k, v in first.state["params"].items():
        assert v.shape == resumed.state["params"][k].shape


def test_to_device_caches_per_device_and_dtype():
    """The same (device, dtype) gives back the same tensors; another
    dtype uploads anew (as the JAX bank's per-(dtype, sharding) cache)."""
    from stvd_torch.data.bank import synthetic_bank
    bank = synthetic_bank(3, k=6, d=8, n_regions=2, region_dim=4)
    first = to_device(bank, "cpu", torch.bfloat16)
    assert to_device(bank, torch.device("cpu"), torch.bfloat16) is first
    other = to_device(bank, "cpu", torch.float32)
    assert other is not first and other["frames"].dtype == torch.float32
    assert to_device(bank, "cpu", torch.float32) is other
    assert bank == dataclasses.replace(bank)      # the cache is no value


def test_fit_uploads_the_bank_once(tmp_path, monkeypatch):
    """Two validation rounds on the training split: its frames leave
    numpy once (an uncached to_device uploads them every round)."""
    from stvd_torch.data import bank as bank_mod
    ds = synthetic_dataset(n_videos=6, k=6, d=32, maxlen=MAXLEN, seed=0)
    seen = []
    real = torch.from_numpy

    def counting(x):
        seen.append(x is ds.bank.frames)
        return real(x)

    monkeypatch.setattr(bank_mod.torch, "from_numpy", counting)
    out = tloop.fit(tiny_config(tmp_path), ds, ds, max_updates=4,
                    device="cpu")
    assert len(out.history) == 2
    assert sum(seen) == 1


def test_interrupted_fit_keeps_its_progress(tmp_path, monkeypatch):
    """A ``KeyboardInterrupt`` after 3 updates ends ``fit`` with an
    ``interrupt`` record and a checkpoint at step 3, from which
    ``reload_`` resumes (as the JAX package's loop does)."""
    import json
    cfg = tiny_config(tmp_path, valid_freq=0)
    ds = synthetic_dataset(n_videos=6, k=6, d=32, maxlen=MAXLEN, seed=0)
    real = tloop.make_train_step

    def interrupted(mcfg, tcfg, step_fn=None, mesh=None,
                    use_shard_map=False):
        step = real(mcfg, tcfg, step_fn, mesh, use_shard_map)

        def train_step(state, batch):
            if state["step"] == 3:
                raise KeyboardInterrupt
            return step(state, batch)
        return train_step

    monkeypatch.setattr(tloop, "make_train_step", interrupted)
    try:
        out = tloop.fit(cfg, ds, max_updates=10, device="cpu")
    except KeyboardInterrupt:
        pytest.fail("fit let the interrupt escape without a checkpoint")
    assert out.state["step"] == 3
    blob = torch.load(tmp_path / "ckpt.pt", weights_only=True)
    assert blob["step"] == 3
    recs = [json.loads(ln) for ln in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    recs[-1].pop("elapsed_s")
    assert recs[-1] == {"kind": "interrupt", "update": 3}
    monkeypatch.setattr(tloop, "make_train_step", real)
    resumed = tloop.fit(cfg.replace(train=dataclasses.replace(
        cfg.train, reload_=True)), ds, max_updates=5, device="cpu")
    assert [r["update"] for r in resumed.log] == [4, 5]
    assert resumed.state["step"] == 5


def test_fit_takes_the_jax_positional_order(tmp_path):
    """``fit(cfg, train_ds, valid_ds, step_fn, mesh)`` binds as in the
    JAX package: the 4th positional parameter is the decode step, the 5th
    the data mesh, and the run options are keyword-only, so a caller
    written for the reference cannot pass a step function as
    ``max_updates``."""
    import inspect
    jpos = list(inspect.signature(jloop.fit).parameters)[:5]
    params = inspect.signature(tloop.fit).parameters
    tpos = [n for n, p in params.items()
            if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert tpos == jpos == ["cfg", "train_ds", "valid_ds", "step_fn",
                            "mesh"]
    for name in ("max_updates", "device"):
        assert params[name].kind == inspect.Parameter.KEYWORD_ONLY
    ds = synthetic_dataset(n_videos=4, k=6, d=32, maxlen=MAXLEN, seed=0)
    out = tloop.fit(tiny_config(tmp_path), ds, ds, tstep.step,
                    max_updates=2, device="cpu")
    assert out.state["step"] == 2


@pytest.mark.parametrize("name", ["evaluate_nll", "evaluate_nll_stats"])
def test_evaluate_nll_takes_the_jax_positional_order(name):
    """``evaluate_nll(params, mcfg, ds, batch_size, step_fn)`` binds as in
    the JAX package: the 5th positional parameter is the step function
    and ``device`` is keyword-only, so a caller written for the reference
    cannot pass its step function as the device.  The NLL then equals
    the JAX package's on the same weights."""
    import inspect
    jpos = list(inspect.signature(getattr(jloop, name)).parameters)
    params = inspect.signature(getattr(tloop, name)).parameters
    tpos = [n for n, p in params.items()
            if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert tpos == jpos == ["params", "mcfg", "ds", "batch_size", "step_fn"]
    assert params["device"].kind == inspect.Parameter.KEYWORD_ONLY
    jcfg, tcfg = configs()
    kw = dict(n_videos=N_VIDEOS, k=jcfg.n_frames, d=jcfg.ctx_dim,
              maxlen=MAXLEN, seed=0)
    npp = numpy_params(jcfg)
    got = getattr(tloop, name)(params_from_numpy(npp, "cpu"), tcfg,
                               synthetic_dataset(**kw), 3, tstep.step,
                               device="cpu")
    ref = getattr(jloop, name)(jax_params(npp), jcfg,
                               jsynthetic_dataset(**kw), 3, jstep.step)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_fit_without_a_logger_writes_the_jax_records(tmp_path, capsys):
    """Without a logger both packages' ``fit`` open a ``MetricsLogger``
    on ``save_dir``: the same record kinds in the same order with the
    same keys (``elapsed_s`` on each, ``steps_per_sec`` on the train
    record that closes a window of 10 updates), and the same
    ``[kind] k=v`` lines on stdout; only the timings differ."""
    from stvd import config as jconfig
    kw = dict(n_videos=6, k=6, d=32, maxlen=MAXLEN, seed=0)
    train = dict(disp_freq=1, valid_freq=6, sample_freq=6)
    tcfg = tiny_config(tmp_path / "torch", **train)
    jc = jconfig.Config.from_json(tcfg.replace(train=dataclasses.replace(
        tcfg.train, save_dir=str(tmp_path / "jax"))).to_json())
    tloop.fit(tcfg, synthetic_dataset(**kw), synthetic_dataset(**kw),
              max_updates=12, device="cpu")
    tout = capsys.readouterr().out
    jloop.fit(jc, jsynthetic_dataset(**kw), jsynthetic_dataset(**kw),
              max_updates=12)
    jout = capsys.readouterr().out

    def shape(name):
        import json
        recs = [json.loads(ln) for ln in
                (tmp_path / name / "metrics.jsonl").read_text().splitlines()]
        return [(r["kind"], sorted(r)) for r in recs]

    got, want = shape("torch"), shape("jax")
    assert got == want
    assert ("train", sorted(["kind", "elapsed_s", "epoch", "update", "loss",
                             "grad_norm", "steps_per_sec"])) in got
    assert {k for k, _ in got} == {"train", "sample", "valid", "best"}

    def kinds(out):
        return [ln.split()[0][1:-1] for ln in out.splitlines()
                if ln.startswith("[")]

    assert kinds(tout) == kinds(jout) == [k for k, _ in want]


# ---------------------------------------------------------------------------
# Scheduled sampling, the autodiff scan and remat
# ---------------------------------------------------------------------------

STEPS = {"plain": tstep.step, "kernels": tkernel.step_kernels}
SCAN_VARIANTS = ("temporal", "spatial", "spatial_no_selector_alpha_c")


def jax_coins(ss_prob, b, t, rng=None):
    """The JAX scan's coins for the loss key ``rng`` (None: its
    PRNGKey(0)): split into (dropout, sampling) keys, one sampling key a
    step, ``bernoulli`` over the batch; (T, B) bool."""
    if rng is None:
        rng = jax.random.PRNGKey(0)
    _, rng_ss = jax.random.split(rng)
    keys = jax.random.split(rng_ss, t)
    return np.stack([np.asarray(jax.random.bernoulli(keys[i], ss_prob, (b,)))
                     for i in range(t)])


def use_jax_coins(monkeypatch, ss_prob, batch, rng=None):
    """Make the port's scan draw JAX's coins (the two RNGs differ)."""
    from stvd_torch.model import decoder as tdecoder
    b, t = batch["tokens"].shape
    coins = torch.from_numpy(jax_coins(ss_prob, b, t, rng))

    def fake(generator, p, b_, t_, device):
        assert (p, b_, t_) == (ss_prob, b, t)
        return coins.to(device)

    monkeypatch.setattr(tdecoder, "_ss_coins", fake)
    return coins


_jax_grads = {}


def jax_loss_and_grads(name, jcfg, p, jb, ss_prob):
    """``jax.value_and_grad(loss_fn)`` with the oracle step, cached: the
    port's plain and kernel steps are both held against it."""
    key = (name, ss_prob)
    if key not in _jax_grads:
        (jl, aux), jg = jax.value_and_grad(
            lambda q: jloss_fn(q, jcfg, jb, train=False, ss_prob=ss_prob),
            has_aux=True)(jax_params(p))
        logits = jforward_train(jax_params(p), jcfg, jb, train=False,
                                ss_prob=ss_prob).logits
        _jax_grads[key] = (float(jl), {k: float(v) for k, v in aux.items()},
                           {k: np.asarray(v) for k, v in jg.items()},
                           np.asarray(logits))
    return _jax_grads[key]


def torch_loss_and_grads(tcfg, p, tb, ss_prob, step_fn, **kw):
    tp = leaf_params(p)
    tl, taux = loss_fn(tp, tcfg, tb, train=False, ss_prob=ss_prob,
                       step_fn=step_fn, **kw)
    tl.backward()
    # a leaf the loss does not reach (W_sel without the selector) has a
    # zero gradient in JAX and none in torch
    return (float(tl.detach()), {k: float(v.detach()) for k, v in
                                 taux.items()},
            {k: (np.zeros(v.shape, np.float32) if v.grad is None
                 else v.grad.numpy()) for k, v in tp.items()})


def assert_matches_jax(got, ref):
    tl, taux, tg = got
    jl, jaux, jg = ref[:3]
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    for k in ("nll", "nll_per_token"):
        assert abs(taux[k] - jaux[k]) <= 1e-5 * abs(jaux[k]), k
    assert_grads_close(tg, jg, 1e-5)


@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("ss_prob", [0.25, 1.0])
@pytest.mark.parametrize("variant", SCAN_VARIANTS)
def test_scheduled_sampling_matches_jax(monkeypatch, variant, ss_prob, step):
    """The scheduled-sampling scan with JAX's coins: each step feeds the
    previous step's argmax where a coin says so (t > 0), takes its own
    logits, and autograd differentiates it; the loss and every gradient
    against ``jax.grad(loss_fn)`` within 1e-5, through the plain step
    and through the kernel step (on the CPU its autograd Functions run
    the plain cores forward and their VJP backward)."""
    jcfg, tcfg = configs(**VARIANTS[variant])
    p = numpy_params(jcfg)
    jb, tb = batches(jcfg)
    coins = use_jax_coins(monkeypatch, ss_prob, tb)
    assert bool(coins[1:].any()) and (ss_prob < 1.0) == (not coins.all())
    ref = jax_loss_and_grads(variant, jcfg, p, jb, ss_prob)
    got = torch_loss_and_grads(tcfg, p, tb, ss_prob, STEPS[step])
    assert_matches_jax(got, ref)
    logits = forward_train(params_from_numpy(p, "cpu"), tcfg, tb,
                           train=False, ss_prob=ss_prob,
                           step_fn=STEPS[step]).logits.detach().numpy()
    np.testing.assert_allclose(logits, ref[3], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(logits.argmax(-1), ref[3].argmax(-1))


@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_autodiff_scan_matches_jax(variant, step):
    """``fused_seq_grad=False``: the teacher-forced scan calls the step
    with each step's ``x_pre`` and autograd differentiates it; the loss
    and every gradient against ``jax.grad`` of the same JAX scan."""
    jcfg, tcfg = configs(fused_seq_grad=False, **VARIANTS[variant])
    p = numpy_params(jcfg)
    jb, tb = batches(jcfg)
    ref = jax_loss_and_grads("autodiff_" + variant, jcfg, p, jb, 0.0)
    assert_matches_jax(torch_loss_and_grads(tcfg, p, tb, 0.0, STEPS[step]),
                       ref)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_autodiff_scan_matches_the_hand_vjp(variant, remat):
    """The port's autodiff scan (kernel step, with and without remat)
    against its hand-derived sequence VJP: the same loss and gradients."""
    _, tcfg = configs(**VARIANTS[variant])
    p = numpy_params(configs(**VARIANTS[variant])[0])
    _, tb = batches(configs(**VARIANTS[variant])[0])
    hand = torch_loss_and_grads(tcfg, p, tb, 0.0, None)
    auto = torch_loss_and_grads(
        dataclasses.replace(tcfg, fused_seq_grad=False, remat=remat), p, tb,
        0.0, tkernel.step_kernels)
    assert_matches_jax(auto, hand)


@pytest.mark.parametrize("scan", ["autodiff", "sampled"])
@pytest.mark.parametrize("variant", ["temporal", "spatial"])
def test_remat_matches_no_remat_with_dropout(variant, scan):
    """``model.remat`` recomputes each step's forward in the backward;
    with dropout on and an explicit generator the loss and every
    gradient equal the run without remat, since the coins and dropout
    masks are drawn before the scan (a recomputed step would otherwise
    draw new masks: checkpointing restores no explicit generator)."""
    _, tcfg = configs(**VARIANTS[variant])
    kw = dict(use_dropout=True, dropout_rate=0.5)
    if scan == "autodiff":
        kw["fused_seq_grad"] = False
    ss_prob = 0.5 if scan == "sampled" else 0.0
    p = numpy_params(configs(**VARIANTS[variant])[0])
    _, tb = batches(configs(**VARIANTS[variant])[0])
    out = {}
    for remat in (False, True):
        tp = leaf_params(p)
        gen = torch.Generator().manual_seed(7)
        cfg = dataclasses.replace(tcfg, remat=remat, **kw)
        loss, _ = loss_fn(tp, cfg, tb, generator=gen, train=True,
                          ss_prob=ss_prob, step_fn=tkernel.step_kernels)
        loss.backward()
        out[remat] = (float(loss.detach()),
                      {k: v.grad.clone() for k, v in tp.items()},
                      gen.get_state())
    assert out[True][0] == out[False][0]
    assert torch.equal(out[True][2], out[False][2])
    for k, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], g, rtol=0, atol=1e-7,
                                   msg=k)
    # dropout is live: another seed gives another loss
    tp = leaf_params(p)
    other, _ = loss_fn(tp, dataclasses.replace(tcfg, **kw), tb,
                       generator=torch.Generator().manual_seed(8),
                       train=True, ss_prob=ss_prob)
    assert float(other.detach()) != out[False][0]


@pytest.mark.parametrize("spatial", [False, True])
def test_step_with_x_pre_matches_jax(spatial):
    """The step's teacher-forced branch: ``h @ [U | Wd_att | W_sel (|
    Wsd_att)]`` gives the recurrent term and the attention inputs, and
    the preactivation is ``x_pre + h @ U + ctx_t @ Wc``."""
    jcfg, tcfg = configs(**(SPATIAL if spatial else {}))
    p = numpy_params(jcfg)
    jb, tb = batches(jcfg)
    jp, tp = jax_params(p), params_from_numpy(p, "cpu")
    rng = np.random.RandomState(4)
    b = tb["tokens"].shape[0]
    h, c = (rng.randn(b, jcfg.dim).astype(np.float32) for _ in range(2))
    emb = rng.randn(b, jcfg.dim_word).astype(np.float32)
    x_pre = rng.randn(b, 4 * jcfg.dim).astype(np.float32)
    jsc = jstep.precompute(jp, jcfg, jb["frames"], jb["frame_mask"],
                           jb.get("regions"))
    ref = jstep.step(jp, jcfg, jstep.StepState(jnp.asarray(h), jnp.asarray(c)),
                     jsc, jnp.asarray(emb), jnp.asarray(x_pre))
    tsc = tstep.precompute(tp, tcfg, tb["frames"], tb["frame_mask"],
                           tb.get("regions"), train=True)
    state = tstep.StepState(torch.from_numpy(h), torch.from_numpy(c))
    for fn in STEPS.values():
        got = fn(tp, tcfg, state, tsc, torch.from_numpy(emb),
                 torch.from_numpy(x_pre))
        for name in ("h", "c", "ctx_t", "alpha") + (
                ("alpha_s",) if spatial else ()):
            np.testing.assert_allclose(
                getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                rtol=1e-5, atol=1e-5, err_msg=name)


def attention_core_inputs(bc=3, nb=2, k=5, a=12, dc=10, seed=0):
    rng = np.random.RandomState(seed)
    mask = (rng.rand(bc, k) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    hp = rng.randn(bc * nb, a + 2).astype(np.float32)
    return (hp[:, :a], hp[:, a], rng.randn(bc, k, a).astype(np.float32),
            rng.randn(bc, k, dc).astype(np.float32), mask,
            rng.randn(a).astype(np.float32), np.float32(0.3),
            np.float32(-0.2))


def jax_vjp(fn, args, diff, cot):
    """Outputs and the VJP of ``fn`` over the arguments at ``diff``."""
    def f(*xs):
        full = list(args)
        for i, x in zip(diff, xs):
            full[i] = x
        return fn(*full)

    out, vjp = jax.vjp(f, *[args[i] for i in diff])
    return out, vjp(cot)


@pytest.mark.parametrize("selector", [True, False])
@pytest.mark.parametrize("nb", [1, 2])
def test_attention_core_function_matches_jax_vjp(nb, selector):
    """Kernel 1's autograd Function (CPU: the plain core forward, its VJP
    backward) against the JAX package's ``_core_diff`` custom VJP, the
    Pallas kernel in interpret mode forward and the oracle's VJP
    backward: outputs and the cotangents of h_att, beta_logit, pctx,
    ctx, U_att, c_att and b_sel; ctx_mask gets none."""
    arrs = attention_core_inputs(nb=nb)
    rng = np.random.RandomState(9)
    cot = (rng.randn(arrs[0].shape[0], arrs[3].shape[-1]).astype(np.float32),
           rng.randn(arrs[0].shape[0], arrs[2].shape[1]).astype(np.float32))
    diff = (0, 1, 2, 3, 5, 6, 7)
    jargs = [jnp.asarray(x) for x in arrs]
    jout, jgrads = jax_vjp(
        lambda *xs: jkernel._core_diff(*xs, selector), jargs, diff,
        tuple(jnp.asarray(c) for c in cot))
    targs = [torch.tensor(np.asarray(x)) for x in arrs]
    for i in diff:
        targs[i].requires_grad_(True)
    out = tkernel.attention_core(*targs, selector)
    assert out[0].grad_fn.name().startswith("AttentionCore")
    torch.autograd.backward(out, [torch.from_numpy(c) for c in cot])
    for g, r in zip(out, jout):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-5)
    for i, r in zip(diff, jgrads):
        np.testing.assert_allclose(targs[i].grad.numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-5, err_msg=str(i))
    assert targs[4].grad is None


@pytest.mark.parametrize("nb", [1, 3])
def test_spatial_core_function_matches_jax_vjp(nb):
    """Kernel 4's autograd Function against the JAX package's
    ``_spatial_diff`` custom VJP (interpret-mode kernel forward, the
    float32 oracle's VJP backward): outputs and the cotangents of h_satt,
    pregion, regions, Us_att and cs_att."""
    bc, k, r, s, dr = 2, 3, 5, 12, 10
    rng = np.random.RandomState(2)
    hp = rng.randn(bc * nb, s + 3).astype(np.float32)
    arrs = [hp[:, 3:], rng.randn(bc, k, r, s).astype(np.float32),
            rng.randn(bc, k, r, dr).astype(np.float32),
            rng.randn(s).astype(np.float32), np.float32(0.4)]
    cot = (rng.randn(bc * nb, k, dr).astype(np.float32),
           rng.randn(bc * nb, k, r).astype(np.float32))
    diff = tuple(range(5))
    jout, jgrads = jax_vjp(jkernel._spatial_diff,
                           [jnp.asarray(x) for x in arrs], diff,
                           tuple(jnp.asarray(c) for c in cot))
    targs = [torch.tensor(np.asarray(x), requires_grad=True) for x in arrs]
    spat, alpha = tkernel.spatial_core(*targs, torch.float32)
    assert spat.grad_fn.name().startswith("SpatialCore")
    torch.autograd.backward(
        (spat, alpha), [torch.from_numpy(c).reshape(o.shape)
                        for c, o in zip(cot, (spat, alpha))])
    for g, ref in zip((spat, alpha), jout):
        np.testing.assert_allclose(g.detach().numpy().reshape(ref.shape),
                                   np.asarray(ref), rtol=1e-5, atol=1e-5)
    for i, ref in zip(diff, jgrads):
        np.testing.assert_allclose(targs[i].grad.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5, err_msg=str(i))


def test_kernel_functions_only_under_a_gradient():
    """Without a gradient to carry (decoding, ``no_grad``) the wrappers
    call the core directly: no autograd Function, no saved inputs."""
    targs = [torch.from_numpy(np.asarray(x)) for x in
             attention_core_inputs()]
    targs[0].requires_grad_(True)
    with torch.no_grad():
        out = tkernel.attention_core(*targs, True)
    assert out[0].grad_fn is None
    out = tkernel.attention_core(*[t.detach() for t in targs], True)
    assert out[0].grad_fn is None


def test_unported_training_options_raise_on_the_gates_kernel():
    """The gates+LSTM kernel has no backward, as the JAX package's cannot
    be differentiated: a gradient through it raises a ValueError naming
    ``gates_kernel`` ('on' on any device; 'auto' on CUDA tensors), never
    a silent swap to the plain gates.  'auto' on CPU tensors keeps the
    plain gates (JAX's 'auto' declines off the TPU), and without a
    gradient 'on' runs (decoding)."""
    jcfg, tcfg = configs()
    p = numpy_params(jcfg)
    _, tb = batches(jcfg)
    on = dataclasses.replace(tcfg, gates_kernel="on")
    with pytest.raises(ValueError, match="gates_kernel"):
        loss_fn(leaf_params(p), on, tb, train=False, ss_prob=0.25,
                step_fn=tkernel.step_kernels)
    ref = torch_loss_and_grads(tcfg, p, tb, 0.25, tstep.step)
    auto = torch_loss_and_grads(dataclasses.replace(tcfg,
                                                    gates_kernel="auto"),
                                p, tb, 0.25, tkernel.step_kernels)
    assert auto[0] == ref[0]
    with torch.no_grad():
        nll = loss_fn(params_from_numpy(p, "cpu"), on, tb, train=False,
                      ss_prob=0.25, step_fn=tkernel.step_kernels)[0]
    assert float(nll) == ref[0]
    # the teacher-forced autodiff scan never reaches the gates hook
    auto_tf = torch_loss_and_grads(
        dataclasses.replace(on, fused_seq_grad=False), p, tb, 0.0,
        tkernel.step_kernels)
    assert np.isfinite(auto_tf[0])


@pytest.mark.parametrize("mode", ["ss", "autodiff"])
def test_train_step_with_step_fn_matches_jax(monkeypatch, mode):
    """``make_train_step(mcfg, tcfg, step_fn)`` (the JAX positional
    order) on the autograd scans: one adadelta update from the same
    weights, with the step function passed through to the loss."""
    jcfg, tcfg = configs(**({"fused_seq_grad": False}
                            if mode == "autodiff" else {}))
    ss = dict(ss_prob=0.25) if mode == "ss" else {}
    jtc, ttc = train_configs(**ss)
    p = numpy_params(jcfg)
    jb, tb = batches(jcfg)
    jp = jax_params(p)
    jstate = {"params": jp, "opt_state": jloop.make_optimizer(jtc).init(jp),
              "step": jnp.zeros((), jnp.int32),
              "rng": jax.random.PRNGKey(0)}
    jnew, jm = jloop.make_train_step(jcfg, jtc, jstep.step)(jstate, jb)
    tp = leaf_params(p)
    tstate = {"params": tp, "opt_state": tloop.make_optimizer(ttc).init(tp),
              "step": 0, "generator": torch.Generator().manual_seed(0)}
    calls = []

    def counted(*args):
        calls.append(1)
        return tkernel.step_kernels(*args)

    if mode == "ss":
        # the JAX step draws the loss key as split(state rng)[1]
        use_jax_coins(monkeypatch, 0.25, tb,
                      jax.random.split(jax.random.PRNGKey(0))[1])
    tnew, tm = tloop.make_train_step(tcfg, ttc, counted)(tstate, tb)
    assert len(calls) == tb["tokens"].shape[1]
    for k in ("loss", "nll", "nll_per_token", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    for k, v in jnew["params"].items():
        step = np.abs(np.asarray(v) - p[k]).max()
        ulp = np.spacing(np.abs(p[k]).max().astype(np.float32))
        err = np.abs(tnew["params"][k].detach().numpy() - np.asarray(v)).max()
        assert err <= 1e-4 * step + 2 * ulp, (k, err, step)


def test_evaluate_nll_reads_step_fn_on_the_autodiff_scan():
    """``evaluate_nll_stats`` passes ``step_fn`` to the autodiff scan
    (JAX's ``make_eval_nll``): the same sums as the JAX package's."""
    jcfg, tcfg = configs(fused_seq_grad=False)
    kw = dict(n_videos=5, k=jcfg.n_frames, d=jcfg.ctx_dim, maxlen=MAXLEN,
              seed=2)
    npp = numpy_params(jcfg)
    calls = []

    def counted(*args):
        calls.append(1)
        return tstep.step(*args)

    got = tloop.evaluate_nll_stats(params_from_numpy(npp, "cpu"), tcfg,
                                   synthetic_dataset(**kw), 3, counted,
                                   device="cpu")
    ref = jloop.evaluate_nll_stats(jax_params(npp), jcfg,
                                   jsynthetic_dataset(**kw), 3, jstep.step)
    assert calls
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("train", [
    dict(ss_prob=0.25), dict(debug_nans=True),
    dict(profile_dir="trace", profile_start=0, profile_steps=1)],
    ids=["ss_prob", "debug_nans", "profile_dir"])
def test_fit_runs_the_ported_training_options(tmp_path, train):
    """``fit`` runs an update with scheduled sampling, with NaN debugging
    (scoped to the call: the anomaly mode is restored) and with the
    profiler window (a trace file and a ``profile`` record, as in the
    JAX package)."""
    import json
    if "profile_dir" in train:
        train["profile_dir"] = str(tmp_path / "trace")
    cfg = tiny_config(tmp_path, **train)
    ds = synthetic_dataset(n_videos=2, k=6, d=32, maxlen=MAXLEN, seed=0)
    was = torch.is_anomaly_enabled()
    res = tloop.fit(cfg, ds, max_updates=2, device="cpu")
    assert torch.is_anomaly_enabled() == was
    assert [r["update"] for r in res.log] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in res.log)
    recs = [json.loads(ln) for ln in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    prof = [r for r in recs if r["kind"] == "profile"]
    if "profile_dir" in train:
        assert prof == [{"kind": "profile", "elapsed_s": prof[0]["elapsed_s"],
                         "dir": train["profile_dir"], "first_update": 1,
                         "steps": 1}]
        assert [f for f in os.listdir(train["profile_dir"])
                if f.endswith(".pt.trace.json")]
    else:
        assert not prof


def test_fit_with_debug_nans_raises_on_a_nan(tmp_path):
    """A NaN in training: with ``debug_nans`` ``fit`` raises (autograd's
    anomaly check or the update's finite check), and restores the
    anomaly mode; without it the run goes on with a NaN loss."""
    ds = synthetic_dataset(n_videos=2, k=6, d=32, maxlen=MAXLEN, seed=0)
    ds.bank.frames[:] = np.nan
    with pytest.raises((RuntimeError, FloatingPointError)):
        tloop.fit(tiny_config(tmp_path / "a", debug_nans=True), ds,
                  max_updates=1, device="cpu")
    assert not torch.is_anomaly_enabled()
    res = tloop.fit(tiny_config(tmp_path / "b"), ds, max_updates=1,
                    device="cpu")
    assert not np.isfinite(res.log[0]["loss"])


def test_train_step_with_debug_nans_reports_the_bad_leaves(capsys):
    """With ``debug_nans`` a non-finite gradient raises FloatingPointError
    after ``report_bad_grads`` names the parameters."""
    jcfg, tcfg = configs()
    _, tb = batches(jcfg)
    tb["frames"] = torch.full_like(tb["frames"], float("nan"))
    ttc = tconfig.TrainConfig(batch_size=N_VIDEOS, debug_nans=True)
    tp = leaf_params(numpy_params(jcfg))
    state = {"params": tp, "opt_state": tloop.make_optimizer(ttc).init(tp),
             "step": 0, "generator": torch.Generator().manual_seed(0)}
    with pytest.raises(FloatingPointError):
        tloop.make_train_step(tcfg, ttc)(state, tb)
    assert "[grad-nan] ff_state_W:" in capsys.readouterr().out
