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
# Train step, dropout, and what is not ported
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


def test_unported_training_options_raise():
    jcfg, tcfg = configs()
    p = params_from_numpy(numpy_params(jcfg), "cpu")
    _, tb = batches(jcfg)
    with pytest.raises(NotImplementedError):
        forward_train(p, tcfg, tb, train=False, ss_prob=0.25)
    with pytest.raises(NotImplementedError):
        forward_train(p, dataclasses.replace(tcfg, fused_seq_grad=False),
                      tb, train=False)


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


@pytest.mark.parametrize("train", [dict(ss_prob=0.25),
                                   dict(debug_nans=True),
                                   dict(profile_dir="trace")])
def test_fit_rejects_what_is_not_ported(tmp_path, train):
    """Scheduled sampling, NaN debugging and the profiler window are
    still to be ported, and ``fit`` says so rather than training without
    them (caption metrics and length buckets, which it rejected before,
    now run: tests/test_torch_evaluate.py)."""
    cfg = tiny_config(tmp_path, **train)
    ds = synthetic_dataset(n_videos=2, k=6, d=32, maxlen=MAXLEN, seed=0)
    with pytest.raises(NotImplementedError):
        tloop.fit(cfg, ds, max_updates=1, device="cpu")


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

    def interrupted(mcfg, tcfg):
        step = real(mcfg, tcfg)

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
    """``fit(cfg, train_ds, valid_ds, step_fn)`` binds as in the JAX
    package: the 4th positional parameter is the decode step, and the
    run options are keyword-only, so a caller written for the reference
    cannot pass a step function as ``max_updates``."""
    import inspect
    jpos = list(inspect.signature(jloop.fit).parameters)[:4]
    params = inspect.signature(tloop.fit).parameters
    tpos = [n for n, p in params.items()
            if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert tpos == jpos == ["cfg", "train_ds", "valid_ds", "step_fn"]
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
