"""The port's gates paths (bf16/float32 and W8A8 int8) against the JAX
package's.

The int8 grid, its scales and the activation quantization must be
identical to JAX's, bit for bit.  The gates step is held against JAX's
oracle step and its fused gates+LSTM Pallas kernel (interpret mode,
``gates_kernel='on'``), on lane-aligned dims like the JAX package's own
gates tests (dim and ctx_dim multiples of 128, which its kernel needs):
float32 tensors agree within 1e-5.  Decoded tokens under
``decode_quant='int8'`` are identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stvd.config import ModelConfig
from stvd.decode import beam as jbeam
from stvd.model import kernel as jkernel
from stvd.model import step as jstep
from stvd_torch.decode import beam as tbeam
from stvd_torch.model import kernel as tkernel
from stvd_torch.model import step as tstep
from stvd_torch.model.convert import params_from_numpy

from conftest import small_cfg
from test_torch_step import close, numpy_frames, numpy_params

TOL = dict(rtol=1e-5, atol=1e-5)
STEPS = {"plain": tstep.step, "kernels": tkernel.step_kernels}


def gk_cfg(**kw):
    """Lane-aligned dims, as ``tests/test_kernel.py:_gk_cfg``."""
    base = dict(n_words=48, dim_word=16, dim=128, ctx_dim=128, n_frames=6,
                compute_dtype="float32", use_dropout=False,
                gates_kernel="on")
    base.update(kw)
    return ModelConfig(**base)


def both_contexts(cfg, p, frames, mask):
    jp = jstep.cast_params({k: jnp.asarray(v) for k, v in p.items()}, cfg)
    tp = tstep.cast_params(params_from_numpy(p, "cpu"), cfg)
    jsc = jstep.precompute(jp, cfg, jnp.asarray(frames).astype(
        jnp.dtype(cfg.compute_dtype)), jnp.asarray(mask))
    tsc = tstep.precompute(tp, cfg, torch.from_numpy(frames).to(
        tstep.compute_dtype(cfg)), torch.from_numpy(mask))
    return jp, jsc, tp, tsc


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_int8_weight_grid_matches_jax(compute_dtype):
    """Quantized from the compute-dtype [W; U; Wc] stack after the
    weight cast: identical int8 weights and per-column scales."""
    cfg = gk_cfg(decode_quant="int8", compute_dtype=compute_dtype)
    p = numpy_params(cfg, seed=1)
    p["Wc"][:, 5] = 0.0                         # an all-zero column: 1e-8 floor
    frames, mask = numpy_frames(cfg, 2)
    _, jsc, _, tsc = both_contexts(cfg, p, frames, mask)
    assert tsc.gates_w_q.dtype == torch.int8
    np.testing.assert_array_equal(tsc.gates_w_q.numpy(),
                                  np.asarray(jsc.gates_w_q))
    np.testing.assert_array_equal(tsc.gates_scale.numpy(),
                                  np.asarray(jsc.gates_scale))
    assert int(tsc.gates_w_q.abs().max()) == 127


@pytest.mark.parametrize("cfg_fn", [gk_cfg, small_cfg], ids=["aligned",
                                                             "ragged"])
def test_int8_weight_grid_is_k_major(cfg_fn):
    """The grid is stored K-major, (4 dim, Kx) with rows padded to a
    whole 128 bytes (Kx rounded up to 128), for the gates kernel's int8
    wgmma, and its (Kx, 4 dim) view is JAX's grid element for element;
    the plain gates product of the view is exact."""
    cfg = cfg_fn(decode_quant="int8", gates_kernel="on")
    p = numpy_params(cfg, seed=2)
    frames, mask = numpy_frames(cfg, 2)
    _, jsc, _, tsc = both_contexts(cfg, p, frames, mask)
    w_q = tsc.gates_w_q
    kx = cfg.dim_word + cfg.dim + cfg.ctx_dim
    assert tuple(w_q.shape) == (kx, 4 * cfg.dim)
    assert w_q.stride() == (1, -(-kx // 128) * 128)
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(jsc.gates_w_q))
    x_q = torch.from_numpy(np.random.RandomState(5).randint(
        -127, 128, (3, kx)).astype(np.int8))
    np.testing.assert_array_equal(
        tstep._int8_mm(x_q, w_q).numpy(),
        x_q.numpy().astype(np.int64) @ np.asarray(jsc.gates_w_q).astype(
            np.int64))


def jax_quantize_rows(x):
    """The JAX int8 branch's activation quantization
    (``stvd/model/step.py:460-464``, repeated in ``gates_lstm_pallas``)."""
    x32 = x.astype(jnp.float32)
    s_r = jnp.maximum(jnp.max(jnp.abs(x32), axis=1, keepdims=True),
                      1e-8) / 127.0
    return jnp.clip(jnp.round(x32 / s_r), -127, 127).astype(jnp.int8), s_r


def test_activation_quantization_matches_jax():
    """Identical x_q and s_r for a shared x_cat, exact halves (rounded to
    even) and an all-zero row included."""
    rng = np.random.RandomState(3)
    x = rng.randn(6, 272).astype(np.float32)
    x[0, :4] = [127.0, 2.5, 3.5, -0.5]          # s_r = 1: halves to even
    x[1] = 0.0
    got_q, got_s = tstep.quantize_rows(torch.from_numpy(x))
    ref_q, ref_s = jax_quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))
    assert got_q[0, :4].tolist() == [127, 2, 4, 0]
    assert float(got_q[1].abs().max()) == 0.0


def step_inputs(cfg, bc=3, nb=2, seed=4):
    p = numpy_params(cfg, seed=seed)
    frames, mask = numpy_frames(cfg, bc, seed=seed + 1)
    rng = np.random.RandomState(seed + 2)
    h = np.tanh(rng.randn(bc * nb, cfg.dim)).astype(np.float32)
    c = rng.randn(bc * nb, cfg.dim).astype(np.float32)
    emb = rng.randn(bc * nb, cfg.dim_word).astype(np.float32)
    return p, frames, mask, h, c, emb


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("cfg_fn", [gk_cfg, small_cfg], ids=["aligned",
                                                             "ragged"])
def test_gates_step_matches_jax(quant, cfg_fn):
    """The port's plain step and its kernel step (the gates+LSTM wrapper
    takes its plain version on the CPU) against JAX's oracle step and,
    on aligned dims, its fused gates+LSTM Pallas kernel.  The int32 sums
    are exact and both sides quantize the same x_cat, so int8 holds the
    float32 bar too."""
    cfg = cfg_fn(decode_quant=quant, gates_kernel="on")
    p, frames, mask, h, c, emb = step_inputs(cfg)
    jp, jsc, tp, tsc = both_contexts(cfg, p, frames, mask)
    jst = jstep.StepState(jnp.asarray(h), jnp.asarray(c))
    refs = [jstep.step(jp, cfg, jst, jsc, jnp.asarray(emb))]
    if cfg_fn is gk_cfg:
        assert jsc.gk_w is not None              # JAX's kernel engages
        refs.append(jkernel.step_pallas(jp, cfg, jst, jsc, jnp.asarray(emb)))
    tst = tstep.StepState(torch.from_numpy(h), torch.from_numpy(c))
    for fn in STEPS.values():
        got = fn(tp, cfg, tst, tsc, torch.from_numpy(emb))
        for ref in refs:
            for name in ("h", "c", "ctx_t", "alpha"):
                close(getattr(got, name), getattr(ref, name))


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_gates_lstm_matches_jax_kernel(quant, compute_dtype):
    """The gates+LSTM core alone on shared operands: the port's wrapper
    (plain version on the CPU) against ``gates_lstm_pallas``, with rows
    off the JAX kernel's 128-row tile.  bf16 operands have exact float32
    products on both sides, so every mode holds the float32 bar."""
    cfg = gk_cfg(decode_quant=quant, compute_dtype=compute_dtype)
    p, frames, mask, h, c, emb = step_inputs(cfg, bc=5, nb=1, seed=9)
    ctx_t = np.random.RandomState(10).randn(5, cfg.ctx_dim).astype(
        np.float32)
    jp, jsc, tp, tsc = both_contexts(cfg, p, frames, mask)
    ref_h, ref_c = jkernel.gates_lstm_pallas(
        jnp.asarray(emb), jnp.asarray(h), jnp.asarray(ctx_t),
        jnp.asarray(c), jsc, cfg)
    cdtype = tstep.compute_dtype(cfg)
    x = torch.cat([torch.from_numpy(a).to(cdtype) for a in (emb, h, ctx_t)],
                  dim=1)
    if quant == "int8":
        x_q, s_r = tstep.quantize_rows(x)
        ref_q, ref_s = jax_quantize_rows(jnp.asarray(x.float().numpy()))
        np.testing.assert_array_equal(x_q.numpy(), np.asarray(ref_q))
        got = tkernel.gates_lstm(x_q, tsc.gates_w_q, tp["b"],
                                 torch.from_numpy(c), s_r, tsc.gates_scale)
    else:
        assert tsc.gates_w.dtype == cdtype
        got = tkernel.gates_lstm(x, tsc.gates_w, tp["b"],
                                 torch.from_numpy(c))
    close(got[0], ref_h)
    close(got[1], ref_c)


def test_int8_mm_is_exact():
    rng = np.random.RandomState(11)
    a = rng.randint(-127, 128, (7, 45)).astype(np.int8)
    b = rng.randint(-127, 128, (45, 13)).astype(np.int8)
    got = tstep._int8_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


def test_int8_beam_decode_matches_jax():
    """Beam decode under decode_quant='int8': tokens identical to JAX's
    (its oracle step and its Pallas step with the gates kernel on)."""
    cfg = gk_cfg(decode_quant="int8", n_words=64)
    p, frames, mask, *_ = step_inputs(cfg, bc=4, nb=1, seed=12)
    mask[2, 3:] = 0.0
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jbatch = {"frames": jnp.asarray(frames), "frame_mask": jnp.asarray(mask)}
    refs = [jbeam.beam_decode(jp, cfg, jbatch, beam_size=3, maxlen=8),
            jbeam.beam_decode(jp, cfg, jbatch, beam_size=3, maxlen=8,
                              step_fn=jkernel.step_pallas)]
    tbatch = {"frames": torch.from_numpy(frames),
              "frame_mask": torch.from_numpy(mask)}
    for fn in STEPS.values():
        out = tbeam.beam_decode(params_from_numpy(p, "cpu"), cfg, tbatch,
                                beam_size=3, maxlen=8, step_fn=fn)
        for ref in refs:
            np.testing.assert_array_equal(out.tokens.numpy(),
                                          np.asarray(ref.tokens))
            np.testing.assert_allclose(out.scores.numpy(),
                                       np.asarray(ref.scores), **TOL)


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors neither new wrapper launches a kernel, and the
    kernel step picks the gates kernel only when gates_kernel asks."""
    tkernel.spatial_core.launches = 0
    tkernel.gates_lstm.launches = 0
    rng = np.random.RandomState(13)
    args = [torch.from_numpy(a) for a in (
        rng.randn(6, 8).astype(np.float32),
        rng.randn(3, 4, 5, 8).astype(np.float32),
        rng.randn(3, 4, 5, 7).astype(np.float32),
        rng.randn(8).astype(np.float32))] + [torch.tensor(0.2)]
    got = tkernel.spatial_core(*args, torch.float32)
    ref = tstep._spatial_core(*args, torch.float32)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    x = torch.from_numpy(rng.randn(5, 12).astype(np.float32))
    w = torch.from_numpy(rng.randn(12, 16).astype(np.float32))
    b = torch.from_numpy(rng.randn(16).astype(np.float32))
    c = torch.from_numpy(rng.randn(5, 4).astype(np.float32))
    got = tkernel.gates_lstm(x, w, b, c)
    ref = tstep._gates_lstm(x, w, b, c)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert tkernel.spatial_core.launches == 0
    assert tkernel.gates_lstm.launches == 0

    seen = []

    def spy(*a):
        seen.append(a[1].dtype)
        return tstep._gates_lstm(*a)

    cfg = small_cfg(decode_quant="int8", gates_kernel="off")
    p, frames, mask, h, c, emb = step_inputs(cfg, nb=1)
    _, _, tp, tsc = both_contexts(cfg, p, frames, mask)
    st = tstep.StepState(torch.from_numpy(h), torch.from_numpy(c))
    orig = tkernel.gates_lstm
    try:
        tkernel.gates_lstm = spy
        tkernel.step_kernels(tp, cfg, st, tsc, torch.from_numpy(emb))
        assert seen == []
        tkernel.step_kernels(tp, dataclasses.replace(cfg, gates_kernel="on"),
                             st, tsc, torch.from_numpy(emb))
        assert seen == [torch.int8]
    finally:
        tkernel.gates_lstm = orig


# The plain gates product over the padded depth: the step builds x = [emb |
# h | ctx_t] and the [W; U; Wc] stack in rows padded to 128 bytes with zero
# tails, so the product may run over that depth (a whole 128-byte row,
# where cuBLAS keeps its Hopper kernels); Kx 72 and 65 lie off it.
RAGGED_DIMS = {"kx72": dict(), "kx65": dict(dim_word=10, dim=20, ctx_dim=35)}


def torch_context(cfg, p, frames, mask):
    tp = tstep.cast_params(params_from_numpy(p, "cpu"), cfg)
    return tp, tstep.precompute(tp, cfg, torch.from_numpy(frames).to(
        tstep.compute_dtype(cfg)), torch.from_numpy(mask))


def gates_depths(monkeypatch, cfg):
    """The depth K of each (rows, K) @ (K, 4 dim) gates product, as the
    plain gates take it through ``step._dot``."""
    seen = []
    real = tstep._dot

    def dot(a, b, cdtype):
        if b.shape[-1] == 4 * cfg.dim and b.shape[0] == a.shape[-1]:
            seen.append(a.shape[-1])
        return real(a, b, cdtype)

    monkeypatch.setattr(tstep, "_dot", dot)
    return seen


def depths(cfg):
    """(Kx, Kx padded to a whole 128 bytes of the compute dtype)."""
    kx = cfg.dim_word + cfg.dim + cfg.ctx_dim
    per = 128 // tstep.compute_dtype(cfg).itemsize
    return kx, -(-kx // per) * per


@pytest.mark.parametrize("step_name", ["plain", "kernels"])
@pytest.mark.parametrize("dims", RAGGED_DIMS.values(), ids=RAGGED_DIMS)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_plain_gates_take_the_padded_depth(monkeypatch, compute_dtype, dims,
                                           step_name):
    """At a ragged Kx the decode step's plain gates (``gates_kernel='off'``)
    multiply over the padded depth that ``precompute`` and the step built
    with zero tails, and give the h_t and c_t of the product over Kx."""
    cfg = small_cfg(compute_dtype=compute_dtype, gates_kernel="off", **dims)
    kx, kp = depths(cfg)
    assert kx % 64 and kp > kx
    p, frames, mask, h, c, emb = step_inputs(cfg)
    tp, tsc = torch_context(cfg, p, frames, mask)
    assert tuple(tsc.gates_w_pad.shape) == (kp, 4 * cfg.dim)
    assert torch.equal(tsc.gates_w_pad[:kx], tsc.gates_w)
    assert not tsc.gates_w_pad[kx:].any()
    assert tsc.gates_w.stride() == tsc.gates_w_pad.stride() == (1, kp)
    st = tstep.StepState(torch.from_numpy(h), torch.from_numpy(c))
    seen = gates_depths(monkeypatch, cfg)
    fn = STEPS[step_name]
    got = fn(tp, cfg, st, tsc, torch.from_numpy(emb))
    ref = fn(tp, cfg, st, tsc._replace(gates_w_pad=None),
             torch.from_numpy(emb))
    assert seen == [kp, kx]
    for name in ("h", "c"):
        torch.testing.assert_close(getattr(got, name), getattr(ref, name),
                                   **TOL)


@pytest.mark.parametrize("operand", ["cat", "padded_view"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_gates_operands_of_a_caller_keep_their_depth(monkeypatch,
                                                     compute_dtype, operand):
    """A caller's operands are multiplied over their own depth: a dense
    ``torch.cat`` row block, and a narrow view of a padded buffer (whose
    strides alone say nothing of what lies past Kx), through the plain
    gates and through the kernel wrapper's plain version."""
    cfg = small_cfg(compute_dtype=compute_dtype)
    kx, _ = depths(cfg)
    p, frames, mask, h, c, emb = step_inputs(cfg, bc=5, nb=1, seed=14)
    tp, tsc = torch_context(cfg, p, frames, mask)
    ctx_t = np.random.RandomState(15).randn(5, cfg.ctx_dim).astype(
        np.float32)
    cdtype = tstep.compute_dtype(cfg)
    x = torch.cat([torch.from_numpy(a).to(cdtype) for a in (emb, h, ctx_t)],
                  dim=1)
    if operand == "padded_view":
        x = tstep.padded(5, kx, cdtype, "cpu").copy_(x)
        assert x.stride(0) > kx
    seen = gates_depths(monkeypatch, cfg)
    c = torch.from_numpy(c)
    got = tstep._gates_lstm(x, tsc.gates_w, tp["b"], c)
    wrapped = tkernel.gates_lstm(x, tsc.gates_w, tp["b"], c)
    assert seen == [kx, kx]
    assert all(torch.equal(g, w) for g, w in zip(got, wrapped))


@pytest.mark.parametrize("step_name", ["plain", "kernels"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_scheduled_sampling_gradients_through_the_padded_depth(
        monkeypatch, compute_dtype, step_name):
    """The scheduled-sampling scan runs the decode branch's gates under a
    gradient: W, U and Wc (and every other weight) get the gradients of
    the product over Kx, through the copies into the padded buffers
    (``gates_kernel='auto'`` on CPU tensors: the plain fallback)."""
    from stvd_torch.train.loss import loss_fn
    cfg = small_cfg(compute_dtype=compute_dtype, gates_kernel="auto",
                    **RAGGED_DIMS["kx65"])
    kx, kp = depths(cfg)
    p = numpy_params(cfg, seed=16)
    frames, mask = numpy_frames(cfg, 3, seed=17)
    rng = np.random.RandomState(18)
    batch = {"frames": torch.from_numpy(frames),
             "frame_mask": torch.from_numpy(mask),
             "tokens": torch.from_numpy(rng.randint(1, cfg.n_words, (3, 5))),
             "token_mask": torch.from_numpy(
                 (np.arange(5)[None] < np.array([[5], [3], [4]])).astype(
                     np.float32))}
    fn = STEPS[step_name]

    def logical(params, cfg, state, sc, emb_t, x_pre=None):
        return fn(params, cfg, state, sc._replace(gates_w_pad=None), emb_t,
                  x_pre)

    seen = gates_depths(monkeypatch, cfg)
    grads = []
    for step_fn in (fn, logical):
        leaves = {k: v.requires_grad_(True)
                  for k, v in params_from_numpy(p, "cpu").items()}
        loss, _ = loss_fn(leaves, cfg, batch,
                          torch.Generator().manual_seed(19), train=True,
                          ss_prob=0.5, step_fn=step_fn)
        loss.backward()
        grads.append({k: v.grad for k, v in leaves.items()})
    assert seen == [kp] * 5 + [kx] * 5
    padded, ref = grads
    assert sorted(padded) == sorted(ref)
    for name in ref:
        torch.testing.assert_close(padded[name], ref[name], **TOL)
    assert all(float(ref[n].abs().max()) > 0 for n in ("W", "U", "Wc"))
