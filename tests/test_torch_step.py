"""The PyTorch port's decoder step against the JAX package's.

The same numpy inputs and weights go through ``stvd.model.step`` and
``stvd_torch.model.step`` at float32 on the CPU; tensors agree within
1e-5 (both sum in float32, in different orders).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stvd.model import step as jstep
from stvd.model.decoder import init_params as jax_init_params
from stvd_torch.model import step as tstep
from stvd_torch.model.convert import params_from_numpy, params_to_numpy
from stvd_torch.model.decoder import encode_context, init_params

from conftest import small_cfg

TOL = dict(rtol=1e-5, atol=1e-5)


def numpy_params(cfg, seed=0):
    """Weights with the JAX names and shapes, drawn with numpy at a scale
    that keeps logits well apart (the 0.01 init leaves near-ties)."""
    rng = np.random.RandomState(seed)
    shapes = {k: v.shape for k, v in
              jax_init_params(jax.random.PRNGKey(0), cfg).items()}
    return {k: np.asarray((rng.randn(*s) / np.sqrt(s[0])) if len(s) >= 2
                          else 0.5 * rng.randn(*s), np.float32)
            for k, s in shapes.items()}


def numpy_frames(cfg, n, seed=1):
    rng = np.random.RandomState(seed)
    frames = rng.randn(n, cfg.n_frames, cfg.ctx_dim).astype(np.float32)
    mask = (rng.rand(n, cfg.n_frames) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    return frames, mask


def both_params(cfg, seed=0):
    p = numpy_params(cfg, seed)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            params_from_numpy(p, "cpu"))


def close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


@pytest.mark.parametrize("case", ["no_mask", "partial", "fully_masked"])
def test_masked_softmax_matches_jax(case):
    rng = np.random.RandomState(2)
    e = (3 * rng.randn(4, 7)).astype(np.float32)
    mask = None
    if case != "no_mask":
        mask = (rng.rand(4, 7) > 0.4).astype(np.float32)
        mask[:, 0] = 1.0
        if case == "fully_masked":
            mask[2] = 0.0
    ref = jstep.masked_softmax(jnp.asarray(e),
                               None if mask is None else jnp.asarray(mask))
    got = tstep.masked_softmax(torch.from_numpy(e),
                               None if mask is None else torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    close(got, ref)
    if case == "fully_masked":
        assert float(got[2].abs().max()) == 0.0


def test_precompute_and_init_state_match_jax():
    cfg = small_cfg()
    jp, tp = both_params(cfg)
    frames, mask = numpy_frames(cfg, 5)
    mask[3] = 0.0                                   # a fully-masked video
    jsc = jstep.precompute(jp, cfg, jnp.asarray(frames), jnp.asarray(mask))
    tsc = tstep.precompute(tp, cfg, torch.from_numpy(frames),
                           torch.from_numpy(mask))
    close(tsc.pctx, jsc.pctx)
    close(tsc.mean_ctx, jsc.mean_ctx)
    close(tsc.h_att_w, jsc.h_att_w)
    close(tsc.gates_w, jsc.gates_w)
    jst = jstep.init_state(jp, cfg, jsc)
    tst = tstep.init_state(tp, cfg, tsc)
    close(tst.h, jst.h)
    close(tst.c, jst.c)


@pytest.mark.parametrize("nb", [1, 5])
@pytest.mark.parametrize("selector", [True, False])
def test_step_matches_jax(nb, selector):
    """One decode step with nb beams per context row (state batch
    Bc*nb against an un-tiled context), a fully-masked row included."""
    cfg = small_cfg(selector=selector)
    jp, tp = both_params(cfg, seed=3)
    bc = 3
    frames, mask = numpy_frames(cfg, bc, seed=4)
    mask[1] = 0.0
    rng = np.random.RandomState(5)
    h = np.tanh(rng.randn(bc * nb, cfg.dim)).astype(np.float32)
    c = rng.randn(bc * nb, cfg.dim).astype(np.float32)
    emb = rng.randn(bc * nb, cfg.dim_word).astype(np.float32)
    jsc = jstep.precompute(jp, cfg, jnp.asarray(frames), jnp.asarray(mask))
    tsc = tstep.precompute(tp, cfg, torch.from_numpy(frames),
                           torch.from_numpy(mask))
    ref = jstep.step(jp, cfg, jstep.StepState(jnp.asarray(h), jnp.asarray(c)),
                     jsc, jnp.asarray(emb))
    got = tstep.step(tp, cfg, tstep.StepState(torch.from_numpy(h),
                                              torch.from_numpy(c)),
                     tsc, torch.from_numpy(emb))
    for name in ("h", "c", "ctx_t", "alpha"):
        close(getattr(got, name), getattr(ref, name))
    assert float(got.alpha[nb:2 * nb].abs().max()) == 0.0


def test_logits_match_jax():
    cfg = small_cfg()
    jp, tp = both_params(cfg, seed=6)
    rng = np.random.RandomState(7)
    h = rng.randn(6, cfg.dim).astype(np.float32)
    ctx_t = rng.randn(6, cfg.ctx_dim).astype(np.float32)
    emb = rng.randn(6, cfg.dim_word).astype(np.float32)
    j_args = (jnp.asarray(h), jnp.asarray(ctx_t), jnp.asarray(emb))
    t_args = (torch.from_numpy(h), torch.from_numpy(ctx_t),
              torch.from_numpy(emb))
    close(tstep.logit_activation(tp, cfg, *t_args),
          jstep.logit_activation(jp, cfg, *j_args))
    close(tstep.logits_from_states(tp, cfg, *t_args),
          jstep.logits_from_states(jp, cfg, *j_args))


def test_cast_params_bf16_matches_jax_rule():
    cfg = small_cfg(compute_dtype="bfloat16")
    jp, tp = both_params(cfg)
    jc = jstep.cast_params(jp, cfg)
    tc = tstep.cast_params(tp, cfg)
    assert tc["Wemb"].dtype == torch.bfloat16
    assert tc["c_att"].dtype == torch.float32 and tc["c_att"].ndim == 0
    for k in jc:
        assert (tc[k].dtype == torch.bfloat16) == (jc[k].dtype == jnp.bfloat16)
        np.testing.assert_array_equal(tc[k].float().numpy(),
                                      np.asarray(jc[k], np.float32))


def test_bf16_dot_keeps_float32_result():
    """Under bf16 the port's matmul returns the float32 sum of bf16
    products, as JAX's preferred_element_type=float32 does."""
    rng = np.random.RandomState(8)
    a = rng.randn(5, 64).astype(np.float32)
    b = rng.randn(64, 7).astype(np.float32)
    ref = jstep._dot(jnp.asarray(a), jnp.asarray(b), jnp.bfloat16)
    got = tstep._dot(torch.from_numpy(a), torch.from_numpy(b),
                     torch.bfloat16)
    assert got.dtype == torch.float32
    close(got, ref)


@pytest.mark.parametrize("field,value", [("use_spatial", True),
                                         ("decode_quant", "int4"),
                                         ("gates_kernel", "maybe")])
def test_precompute_rejects_unported(field, value):
    """What precompute cannot serve: a spatial model without region
    features (as in JAX), and option values nobody implements."""
    cfg = small_cfg(**{field: value})
    tp = params_from_numpy(numpy_params(small_cfg()), "cpu")
    frames, mask = numpy_frames(cfg, 2)
    with pytest.raises(ValueError):
        tstep.precompute(tp, cfg, torch.from_numpy(frames),
                         torch.from_numpy(mask))


@pytest.mark.parametrize("field,value", [("use_motion", True),
                                         ("encoder", "lstm")])
def test_encode_context_rejects_unported(field, value):
    """The dual-stream fusion and the frame-LSTM encoder, which the port
    once rejected, now give the JAX package's context within 1e-5."""
    from stvd.model.decoder import encode_context as jencode_context
    cfg = small_cfg(motion_dim=20, **{field: value})
    jp, tp = both_params(cfg)
    frames, _ = numpy_frames(cfg, 3)
    motion = (np.random.RandomState(5).randn(3, cfg.n_frames, 20)
              .astype(np.float32) if cfg.use_motion else None)
    got = encode_context(tp, cfg, torch.from_numpy(frames),
                         None if motion is None else torch.from_numpy(motion))
    ref = jencode_context(jp, cfg, jnp.asarray(frames),
                          None if motion is None else jnp.asarray(motion))
    assert got.dtype == torch.float32
    close(got, ref)


def test_encode_context_single_stream_is_identity():
    cfg = small_cfg()
    frames = torch.randn(2, cfg.n_frames, cfg.ctx_dim)
    assert encode_context({}, cfg, frames) is frames


@pytest.mark.parametrize("variant", [{}, {"use_spatial": True},
                                     {"use_motion": True, "encoder": "lstm"}])
def test_init_params_names_and_shapes_match_jax(variant):
    cfg = small_cfg(**variant)
    ref = jax_init_params(jax.random.PRNGKey(0), cfg)
    got = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
        assert got[k].dtype == torch.float32
    u = got["U"][:, :cfg.dim]                       # one orthogonal block
    np.testing.assert_allclose((u.T @ u).numpy(), np.eye(cfg.dim),
                               atol=1e-5)
    assert float(got["Wemb"].std()) == pytest.approx(0.01, rel=0.2)


def test_params_numpy_round_trip_is_lossless():
    p = numpy_params(small_cfg())
    back = params_to_numpy(params_from_numpy(p, "cpu"))
    assert back["c_att"].shape == () and back["b_sel"].shape == ()
    for k in p:
        np.testing.assert_array_equal(back[k], p[k])


def test_port_imports_no_jax():
    """Every module of stvd_torch imports without pulling in jax, with
    STVD_FORCE_CPU unset (setting it makes ``stvd`` import jax)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import stvd_torch\n"
        "for m in pkgutil.walk_packages(stvd_torch.__path__, 'stvd_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] == 'jax')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "STVD_FORCE_CPU"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
