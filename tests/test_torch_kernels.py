"""Plain versions of the port's kernels against the JAX package's
kernels (Pallas in interpret mode on the CPU) and their jnp oracles.

On the CPU the kernel wrappers take the plain versions; the CUDA kernels
themselves are held against these plain versions on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stvd.model import kernel as jkernel
from stvd.model import step as jstep
from stvd_torch.model import kernel as tkernel
from stvd_torch.model import step as tstep

TOL = dict(rtol=1e-5, atol=1e-5)


def attention_inputs(bc, nb, k=6, a=16, dc=24, seed=0):
    rng = np.random.RandomState(seed)
    mask = (rng.rand(bc, k) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[1] = 0.0                                   # a fully-masked row
    return (rng.randn(bc * nb, a).astype(np.float32),
            rng.randn(bc * nb).astype(np.float32),
            rng.randn(bc, k, a).astype(np.float32),
            rng.randn(bc, k, dc).astype(np.float32),
            mask,
            rng.randn(a).astype(np.float32),
            np.float32(0.3), np.float32(-0.2))


@pytest.mark.parametrize("nb", [1, 5])
@pytest.mark.parametrize("selector", [True, False])
def test_attention_core_matches_jax(nb, selector):
    arrs = attention_inputs(bc=4, nb=nb)
    jargs = [jnp.asarray(x) for x in arrs]
    targs = [torch.from_numpy(np.asarray(x)) for x in arrs]
    got_ctx, got_alpha = tkernel.attention_core(*targs, selector)
    assert torch.isfinite(got_ctx).all() and torch.isfinite(got_alpha).all()
    assert float(got_alpha[nb:2 * nb].abs().max()) == 0.0
    assert float(got_ctx[nb:2 * nb].abs().max()) == 0.0
    for ref in (jkernel.attention_core_pallas(*jargs, selector),
                jstep._attention_core_jnp(*jargs, selector)):
        np.testing.assert_allclose(got_ctx.numpy(), np.asarray(ref[0]), **TOL)
        np.testing.assert_allclose(got_alpha.numpy(), np.asarray(ref[1]),
                                   **TOL)


@pytest.mark.parametrize("rows,a,dc,route", [
    (1280, 2048, 2048, "cluster"), (256, 2048, 2048, "cluster"),
    (64, 2048, 2048, "cluster"), (1280, 4096, 2048, "simple"),
    (1280, 2048, 4096, "simple")])
def test_attention_core_route_at_preset_4(rows, a, dc, route):
    """Preset 4's width (A = Dc = 2048, a float32 fused context) takes
    route 'cluster' at 5 beams and at the training scan's 1 beam; only
    above 2048 columns does the core fall back to 'simple'."""
    nb = 5 if rows != 64 else 1
    assert tkernel.attention_core_route(nb, 28, a, dc, torch.float32,
                                        0, 0) == route


@pytest.mark.parametrize("nb", [1, 5])
def test_attention_core_matches_jax_at_preset_4_width(nb):
    """The plain core at A = Dc = 2048 with a float32 context against the
    JAX kernel (interpret mode) and its jnp oracle."""
    arrs = attention_inputs(bc=2, nb=nb, k=5, a=2048, dc=2048, seed=3)
    jargs = [jnp.asarray(x) for x in arrs]
    targs = [torch.from_numpy(np.asarray(x)) for x in arrs]
    got = tkernel.attention_core(*targs, True)
    for ref in (jkernel.attention_core_pallas(*jargs, True),
                jstep._attention_core_jnp(*jargs, True)):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


def tail_inputs(rows, dw, v, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(rows, dw).astype(np.float32),
            (0.1 * rng.randn(dw, v)).astype(np.float32),
            rng.randn(v).astype(np.float32))


def check_tail(x, w, b, k):
    vals, idx, lse = tkernel.make_logit_tail(
        torch.from_numpy(w), torch.from_numpy(b), k)(torch.from_numpy(x))
    assert idx.dtype == torch.int64
    logits = jnp.asarray(x) @ jnp.asarray(w) + jnp.asarray(b)
    rv, ri = jax.lax.top_k(logits, k)
    jv, ji, jl = jax.jit(jkernel.make_logit_tail(jnp.asarray(w),
                                                 jnp.asarray(b), k))(
        jnp.asarray(x))
    for ref_v, ref_i in ((rv, ri), (jv, ji)):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
        np.testing.assert_allclose(vals.numpy(), np.asarray(ref_v), **TOL)
    for ref_l in (jax.nn.logsumexp(logits, -1), jl):
        np.testing.assert_allclose(lse.numpy(), np.asarray(ref_l), **TOL)


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("v", [1024, 1000])
def test_logit_tail_matches_jax(k, v):
    """vocab 1000 is not a multiple of 128: the JAX tail pads it with
    -1e30 bias lanes, which must never surface."""
    check_tail(*tail_inputs(rows=24, dw=128, v=v, seed=k), k)


@pytest.mark.parametrize("k", [1, 5, 8])
def test_logit_tail_quantized_ties_go_to_lowest_index(k):
    """Logits quantized to four levels tie everywhere; every top-k entry
    must be the lowest index among equals (lax.top_k order)."""
    rng = np.random.RandomState(9)
    x = np.zeros((8, 128), np.float32)
    w = np.zeros((128, 1000), np.float32)
    b = rng.randint(0, 4, 1000).astype(np.float32)
    check_tail(x, w, b, k)
    _, idx, _ = tkernel.logit_tail(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b), k)
    expect = np.flatnonzero(b == b.max())[:k]
    np.testing.assert_array_equal(idx[0, :len(expect)].numpy(), expect)


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors neither wrapper launches a kernel."""
    tkernel.attention_core.launches = 0
    tkernel.logit_tail.launches = 0
    arrs = [torch.from_numpy(np.asarray(x))
            for x in attention_inputs(bc=2, nb=3)]
    got = tkernel.attention_core(*arrs, True)
    ref = tstep._attention_core(*arrs, True)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    x, w, b = (torch.from_numpy(a) for a in tail_inputs(6, 32, 50))
    got = tkernel.logit_tail(x, w, b, 3)
    ref = tkernel._logit_tail_plain(x, w, b, 3)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert tkernel.attention_core.launches == 0
    assert tkernel.logit_tail.launches == 0
    assert tkernel.get_step_fn(None, "cpu") is tstep.step
    assert tkernel.get_step_fn(None, "cuda") is tkernel.step_kernels


@pytest.mark.parametrize("k", [0, 9])
def test_logit_tail_rejects_k_outside_1_to_8(k):
    with pytest.raises(ValueError):
        tkernel.logit_tail(torch.zeros(2, 8), torch.zeros(8, 64),
                           torch.zeros(64), k)
