"""The port's optimizers against the JAX package's (optax) on the CPU.

The same numpy parameters and gradient sequence go through both
packages' ``make_optimizer`` for five updates; parameters agree within
1e-6 relative to their largest entry (float32 elementwise math in the
same order; only the global-norm sum may run in another order).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stvd.config import TrainConfig as JTrainConfig
from stvd.train import loop as jloop
from stvd_torch.config import TrainConfig
from stvd_torch.train import loop as tloop

SHAPES = {"W": (7, 5), "b": (5,), "c": ()}
STEPS = 5


def numpy_params(seed=0):
    rng = np.random.RandomState(seed)
    return {k: np.asarray(rng.randn(*s), np.float32)
            for k, s in SHAPES.items()}


def numpy_grads(scale, seed=1):
    rng = np.random.RandomState(seed)
    return [{k: np.asarray(scale * rng.randn(*s), np.float32)
             for k, s in SHAPES.items()} for _ in range(STEPS)]


def run_jax(tx, params, grads):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(p)
    for g in grads:
        ups, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, p)
        p = optax.apply_updates(p, ups)
    return {k: np.asarray(v) for k, v in p.items()}


def run_torch(tx, params, grads):
    p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = tx.init(p)
    for g in grads:
        ups, state = tx.update({k: torch.from_numpy(v) for k, v in g.items()},
                               state)
        tloop.apply_updates(p, ups)
    return {k: v.numpy() for k, v in p.items()}


def assert_params_close(got, ref, rel=1e-6):
    for k in ref:
        scale = max(float(np.abs(ref[k]).max()), 1e-30)
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= rel * scale, (k, err, scale)


@pytest.mark.parametrize("optimizer,slots,lr", [
    ("adadelta", "float32", 1.0), ("adadelta", "bfloat16", 1.0),
    ("rmsprop", "float32", 0.3), ("rmsprop", "bfloat16", 0.3),
    ("sgd", "float32", 0.05), ("adam", "float32", 1e-2)])
@pytest.mark.parametrize("clip_c", [0.0, 1.0, 100.0])
def test_optimizer_matches_optax(optimizer, slots, lr, clip_c):
    """Five updates of every optimizer, alone and chained after global-
    norm clipping that triggers (1.0) or not (100.0); rmsprop ignores lr
    in both packages."""
    kw = dict(optimizer=optimizer, opt_slot_dtype=slots, lr=lr,
              clip_c=clip_c)
    params, grads = numpy_params(), numpy_grads(scale=0.8)
    ref = run_jax(jloop.make_optimizer(JTrainConfig(**kw)), params, grads)
    got = run_torch(tloop.make_optimizer(TrainConfig(**kw)), params, grads)
    assert_params_close(got, ref)


@pytest.mark.parametrize("scale", [0.01, 0.5, 3.0])
def test_clip_by_global_norm_matches_optax(scale):
    """optax's rule, t / norm * max_norm once norm >= max_norm, with no
    epsilon (torch.nn.utils.clip_grad_norm_ would add 1e-6)."""
    g = numpy_grads(scale)[0]
    max_norm = 2.0
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        {k: jnp.asarray(v) for k, v in g.items()}, ())
    got, _ = tloop.clip_by_global_norm(max_norm).update(
        {k: torch.from_numpy(v) for k, v in g.items()}, ())
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=0)
    norm = float(tloop.global_norm(got))
    assert norm <= max_norm * (1 + 1e-6)


def test_global_norm_matches_optax():
    g = numpy_grads(1.3)[0]
    ref = float(optax.global_norm({k: jnp.asarray(v) for k, v in g.items()}))
    got = float(tloop.global_norm({k: torch.from_numpy(v)
                                   for k, v in g.items()}))
    assert abs(got - ref) <= 1e-6 * ref


def test_bf16_slots_are_stored_in_bf16():
    tx = tloop.make_optimizer(TrainConfig(opt_slot_dtype="bfloat16"))
    p = {k: torch.from_numpy(v) for k, v in numpy_params().items()}
    clip_state, (e_g, e_x) = tx.init(p)
    assert clip_state == ()
    assert all(v.dtype == torch.bfloat16 for v in (*e_g.values(),
                                                   *e_x.values()))


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        tloop.make_optimizer(TrainConfig(optimizer="lamb"))
