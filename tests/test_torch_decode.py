"""The port's greedy and beam decoders against the JAX package's.

Both run the same numpy weights and features at float32 on the CPU.  The
JAX side decodes through ``step_pallas`` (attention-core kernel and fused
logit tail in interpret mode), the vocab is large enough (1024, dim_word
128) for the JAX tail to engage.  Tokens must be identical; scores agree
within 1e-4 (float32 sums over up to 8 steps, in different orders).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stvd.decode import beam as jbeam
from stvd.decode.greedy import greedy_decode as jax_greedy
from stvd.model import kernel as jkernel
from stvd_torch.decode import beam as tbeam
from stvd_torch.decode.greedy import greedy_decode
from stvd_torch.model import kernel as tkernel
from stvd_torch.model import step as tstep
from stvd_torch.model.convert import params_from_numpy

from conftest import small_cfg
from test_torch_step import numpy_frames, numpy_params

CFG = dataclasses.replace(small_cfg(), n_words=1024, dim_word=128)
MAXLEN = 8
STEPS = {"plain": tstep.step, "kernels": tkernel.step_kernels}
SCORE_TOL = dict(rtol=1e-4, atol=1e-4)
_jax_cache = {}


def inputs(cfg=CFG, n=4):
    p = numpy_params(cfg, seed=11)
    frames, mask = numpy_frames(cfg, n, seed=12)
    mask[2, 3:] = 0.0
    return p, frames, mask


def jax_out(kind, k=None):
    key = (kind, k)
    if key not in _jax_cache:
        p, frames, mask = inputs()
        jp = {n: jnp.asarray(v) for n, v in p.items()}
        batch = {"frames": jnp.asarray(frames),
                 "frame_mask": jnp.asarray(mask)}
        if kind == "greedy":
            out = jax_greedy(jp, CFG, batch, maxlen=MAXLEN,
                             step_fn=jkernel.step_pallas)
        else:
            out = jbeam.beam_decode(jp, CFG, batch, beam_size=k,
                                    maxlen=MAXLEN,
                                    step_fn=jkernel.step_pallas)
        _jax_cache[key] = {f: np.asarray(v) for f, v in out._asdict().items()
                           if v is not None}
    return _jax_cache[key]


def torch_batch(frames, mask):
    return {"frames": torch.from_numpy(frames),
            "frame_mask": torch.from_numpy(mask)}


@pytest.mark.parametrize("step", sorted(STEPS))
def test_greedy_matches_jax(step):
    p, frames, mask = inputs()
    out = greedy_decode(params_from_numpy(p, "cpu"), CFG,
                        torch_batch(frames, mask),
                        maxlen=MAXLEN, step_fn=STEPS[step])
    ref = jax_out("greedy")
    np.testing.assert_array_equal(out.tokens.numpy(), ref["tokens"])
    np.testing.assert_array_equal(out.lengths.numpy(), ref["lengths"])
    np.testing.assert_allclose(out.scores.numpy(), ref["scores"],
                               **SCORE_TOL)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("step", sorted(STEPS))
def test_beam_matches_jax(k, step):
    p, frames, mask = inputs()
    out = tbeam.beam_decode(params_from_numpy(p, "cpu"), CFG,
                            torch_batch(frames, mask), beam_size=k,
                            maxlen=MAXLEN, step_fn=STEPS[step])
    ref = jax_out("beam", k)
    for f in ("tokens", "lengths", "all_tokens"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), ref[f], f)
    for f in ("scores", "norm_scores", "all_scores", "all_norm_scores"):
        np.testing.assert_allclose(getattr(out, f).numpy(), ref[f],
                                   err_msg=f, **SCORE_TOL)


def test_beam_k1_equals_greedy():
    p, frames, mask = inputs()
    params = params_from_numpy(p, "cpu")
    batch = torch_batch(frames, mask)
    g = greedy_decode(params, CFG, batch, maxlen=MAXLEN)
    b = tbeam.beam_decode(params, CFG, batch, beam_size=1, maxlen=MAXLEN)
    np.testing.assert_array_equal(b.tokens.numpy(), g.tokens.numpy())
    np.testing.assert_allclose(b.scores.numpy(), g.scores.numpy(),
                               **SCORE_TOL)


@pytest.mark.parametrize("mode", ["gnmt", "linear", "none"])
def test_length_penalty_matches_jax(mode):
    lengths = np.array([[0, 1, 2], [7, 15, 30]], np.int32)
    ref = jbeam._length_penalty(jnp.asarray(lengths), 0.6, mode)
    got = tbeam._length_penalty(torch.from_numpy(lengths), 0.6, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_beam_exits_early_once_every_beam_ends():
    """A bias that makes EOS certain: beam 0 ends at the first step, the
    beams seeded from its runners-up at the second, and the loop stops
    there; a finished beam only extends with EOS at zero cost."""
    p, frames, mask = inputs()
    p["ff_logit_b"] = p["ff_logit_b"].copy()
    p["ff_logit_b"][0] = 1e4
    calls = []

    def counted(*args):
        calls.append(1)
        return tstep.step(*args)

    out = tbeam.beam_decode(params_from_numpy(p, "cpu"), CFG,
                            torch_batch(frames, mask), beam_size=3,
                            maxlen=MAXLEN, step_fn=counted)
    assert len(calls) == 2
    assert (out.tokens == 0).all() and (out.lengths == 1).all()
    assert (out.all_tokens[:, :, 1:] == 0).all()
    assert (out.all_scores[:, 0] == out.scores).all()
    assert torch.isfinite(out.scores).all()


def test_beam_above_eight_takes_the_plain_logits():
    """Beam 9 through the kernel step: the logit tail keeps at most 8
    candidates a row, so ``make_logit_tail`` gives no closure and the
    decode takes the materialized logits, as the JAX package's does."""
    assert tkernel.make_logit_tail(torch.zeros(4, 16), torch.zeros(16),
                                   9) is None
    p, frames, mask = inputs()
    out = tbeam.beam_decode(params_from_numpy(p, "cpu"), CFG,
                            torch_batch(frames, mask), beam_size=9,
                            maxlen=MAXLEN, step_fn=tkernel.step_kernels)
    ref = jax_out("beam", 9)
    for f in ("tokens", "lengths", "all_tokens"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), ref[f], f)
    for f in ("scores", "norm_scores", "all_scores", "all_norm_scores"):
        np.testing.assert_allclose(getattr(out, f).numpy(), ref[f],
                                   err_msg=f, **SCORE_TOL)
