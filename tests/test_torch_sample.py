"""The port's stochastic sampling and greedy attention maps against the
JAX package.

Both run the same numpy weights and features at float32 on the CPU.
Where no draw is involved (temperature 0, top-k 1) tokens must be the
JAX package's and scores within 1e-5.  Where draws are involved the two
packages' generators differ, so each sample is held to the model: its
score must be, within 1e-5, the sum of the JAX training forward's
log-probs of its own tokens, and the first token's distribution over
4000 draws must pass a chi-square test against the tempered top-k
softmax.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stvd.decode import sample as jsample
from stvd.decode.greedy import greedy_decode as jax_greedy
from stvd.model import decoder as jdecoder
from stvd_torch.decode.greedy import greedy_decode
from stvd_torch.decode.sample import sample_decode
from stvd_torch.model import kernel as tkernel
from stvd_torch.model import step as tstep
from stvd_torch.model.convert import params_from_numpy

from conftest import small_cfg
from test_torch_step import numpy_frames, numpy_params

CFG = dataclasses.replace(small_cfg(), n_words=64, dim_word=32)
MAXLEN = 8
STEPS = {"plain": tstep.step, "kernels": tkernel.step_kernels}
TOL = dict(rtol=0, atol=1e-5)


def inputs(n=4):
    p = numpy_params(CFG, seed=31)
    frames, mask = numpy_frames(CFG, n, seed=32)
    return p, frames, mask


def torch_batch(frames, mask):
    return {"frames": torch.from_numpy(frames),
            "frame_mask": torch.from_numpy(mask)}


def jax_batch(frames, mask):
    return {"frames": jnp.asarray(frames), "frame_mask": jnp.asarray(mask)}


def jparams(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (1.0, 1)])
@pytest.mark.parametrize("step", sorted(STEPS))
def test_draw_free_sampling_matches_jax(step, temperature, top_k):
    p, frames, mask = inputs()
    kw = dict(maxlen=MAXLEN, temperature=temperature, top_k=top_k,
              n_samples=2)
    ref = jsample.sample_decode(jparams(p), CFG, jax_batch(frames, mask),
                                jax.random.PRNGKey(0), **kw)
    out = sample_decode(params_from_numpy(p, "cpu"), CFG,
                        torch_batch(frames, mask),
                        torch.Generator().manual_seed(0),
                        step_fn=STEPS[step], **kw)
    assert tuple(out.tokens.shape) == (4, 2, MAXLEN)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores),
                               **TOL)


def jax_logprob_of(p, frames, mask, tokens, lengths):
    """Sum over each row's first ``lengths`` tokens of the JAX training
    forward's log-probs (teacher forcing on the row's own tokens)."""
    n = tokens.shape[0]
    tmask = (np.arange(tokens.shape[1])[None] < lengths[:, None])
    batch = {"frames": jnp.asarray(frames), "frame_mask": jnp.asarray(mask),
             "tokens": jnp.asarray(tokens.astype(np.int32)),
             "token_mask": jnp.asarray(tmask.astype(np.float32))}
    logits = jdecoder.forward_train(jparams(p), CFG, batch,
                                    train=False).logits
    logp = np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32), -1))
    tok = np.take_along_axis(logp, tokens[..., None], axis=-1)[..., 0]
    return (tok * tmask).sum(axis=1).reshape(n)


@pytest.mark.parametrize("top_k", [0, 3, 12])
@pytest.mark.parametrize("step", sorted(STEPS))
def test_sample_scores_are_the_model_logprobs(step, top_k):
    """Scores are under the untempered model: equal to the JAX training
    forward's log-probs of each sample's own tokens.  Top-k 3 takes the
    logit tail's closure on the kernel step, top-k 12 and 0 the
    materialized logits."""
    p, frames, mask = inputs()
    n = 3
    tails = []
    step_fn = STEPS[step]
    if hasattr(step_fn, "make_logit_tail"):
        def counted(*args):
            tails.append(args[2])
            return tkernel.make_logit_tail(*args)

        def step_fn(*args):
            return tkernel.step_kernels(*args)
        step_fn.make_logit_tail = counted
    out = sample_decode(params_from_numpy(p, "cpu"), CFG,
                        torch_batch(frames, mask),
                        torch.Generator().manual_seed(7), maxlen=MAXLEN,
                        temperature=0.7, top_k=top_k, n_samples=n,
                        step_fn=step_fn)
    if step == "kernels":
        assert tails == ([top_k] if top_k else [])
    toks = out.tokens.numpy().reshape(4 * n, MAXLEN)
    lens = out.lengths.numpy().reshape(4 * n)
    want = jax_logprob_of(p, np.repeat(frames, n, 0), np.repeat(mask, n, 0),
                          toks, lens)
    np.testing.assert_allclose(out.scores.numpy().reshape(-1), want, **TOL)
    assert len({tuple(r) for r in toks}) > 1       # the draws differ
    # a sample ends with EOS or at maxlen; zeros after
    for r, l in zip(toks, lens):
        assert (r[l:] == 0).all() and (l == MAXLEN or r[l - 1] == 0)


def test_first_token_follows_the_tempered_top_k_softmax():
    """4000 draws of the first token at T 0.7, top-k 3 (through the logit
    tail's closure): chi-square against softmax(top-3 logits / T), 2
    degrees of freedom, so p = exp(-x / 2) must exceed 1e-3."""
    p, frames, mask = inputs(n=1)
    draws = 4000
    out = sample_decode(params_from_numpy(p, "cpu"), CFG,
                        torch_batch(frames, mask),
                        torch.Generator().manual_seed(11), maxlen=1,
                        temperature=0.7, top_k=3, n_samples=draws,
                        step_fn=tkernel.step_kernels)
    first = out.tokens.numpy()[0, :, 0]
    batch = {"frames": jnp.asarray(frames), "frame_mask": jnp.asarray(mask),
             "tokens": jnp.zeros((1, 1), jnp.int32),
             "token_mask": jnp.ones((1, 1), jnp.float32)}
    logits = np.asarray(jdecoder.forward_train(jparams(p), CFG, batch,
                                               train=False).logits)[0, 0]
    top = np.argsort(-logits, kind="stable")[:3]
    w = np.exp((logits[top] - logits[top].max()) / 0.7)
    expect = draws * w / w.sum()
    counts = np.array([(first == t).sum() for t in top])
    assert counts.sum() == draws           # only the top 3 are drawn
    x = float(((counts - expect) ** 2 / expect).sum())
    assert math.exp(-x / 2) > 1e-3, (counts, expect)


def test_temperature_must_not_be_negative():
    p, frames, mask = inputs(n=1)
    with pytest.raises(ValueError, match="temperature"):
        sample_decode(params_from_numpy(p, "cpu"), CFG,
                      torch_batch(frames, mask), None, temperature=-1.0)


@pytest.mark.parametrize("step", sorted(STEPS))
def test_greedy_alphas_match_jax(step):
    p, frames, mask = inputs()
    mask[1, 2:] = 0.0
    ref = jax_greedy(jparams(p), CFG, jax_batch(frames, mask),
                     maxlen=MAXLEN, return_alphas=True)
    out = greedy_decode(params_from_numpy(p, "cpu"), CFG,
                        torch_batch(frames, mask), maxlen=MAXLEN,
                        step_fn=STEPS[step], return_alphas=True)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    assert tuple(out.alphas.shape) == (4, MAXLEN, CFG.n_frames)
    np.testing.assert_allclose(out.alphas.numpy(), np.asarray(ref.alphas),
                               **TOL)
    assert (out.alphas[1, :, 2:] == 0).all()
    assert greedy_decode(params_from_numpy(p, "cpu"), CFG,
                         torch_batch(frames, mask),
                         maxlen=MAXLEN).alphas is None
