"""The port's spatial-attention path (preset 2) against the JAX package's.

The same numpy weights, frames and region features go through
``stvd`` and ``stvd_torch`` at float32 on the CPU.  Tensors agree within
1e-5 (both sum in float32, in different orders); decoded tokens are
identical and scores agree within 1e-5.  The JAX spatial kernel runs in
interpret mode, as the JAX package's own tests run it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stvd import api as japi
from stvd.config import Config, DecodeConfig
from stvd.data.text import Vocab
from stvd.decode import beam as jbeam
from stvd.decode.greedy import greedy_decode as jax_greedy
from stvd.model import kernel as jkernel
from stvd.model import step as jstep
from stvd_torch import api as tapi
from stvd_torch.decode import beam as tbeam
from stvd_torch.decode.greedy import greedy_decode
from stvd_torch.model import kernel as tkernel
from stvd_torch.model import step as tstep
from stvd_torch.model.convert import params_from_numpy

from conftest import small_cfg
from test_torch_step import close, numpy_frames, numpy_params

TOL = dict(rtol=1e-5, atol=1e-5)
# the conftest ``spatial_cfg`` fixture's model
CFG = small_cfg(use_spatial=True, n_regions=4, region_dim=16)
MAXLEN = 8
STEPS = {"plain": tstep.step, "kernels": tkernel.step_kernels}


def numpy_regions(cfg, n, seed=2):
    rng = np.random.RandomState(seed)
    return rng.randn(n, cfg.n_frames, cfg.n_regions,
                     cfg.region_dim).astype(np.float32)


def spatial_inputs(bc, nb, k=5, r=7, s=12, dr=10, seed=0):
    """h_satt as a column slice of a wider h-projection (the step's
    strided view), a region bank, u_s and c_s."""
    rng = np.random.RandomState(seed)
    hp = rng.randn(bc * nb, s + 3).astype(np.float32)
    return (hp[:, 3:], rng.randn(bc, k, r, s).astype(np.float32),
            rng.randn(bc, k, r, dr).astype(np.float32),
            rng.randn(s).astype(np.float32), np.float32(0.4))


@pytest.mark.parametrize("nb", [1, 3])
def test_spatial_core_matches_jax(nb):
    arrs = spatial_inputs(bc=4, nb=nb)
    jargs = [jnp.asarray(x) for x in arrs]
    targs = [torch.from_numpy(np.asarray(x)) for x in arrs]
    spat, alpha_s = tstep._spatial_core(*targs, torch.float32)
    assert spat.shape == (4, nb, 5, 10) and alpha_s.shape == (4, nb, 5, 7)
    np.testing.assert_allclose(alpha_s.sum(-1).numpy(), 1.0, rtol=1e-6)
    for ref in (jstep._spatial_core_jnp(*jargs, jnp.float32),
                jkernel.spatial_core_pallas(*jargs, jnp.float32)):
        np.testing.assert_allclose(spat.numpy(), np.asarray(ref[0]), **TOL)
        np.testing.assert_allclose(alpha_s.numpy(), np.asarray(ref[1]),
                                   **TOL)
    wrapped = tkernel.spatial_core(*targs, torch.float32)
    assert all(torch.equal(g, r) for g, r in zip(wrapped, (spat, alpha_s)))


def test_spatial_core_bf16_contracts_in_compute_dtype():
    """Under bf16 the two contractions take bf16 operands, as the JAX
    einsums do: the port's plain core matches JAX's at bf16 rounding."""
    arrs = spatial_inputs(bc=2, nb=3, seed=5)
    ref = jstep._spatial_core_jnp(*[jnp.asarray(x) for x in arrs],
                                  jnp.bfloat16)
    got = tstep._spatial_core(*[torch.from_numpy(np.asarray(x))
                                for x in arrs], torch.bfloat16)
    assert got[1].dtype == torch.float32
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(ref[0], np.float32),
                               rtol=2e-2, atol=2e-2)


def test_spatial_precompute_matches_jax():
    p = numpy_params(CFG, seed=1)
    frames, mask = numpy_frames(CFG, 3)
    regions = numpy_regions(CFG, 3)
    jsc = jstep.precompute({k: jnp.asarray(v) for k, v in p.items()}, CFG,
                           jnp.asarray(frames), jnp.asarray(mask),
                           jnp.asarray(regions))
    tsc = tstep.precompute(params_from_numpy(p, "cpu"), CFG,
                           torch.from_numpy(frames), torch.from_numpy(mask),
                           torch.from_numpy(regions))
    for name in ("pctx", "pregion", "w_sf_att", "h_att_w", "gates_w"):
        close(getattr(tsc, name), getattr(jsc, name))
    assert tsc.h_att_w.shape == (CFG.dim, CFG.attn_dim + 1 + CFG.region_dim)
    assert tsc.regions is not None and tsc.gates_w_q is None


@pytest.mark.parametrize("nb", [1, 3])
def test_spatial_step_matches_jax(nb):
    """One spatial decode step with nb beams per context row, a fully
    masked row included: the port's plain and kernel steps against JAX's
    oracle and its fully fused Pallas step."""
    p = numpy_params(CFG, seed=3)
    bc = 3
    frames, mask = numpy_frames(CFG, bc, seed=4)
    mask[1] = 0.0
    regions = numpy_regions(CFG, bc, seed=6)
    rng = np.random.RandomState(5)
    h = np.tanh(rng.randn(bc * nb, CFG.dim)).astype(np.float32)
    c = rng.randn(bc * nb, CFG.dim).astype(np.float32)
    emb = rng.randn(bc * nb, CFG.dim_word).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jsc = jstep.precompute(jp, CFG, jnp.asarray(frames), jnp.asarray(mask),
                           jnp.asarray(regions))
    jst = jstep.StepState(jnp.asarray(h), jnp.asarray(c))
    refs = [jstep.step(jp, CFG, jst, jsc, jnp.asarray(emb)),
            jkernel.step_pallas_spatial(jp, CFG, jst, jsc, jnp.asarray(emb))]
    tp = params_from_numpy(p, "cpu")
    tsc = tstep.precompute(tp, CFG, torch.from_numpy(frames),
                           torch.from_numpy(mask), torch.from_numpy(regions))
    tst = tstep.StepState(torch.from_numpy(h), torch.from_numpy(c))
    for fn in STEPS.values():
        got = fn(tp, CFG, tst, tsc, torch.from_numpy(emb))
        assert got.alpha_s.shape == (bc * nb, CFG.n_frames, CFG.n_regions)
        for ref in refs:
            for name in ("h", "c", "ctx_t", "alpha", "alpha_s"):
                close(getattr(got, name), getattr(ref, name))
        assert float(got.alpha[nb:2 * nb].abs().max()) == 0.0


def decode_inputs(n=4):
    p = numpy_params(CFG, seed=11)
    frames, mask = numpy_frames(CFG, n, seed=12)
    mask[2, 3:] = 0.0
    return p, frames, mask, numpy_regions(CFG, n, seed=13)


def jax_decode(kind):
    p, frames, mask, regions = decode_inputs()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    batch = {"frames": jnp.asarray(frames), "frame_mask": jnp.asarray(mask),
             "regions": jnp.asarray(regions)}
    if kind == "greedy":
        out = jax_greedy(jp, CFG, batch, maxlen=MAXLEN)
    else:
        out = jbeam.beam_decode(jp, CFG, batch, beam_size=3, maxlen=MAXLEN)
    return {f: np.asarray(v) for f, v in out._asdict().items()
            if v is not None}


@pytest.fixture(scope="module")
def jax_decodes():
    return {kind: jax_decode(kind) for kind in ("greedy", "beam")}


def torch_batch():
    _, frames, mask, regions = decode_inputs()
    return {"frames": torch.from_numpy(frames),
            "frame_mask": torch.from_numpy(mask),
            "regions": torch.from_numpy(regions)}


@pytest.mark.parametrize("step", sorted(STEPS))
def test_spatial_greedy_matches_jax(step, jax_decodes):
    p = decode_inputs()[0]
    out = greedy_decode(params_from_numpy(p, "cpu"), CFG, torch_batch(),
                        maxlen=MAXLEN, step_fn=STEPS[step])
    ref = jax_decodes["greedy"]
    np.testing.assert_array_equal(out.tokens.numpy(), ref["tokens"])
    np.testing.assert_array_equal(out.lengths.numpy(), ref["lengths"])
    np.testing.assert_allclose(out.scores.numpy(), ref["scores"], **TOL)


@pytest.mark.parametrize("step", sorted(STEPS))
def test_spatial_beam_matches_jax(step, jax_decodes):
    p = decode_inputs()[0]
    out = tbeam.beam_decode(params_from_numpy(p, "cpu"), CFG, torch_batch(),
                            beam_size=3, maxlen=MAXLEN, step_fn=STEPS[step])
    ref = jax_decodes["beam"]
    for f in ("tokens", "lengths", "all_tokens"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), ref[f], f)
    for f in ("scores", "norm_scores", "all_scores", "all_norm_scores"):
        np.testing.assert_allclose(getattr(out, f).numpy(), ref[f],
                                   err_msg=f, **TOL)


def request(n, seed):
    """Per-video frames and regions with frame counts around K."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(2, 2 * CFG.n_frames, size=n)
    feats = [rng.randn(int(f), CFG.ctx_dim).astype(np.float32)
             for f in counts]
    regs = [rng.randn(int(f), CFG.n_regions, CFG.region_dim)
            .astype(np.float32) for f in counts]
    return feats, regs


@pytest.mark.parametrize("beam", [1, 3])
def test_spatial_caption_matches_jax_captioner(beam):
    vocab = Vocab({f"w{i}": i for i in range(2, CFG.n_words)})
    cfg = Config(model=CFG, decode=DecodeConfig(beam_size=beam, maxlen=8,
                                                decode_batch=3))
    p = numpy_params(CFG, seed=22)
    feats, regs = request(5, seed=23)
    ref = japi.Captioner({k: jnp.asarray(v) for k, v in p.items()}, cfg,
                         vocab).caption(feats, regions=regs)
    got = tapi.Captioner(p, cfg, vocab, device="cpu").caption(
        feats, regions=regs)
    assert got == ref
    assert len(got) == 5 and any(got)


def test_pack_request_with_regions_matches_jax():
    cfg = dataclasses.replace(CFG, compute_dtype="bfloat16")
    feats, regs = request(4, seed=24)
    ref = japi.pack_request(cfg, feats, regions=regs)
    got = tapi.pack_request(cfg, feats, regs, device="cpu")
    assert sorted(got) == sorted(ref) == ["frame_mask", "frames", "regions"]
    assert got["regions"].dtype == torch.bfloat16
    for k in got:
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(ref[k], np.float32))
