"""The reference-exact recipes (``recipes/*.json``: dim 3518, dim_word
468, vocab 13010 / 20000) in the port, on the CPU.

None of those widths is a multiple of 8, and the Hopper routes of
kernels 2 and 3 read their operands through TMA maps whose row strides
must be whole 16 bytes.  The port therefore keeps those operands in rows
padded to 128 bytes (``step.padded``, ``pad_cols``, ``kmajor``): the
decode step's [emb | h | ctx] block and its int8 quantization, the gates
stack as its K-major transpose, the int8 grid, and the vocab projection
W once a decode call.  Held here:

* each recipe loads in the port equal to the JAX package's config;
* at small ragged widths (dim_word, dim, Kx and the vocab off the 8- and
  16-element grids) the port's beam decode (plain and kernel step, float32
  and int8) gives the JAX package's tokens, scores within 1e-5, and the
  scheduled-sampling loss, which runs the decode branch under autograd,
  gives JAX's loss within 1e-5 relative and every gradient within 1e-5 of
  the largest;
* the padding helpers give views equal to the unpadded tensors, row
  strides a whole 128 bytes (64 bf16, 128 int8 elements), zero tails;
* at the recipe shapes the routes of kernels 2 and 3 on padded storage
  are wgmma, kernel 6 keeps its wmma route; the custom ops' fakes take
  the strided operands;
* each C entry point's parameter count matches its ctypes signature.
"""

import dataclasses
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stvd.config import Config as JConfig
from stvd.decode import beam as jbeam
from stvd_torch import _build
from stvd_torch import config as tconfig
from stvd_torch.decode import beam as tbeam
from stvd_torch.model import kernel as tkernel
from stvd_torch.model import step as tstep
from stvd_torch.model.convert import params_from_numpy

from conftest import small_cfg
from test_torch_step import numpy_frames, numpy_params
from test_torch_train import (assert_matches_jax, batches, jax_loss_and_grads,
                              torch_loss_and_grads, use_jax_coins)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = ("msvd", "msvd_fast", "msrvtt")
BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8
# dim_word 13, dim 21, ctx 29: Kx 63, off the 8- and 16-element grids;
# vocab 53 off the 8-element grid (the synthetic captions use ids < 48)
RAGGED = dict(n_words=53, dim_word=13, dim=21, ctx_dim=29, n_frames=6,
              use_dropout=False)
TOL = dict(rtol=1e-5, atol=1e-5)
STEPS = {"plain": tstep.step, "kernels": tkernel.step_kernels}


def recipe(name, package=tconfig.Config):
    with open(os.path.join(REPO, "recipes", f"{name}.json")) as f:
        return package.from_json(f.read())


def round_up(n, m):
    return -(-n // m) * m


# ---------------------------------------------------------------------------
# The recipes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", RECIPES)
def test_recipe_loads_equal_to_the_jax_config(name):
    """``Config.from_json`` of a recipe gives the JAX package's config,
    field for field, at the reference's widths."""
    got, want = recipe(name), recipe(name, JConfig)
    assert json.loads(got.to_json()) == json.loads(want.to_json())
    m = got.model
    assert (m.dim, m.dim_word) == (3518, 468)
    assert m.n_words == (20000 if name == "msrvtt" else 13010)


def recipe_shapes(name):
    """(rows, dw, V, Kx, dim) of a recipe's decode step."""
    cfg = recipe(name)
    m, d = cfg.model, cfg.decode
    return (d.decode_batch * d.beam_size, m.dim_word, m.n_words,
            m.dim_word + m.dim + m.ctx_dim, m.dim)


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_routes_on_padded_storage(name):
    """At a recipe's shapes, its operands in the padded layouts (meta
    tensors: strides without storage) take kernels 2 and 3's wgmma
    routes, bf16 and int8; dense, the ragged widths keep the wmma
    route."""
    rows, dw, v, kx, dim = recipe_shapes(name)
    meta = "meta"
    x = tstep.padded(rows, dw, BF16, meta)
    w = tstep.pad_cols(torch.empty(dw, v, dtype=BF16, device=meta))
    assert (x.stride(0), w.stride(0)) == (round_up(dw, 64), round_up(v, 64))
    assert tkernel.logit_tail_route(rows, dw, v, BF16, 0, 0, x.stride(0),
                                    w.stride(0)) == "wgmma"
    assert tkernel.logit_tail_route(rows, dw, v, BF16, 0, 0) == "wmma"
    for dtype, per in ((BF16, 64), (I8, 128)):
        xk = tstep.padded(rows, kx, dtype, meta)
        wk = tstep.kmajor([torch.empty(kx, 4 * dim, dtype=dtype,
                                       device=meta)], dtype)
        assert wk.shape == (kx, 4 * dim)
        assert xk.stride(0) == wk.t().stride(0) == round_up(kx, per)
        assert tkernel.gates_route(rows, kx, dim, dtype, 0, 0, xk.stride(0),
                                   wk.t().stride(0)) == "wgmma"
        assert tkernel.gates_route(rows, kx, dim, dtype, 0, 0) == "wmma"


def test_msrvtt_recipe_keeps_the_train_tails_wmma_route():
    """Kernel 6 keeps its route rule: at the MSR-VTT recipe's dim 3518
    its gate blocks start off 16-byte boundaries of Wc."""
    cfg = recipe("msrvtt")
    m = cfg.model
    assert tkernel.train_tail_route(cfg.train.batch_size, m.ctx_dim, m.dim,
                                    BF16, 0, 0) == "wmma"


# ---------------------------------------------------------------------------
# The padding helpers
# ---------------------------------------------------------------------------

def whole_rows(t):
    """The padded buffer behind a ``padded`` view: its rows, tails too."""
    return t.as_strided((t.shape[0], t.stride(0)), (t.stride(0), 1))


@pytest.mark.parametrize("dtype,per", [(BF16, 64), (I8, 128), (F32, 32)])
@pytest.mark.parametrize("cols", [1, 8, 13, 64, 130])
def test_padded_rows_are_whole_128_bytes_with_zero_tails(dtype, per, cols):
    t = tstep.padded(5, cols, dtype, "cpu")
    assert t.shape == (5, cols) and t.stride() == (round_up(cols, per), 1)
    assert t.data_ptr() % 16 == 0
    tail = whole_rows(t)[:, cols:]
    assert tail.numel() == 0 or not bool(tail.any())


@pytest.mark.parametrize("dtype", [BF16, I8, F32])
@pytest.mark.parametrize("cols", [13, 64, 128, 130])
def test_pad_cols_copies_only_ragged_rows(dtype, cols):
    src = (torch.arange(5 * cols) % 100).reshape(5, cols).to(dtype)
    got = tstep.pad_cols(src)
    assert torch.equal(got, src)
    per = 128 // src.element_size()
    assert (got is src) == (cols % per == 0)
    assert got.stride(0) % per == 0 and got.stride(1) == 1
    assert not bool(whole_rows(got)[:, cols:].any())
    assert tstep.pad_cols(got) is got


@pytest.mark.parametrize("dtype", [BF16, I8, F32])
def test_kmajor_stack_is_the_concatenation(dtype):
    """``kmajor`` of row blocks equals their concatenation; it is the view
    of a K-major transpose with rows padded to 128 bytes, zero past K."""
    rng = np.random.RandomState(3)
    blocks = [torch.from_numpy(rng.randint(-9, 10, (k, 20)).astype(
        np.float32)) for k in (13, 21, 29)]
    got = tstep.kmajor(blocks, dtype)
    assert got.dtype == dtype and got.shape == (63, 20)
    per = 128 // got.element_size()
    assert got.stride() == (1, round_up(63, per))
    assert torch.equal(got, torch.cat(blocks).to(dtype))
    assert not bool(whole_rows(got.t())[:, 63:].any())


def test_quantize_rows_pads_x_q():
    x = torch.from_numpy(np.random.RandomState(4).randn(7, 63).astype(
        np.float32))
    x_q, s_r = tstep.quantize_rows(x)
    assert x_q.dtype == I8 and x_q.stride() == (128, 1)
    want = torch.clamp(torch.round(x / s_r), -127, 127).to(I8)
    assert torch.equal(x_q, want)
    assert not bool(whole_rows(x_q)[:, 63:].any())


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_precompute_stacks_padded_kmajor_weights(quant):
    """The decode context's gates stack (and int8 grid) at ragged widths:
    the concatenation [W; U; Wc], K-major, rows padded to 128 bytes."""
    cfg = tconfig.ModelConfig(**dict(RAGGED, compute_dtype="float32",
                                     decode_quant=quant))
    p = params_from_numpy(numpy_params(small_cfg(**RAGGED), seed=5), "cpu")
    frames, mask = numpy_frames(small_cfg(**RAGGED), 3, seed=6)
    sc = tstep.precompute(p, cfg, torch.from_numpy(frames),
                          torch.from_numpy(mask))
    kx = cfg.dim_word + cfg.dim + cfg.ctx_dim
    assert torch.equal(sc.gates_w, torch.cat([p["W"], p["U"], p["Wc"]]))
    assert sc.gates_w.stride() == (1, round_up(kx, 32))
    if quant == "int8":
        assert sc.gates_w_q.stride() == (1, round_up(kx, 128))
        assert not bool(whole_rows(sc.gates_w_q.t())[:, kx:].any())


def test_logit_tail_on_padded_rows_equals_dense():
    """The plain logit tail (the CPU side of ``make_logit_tail``) on a
    padded W equals it on the dense W, ties and all."""
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randint(-1, 2, (6, 13)).astype(np.float32))
    w = torch.from_numpy((rng.randint(-8, 9, (13, 45)) / 16).astype(
        np.float32))
    b = torch.from_numpy((rng.randint(-64, 65, 45) / 16).astype(np.float32))
    dense = tkernel.logit_tail(x, w, b, 5)
    tail = tkernel.make_logit_tail(w, b, 5)
    padded = tail(x)
    for g, r in zip(padded, dense):
        assert torch.equal(g, r)


# ---------------------------------------------------------------------------
# Ragged widths against the JAX package
# ---------------------------------------------------------------------------

def ragged_inputs(cfg, n=4):
    p = numpy_params(cfg, seed=21)
    frames, mask = numpy_frames(cfg, n, seed=22)
    mask[1, 2:] = 0.0
    return p, frames, mask


@pytest.mark.parametrize("step", sorted(STEPS))
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_ragged_beam_decode_matches_jax(quant, step):
    """Beam decode at ragged widths through the padded layouts (float32,
    and W8A8 int8 with the gates hook on): the JAX package's tokens,
    scores within 1e-5."""
    jcfg = small_cfg(**RAGGED, decode_quant=quant,
                     gates_kernel="on" if quant == "int8" else "off")
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    p, frames, mask = ragged_inputs(jcfg)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ref = jbeam.beam_decode(jp, jcfg, {"frames": jnp.asarray(frames),
                                       "frame_mask": jnp.asarray(mask)},
                            beam_size=3, maxlen=8)
    out = tbeam.beam_decode(params_from_numpy(p, "cpu"), tcfg,
                            {"frames": torch.from_numpy(frames),
                             "frame_mask": torch.from_numpy(mask)},
                            beam_size=3, maxlen=8, step_fn=STEPS[step])
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores),
                               **TOL)
    np.testing.assert_allclose(out.all_scores.numpy(),
                               np.asarray(ref.all_scores), **TOL)


@pytest.mark.parametrize("step", sorted(STEPS))
def test_ragged_scheduled_sampling_loss_matches_jax(monkeypatch, step):
    """The scheduled-sampling scan runs the decode branch (the padded
    [emb | h | ctx] block and K-major stack) under autograd: loss within
    1e-5 relative, every gradient within 1e-5 of the largest."""
    jcfg = small_cfg(**RAGGED)
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    p = numpy_params(jcfg)
    jb, tb = batches(jcfg)
    use_jax_coins(monkeypatch, 0.5, tb)
    ref = jax_loss_and_grads("ragged", jcfg, p, jb, 0.5)
    got = torch_loss_and_grads(tcfg, p, tb, 0.5, STEPS[step])
    assert_matches_jax(got, ref)


# ---------------------------------------------------------------------------
# The custom ops and the C entry points
# ---------------------------------------------------------------------------

def test_custom_op_fakes_take_strided_operands():
    """Under fake CUDA tensors (an export's tracing), kernels 2 and 3's
    custom ops take the padded operands at the MSR-VTT recipe's shapes
    and give outputs of the right shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from stvd_torch.export_aot import _GuardFreeMethods
    rows, dw, v, kx, dim = recipe_shapes("msrvtt")
    with _GuardFreeMethods(), FakeTensorMode():
        x = tstep.padded(rows, dw, BF16, "cuda")
        w = tstep.padded(dw, v, BF16, "cuda")
        b = torch.empty(v, device="cuda")
        vals, idx, lse = tkernel._logit_tail_op(x, w, b, 5)
        shapes = [tuple(vals.shape), tuple(idx.shape), tuple(lse.shape)]
        for dtype in (BF16, I8):
            xg = tstep.padded(rows, kx, dtype, "cuda")
            wg = tstep.padded(4 * dim, kx, dtype, "cuda").t()
            c = torch.empty(rows, dim, device="cuda")
            bg = torch.empty(4 * dim, device="cuda")
            sr = torch.empty(rows, 1, device="cuda") if dtype == I8 else None
            sc = torch.empty(4 * dim, device="cuda") if dtype == I8 else None
            h_t, c_t = tkernel._gates_lstm_op(xg, wg, bg, c, sr, sc)
            shapes += [tuple(h_t.shape), tuple(c_t.shape)]
    assert shapes == [(rows, 5), (rows, 5), (rows,)] + [(rows, dim)] * 4


def entry_arity(source, name):
    text = (_build._CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    return len(m.group(1).split(","))


@pytest.mark.parametrize("source,name", [
    ("logit_tail.cu", "stvd_logit_tail"),
    ("gates_lstm.cu", "stvd_gates_lstm"),
    ("train_tail.cu", "stvd_train_tail"),
    ("dws_gemm.cu", "stvd_dws_gemm")])
def test_c_entry_points_match_their_ctypes_signatures(source, name):
    """ctypes passes each argument by the signature's type: a count that
    drifted from the C entry would shift every argument after it."""
    assert entry_arity(source, name) == len(_build._SIGNATURES[name])
