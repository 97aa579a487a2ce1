"""The port's CUDA kernels against their plain versions, on the card.

Skips without a CUDA device.  Ragged shapes here (odd batch, K > 32,
R > 32, widths not a multiple of 4, vocab not a multiple of the tile,
rows, depths and dims not a multiple of the row, depth and dim tiles)
complement chip_smoke.py, which checks the kernels at the serving shapes.
This file imports no jax, so it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from stvd_torch.model import kernel as tkernel
from stvd_torch.model import step as tstep

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def exact_tail_inputs(rows, dw, v, dtype, device, seed=0):
    """Inputs whose logits are exact in float32 whatever the order of
    the sums (multiples of 1/16, magnitude < 2^20), so the top-k columns
    must agree exactly, ties included."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-1, 2, (rows, dw)).astype(np.float32)
    w = (rng.randint(-8, 9, (dw, v)) / 16.0).astype(np.float32)
    b = (rng.randint(-64, 65, v) / 16.0).astype(np.float32)
    return (torch.from_numpy(x).to(device, dtype),
            torch.from_numpy(w).to(device, dtype),
            torch.from_numpy(b).to(device))


@pytest.mark.parametrize("nb,k,ctx_dtype,selector", [
    (1, 5, torch.float32, True), (3, 40, torch.bfloat16, False),
    (8, 28, torch.bfloat16, True)])
def test_attention_core_kernel_matches_plain(cuda, nb, k, ctx_dtype,
                                             selector):
    g = torch.Generator(device=cuda).manual_seed(nb)
    bc, a, dc = 7, 100, 300
    hp = torch.randn(bc * nb, a + 1, generator=g, device=cuda)
    pctx = torch.randn(bc, k, a, generator=g, device=cuda)
    ctx = torch.randn(bc, k, dc, generator=g, device=cuda).to(ctx_dtype)
    mask = (torch.rand(bc, k, generator=g, device=cuda) > 0.3).float()
    mask[:, 0] = 1.0
    mask[2] = 0.0
    u = torch.randn(a, generator=g, device=cuda) / a ** 0.5
    c_att = torch.tensor(0.1, device=cuda)
    b_sel = torch.tensor(-0.3, device=cuda)
    args = (hp[:, :a], hp[:, a], pctx, ctx, mask, u, c_att, b_sel, selector)
    before = tkernel.attention_core.launches
    got = tkernel.attention_core(*args)
    ref = tstep._attention_core(*args)
    torch.cuda.synchronize()
    assert tkernel.attention_core.launches == before + 1
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5)
    assert float(got[1][2 * nb:3 * nb].abs().max()) == 0.0


@pytest.mark.parametrize("rows,dw,v,k,dtype", [
    (1, 40, 9, 8, torch.bfloat16), (67, 128, 300, 5, torch.bfloat16),
    (130, 96, 1000, 1, torch.float32), (64, 512, 2053, 5, torch.float32)])
def test_logit_tail_kernel_matches_plain(cuda, rows, dw, v, k, dtype):
    x, w, b = exact_tail_inputs(rows, dw, v, dtype, cuda)
    before = tkernel.logit_tail.launches
    vals, idx, lse = tkernel.logit_tail(x, w, b, k)
    rv, ri, rl = tkernel._logit_tail_plain(x, w, b, k)
    torch.cuda.synchronize()
    assert tkernel.logit_tail.launches == before + 1
    assert torch.equal(idx, ri)
    assert torch.equal(vals, rv)
    torch.testing.assert_close(lse, rl, rtol=1e-5, atol=1e-4)


def test_logit_tail_kernel_zero_weights_pick_lowest_columns(cuda):
    x = torch.randn(33, 64, device=cuda).bfloat16()
    w = torch.zeros(64, 700, device=cuda).bfloat16()
    b = torch.zeros(700, device=cuda)
    vals, idx, lse = tkernel.logit_tail(x, w, b, 8)
    assert torch.equal(idx.cpu(), torch.arange(8).expand(33, 8))
    assert float(vals.abs().max()) == 0.0
    torch.testing.assert_close(lse.cpu(), torch.full((33,), np.log(700.0)))


@pytest.mark.parametrize("nb,r,s,dr,reg_dtype", [
    (1, 7, 12, 10, torch.float32), (3, 49, 130, 67, torch.bfloat16),
    (8, 37, 13, 301, torch.bfloat16), (5, 49, 1024, 1024, torch.bfloat16)])
def test_spatial_core_kernel_matches_plain(cuda, nb, r, s, dr, reg_dtype):
    """h_satt is a strided column slice of a wider projection, as in the
    step; the plain version runs at float32 on the same inputs."""
    g = torch.Generator(device=cuda).manual_seed(r)
    bc, k = 3, 5
    hp = torch.randn(bc * nb, s + 9, generator=g, device=cuda)
    pregion = torch.randn(bc, k, r, s, generator=g, device=cuda)
    regions = torch.randn(bc, k, r, dr, generator=g, device=cuda).to(reg_dtype)
    u = 3.0 * torch.randn(s, generator=g, device=cuda) / s ** 0.5
    c_s = torch.tensor(0.3, device=cuda)
    args = (hp[:, 9:], pregion, regions, u, c_s)
    before = tkernel.spatial_core.launches
    got = tkernel.spatial_core(*args, torch.float32)
    ref = tstep._spatial_core(*args, torch.float32)
    torch.cuda.synchronize()
    assert tkernel.spatial_core.launches == before + 1
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y.float(), rtol=1e-4, atol=1e-5)


def gates_operands(rows, kx, dim, mode, device, seed=0):
    """(x, w, b, c, s_r, scale) for one gates+LSTM call in ``mode``; int8
    operands are quantized with the step's own helpers."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(rows, kx, generator=g, device=device)
    w = torch.randn(kx, 4 * dim, generator=g, device=device) / kx ** 0.5
    b = torch.randn(4 * dim, generator=g, device=device)
    c = torch.randn(rows, dim, generator=g, device=device)
    if mode == "int8":
        x_q, s_r = tstep.quantize_rows(x)
        w_q, scale = tstep.quantize_weights(w)
        return x_q, w_q, b, c, s_r, scale
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    return x.to(dtype), w.to(dtype), b, c, None, None


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("rows,kx,dim", [
    (1, 16, 8), (37, 272, 128), (185, 277, 100), (130, 5120, 35)])
def test_gates_lstm_kernel_matches_plain(cuda, mode, rows, kx, dim):
    """Ragged rows, depths and dims in every mode; kx 277 and dim 35/100
    take the element-load path.  The int8 sums are exact, so int8 is held
    to 1e-5."""
    ops = gates_operands(rows, kx, dim, mode, cuda, seed=rows)
    before = tkernel.gates_lstm.launches
    got = tkernel.gates_lstm(*ops)
    ref = tstep._gates_lstm(*ops)
    torch.cuda.synchronize()
    assert tkernel.gates_lstm.launches == before + 1
    tol = 1e-5 if mode == "int8" else 1e-4
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=tol, atol=tol)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError):
        tkernel.logit_tail(torch.zeros(4, 8, device=cuda),
                           torch.zeros(8, 16, device=cuda,
                                       dtype=torch.float16),
                           torch.zeros(16, device=cuda), 2)
    with pytest.raises(ValueError):            # 9 beams of one context row
        tkernel.attention_core(
            torch.zeros(9, 4, device=cuda), torch.zeros(9, device=cuda),
            torch.zeros(1, 3, 4, device=cuda),
            torch.zeros(1, 3, 5, device=cuda),
            torch.ones(1, 3, device=cuda), torch.zeros(4, device=cuda),
            torch.tensor(0.0, device=cuda), torch.tensor(0.0, device=cuda),
            True)
    with pytest.raises(ValueError):            # 9 beams of one context row
        tkernel.spatial_core(
            torch.zeros(9, 4, device=cuda), torch.zeros(1, 2, 3, 4,
                                                        device=cuda),
            torch.zeros(1, 2, 3, 5, device=cuda),
            torch.zeros(4, device=cuda), torch.tensor(0.0, device=cuda),
            torch.float32)
    with pytest.raises(ValueError):            # int8 without its scales
        tkernel.gates_lstm(
            torch.zeros(4, 8, device=cuda, dtype=torch.int8),
            torch.zeros(8, 16, device=cuda, dtype=torch.int8),
            torch.zeros(16, device=cuda), torch.zeros(4, 4, device=cuda))
    with pytest.raises(ValueError):            # mixed operand dtypes
        tkernel.gates_lstm(
            torch.zeros(4, 8, device=cuda),
            torch.zeros(8, 16, device=cuda, dtype=torch.bfloat16),
            torch.zeros(16, device=cuda), torch.zeros(4, 4, device=cuda))
