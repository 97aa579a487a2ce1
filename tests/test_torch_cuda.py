"""The port's CUDA kernels against their plain versions, on the card.

Skips without a CUDA device.  Ragged shapes here (odd batch, K > 32,
R > 32, widths not a multiple of 4, vocab not a multiple of the tile,
rows, depths and dims not a multiple of the row, depth and dim tiles,
unaligned bases) complement chip_smoke.py, which checks the kernels at
the main paths' shapes; the kernels with routes are held to the route
each shape must take.
This file imports no jax, so it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import dataclasses

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


def attention_inputs(bc, nb, k, a, dc, ctx_dtype, device, seed):
    """Kernel 1's operands: h_att and beta_logit are columns of one wider
    projection (strided rows, as in the step), about 30 % of the frames
    masked (frame 0 never), row 2 fully masked, and row 1 with the frames
    of the last CTA of its cluster split masked."""
    g = torch.Generator(device=device).manual_seed(seed)
    hp = torch.randn(bc * nb, a + 1, generator=g, device=device)
    pctx = torch.randn(bc, k, a, generator=g, device=device)
    ctx = torch.randn(bc, k, dc, generator=g, device=device).to(ctx_dtype)
    mask = (torch.rand(bc, k, generator=g, device=device) > 0.3).float()
    mask[:, 0] = 1.0
    splits, kc = tkernel.attention_core_split(k, nb, a, dc,
                                              ctx.element_size())
    mask[1, (splits - 1) * kc:] = 0.0
    mask[2] = 0.0
    u = torch.randn(a, generator=g, device=device) / a ** 0.5
    c_att = torch.tensor(0.1, device=device)
    b_sel = torch.tensor(-0.3, device=device)
    return hp[:, :a], hp[:, a], pctx, ctx, mask, u, c_att, b_sel


def check_attention(args, selector, route):
    """One attention-core call on ``route`` against the plain version;
    the fully-masked row 2 must give zeros."""
    nb = args[0].shape[0] // args[2].shape[0]
    before = tkernel.attention_core.launches
    by_route = dict(tkernel.attention_core.launches_by_route)
    got = tkernel.attention_core(*args, selector)
    ref = tstep._attention_core(*args, selector)
    torch.cuda.synchronize()
    assert tkernel.attention_core.launches == before + 1
    assert (tkernel.attention_core.launches_by_route[route]
            == by_route[route] + 1)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5)
    assert float(got[1][2 * nb:3 * nb].abs().max()) == 0.0
    assert float(got[0][2 * nb:3 * nb].abs().max()) == 0.0


@pytest.mark.parametrize("bc,nb,k,a,dc,ctx_dtype,selector,route", [
    (7, 1, 5, 100, 300, torch.float32, True, "simple"),
    (7, 3, 40, 100, 300, torch.bfloat16, False, "simple"),
    (7, 8, 28, 100, 300, torch.bfloat16, True, "simple"),
    (256, 5, 28, 1024, 1024, torch.bfloat16, True, "cluster"),
    (64, 1, 28, 1024, 1024, torch.bfloat16, True, "cluster"),
    (64, 1, 28, 1024, 1024, torch.float32, False, "cluster"),
    (9, 3, 1, 1024, 1024, torch.bfloat16, True, "cluster"),
    (9, 3, 29, 1024, 1024, torch.bfloat16, True, "cluster"),
    (9, 3, 40, 1024, 1024, torch.float32, True, "cluster"),
    (9, 3, 5, 1024, 1024, torch.bfloat16, True, "cluster"),
    (7, 8, 28, 1024, 1024, torch.bfloat16, True, "cluster"),
    (5, 2, 13, 136, 72, torch.bfloat16, True, "cluster"),
    (5, 4, 7, 520, 1000, torch.float32, True, "cluster")])
def test_attention_core_kernel_matches_plain(cuda, bc, nb, k, a, dc,
                                             ctx_dtype, selector, route):
    """The preset-3 shape (256, nb 5, K 28, A = Dc = 1024) and the
    training shape (64, nb 1) on the cluster route; K 1, 5, 29 and 40
    (splits of 1, 2, 8 and 10 frames, the last CTA short where 4 does not
    divide K), nb 8, A off the 256-column chunk (136, 520, and 1000
    float32 Dc); widths that are not multiples of 8 take the simple
    route."""
    check_attention(attention_inputs(bc, nb, k, a, dc, ctx_dtype, cuda,
                                     seed=k + nb), selector, route)


def test_attention_core_unaligned_base_takes_the_simple_route(cuda):
    """A pctx base one float past 16-byte alignment cannot feed 16-byte
    loads: the wrapper picks the simple route from the address."""
    h, beta, pctx, *rest = attention_inputs(6, 2, 28, 256, 256,
                                            torch.bfloat16, cuda, seed=4)
    flat = torch.empty(pctx.numel() + 1, device=cuda)
    flat[1:] = pctx.flatten()
    pctx = flat[1:].view(pctx.shape)
    assert pctx.is_contiguous() and pctx.data_ptr() % 16 != 0
    check_attention((h, beta, pctx, *rest), True, "simple")


@pytest.mark.parametrize("scale_p,scale_h", [(30.0, 1.0), (1.0, 25.0),
                                             (40.0, 40.0)])
def test_attention_core_out_of_range_inputs(cuda, scale_p, scale_h):
    """pctx or beam states past the product form's range (|x| above
    ~20.8 in every third context row, every second beam state): the warps
    whose units hold them take the single-exponent form, and the results
    still agree with the plain version."""
    h, beta, pctx, *rest = attention_inputs(64, 3, 28, 1024, 1024,
                                            torch.bfloat16, cuda, seed=21)
    pctx = pctx.clone()
    pctx[::3] *= scale_p
    h = h.clone()
    h[::2] *= scale_h
    check_attention((h, beta, pctx, *rest), True, "cluster")


@pytest.mark.parametrize("bc,nb,k,route", [
    (256, 5, 28, "cluster"), (64, 1, 28, "cluster"), (9, 3, 29, "cluster"),
    (256, 5, 28, "simple")])
def test_attention_core_kernel_is_deterministic(cuda, bc, nb, k, route):
    """Two calls on the same operands agree bit for bit: the cluster's
    partial sums are merged in rank order, with no atomics."""
    args = attention_inputs(bc, nb, k, 1024, 1024, torch.bfloat16, cuda,
                            seed=11)
    first = tkernel._attention_core_cuda(*args, True, route=route)
    second = tkernel._attention_core_cuda(*args, True, route=route)
    torch.cuda.synchronize()
    for p, q in zip(first, second):
        assert torch.equal(p, q)


@pytest.mark.parametrize("bc,nb,k,a,dc,ctx_dtype", [
    (256, 5, 28, 2048, 2048, torch.float32),
    (256, 5, 28, 2048, 2048, torch.bfloat16),
    (64, 1, 28, 2048, 2048, torch.float32),
    (64, 1, 28, 2048, 2048, torch.bfloat16),
    (9, 3, 29, 2048, 2048, torch.float32),
    (7, 8, 5, 1800, 2000, torch.float32),
    (6, 5, 28, 1024, 2048, torch.bfloat16),
    (6, 5, 28, 2048, 1024, torch.float32)])
def test_attention_core_kernel_at_preset_4_width(cuda, bc, nb, k, a, dc,
                                                 ctx_dtype):
    """Preset 4's width (A = Dc = 2048; the fused context float32, and
    bf16 beside it) on the cluster route's eight-warp CTA: the serving
    shape (256 rows, nb 5) and the training scan's (64, nb 1), K 29 and 5
    (a short last CTA), nb 8 with A and Dc off the 256-column chunk, and
    only one of A, Dc above 1024.  Against the plain core, and two calls
    bit for bit."""
    args = attention_inputs(bc, nb, k, a, dc, ctx_dtype, cuda, seed=k + nb)
    check_attention(args, True, "cluster")
    first = tkernel.attention_core(*args, False)
    second = tkernel.attention_core(*args, False)
    ref = tstep._attention_core(*args, False)
    torch.cuda.synchronize()
    for p, q, r in zip(first, second, ref):
        assert torch.equal(p, q)
        torch.testing.assert_close(p, r, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", [0, 1])
def test_device_tanh_matches_torch(cuda, mode):
    """The TMA cores' tanh against torch.tanh over a dense float32 grid
    of [-20, 20] and the special values: the product form of tanh(p + h)
    (p = 0.7 x, h = 0.3 x; mode 0) and the single-exponent form (mode 1),
    within 3e-7, exact at +-0 -> 0 and +-inf -> +-1, NaN kept."""
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                            float("nan"), 1e-30, -1e-30, 88.0, -88.0],
                           device=cuda)
    x = torch.cat([torch.linspace(-20, 20, 4_000_001, device=cuda), special])
    p, h = (x * 0.7, x * 0.3) if mode == 0 else (x, torch.zeros_like(x))
    y = device_tanh(p, h, mode)
    ref = torch.tanh(p.double() + h.double())
    finite = torch.isfinite(ref)
    assert float((y.double() - ref)[finite].abs().max()) < 3e-7
    assert torch.equal(y[-9:-5].cpu(), torch.tensor([0.0, 0.0, 1.0, -1.0]))
    assert bool(torch.isnan(y[-5]))


def device_tanh(p, h, mode):
    y = torch.empty_like(p)
    err = tkernel._build.lib().stvd_tanh_f32(
        p.data_ptr(), h.data_ptr(), y.data_ptr(), p.numel(), mode,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    return y


@pytest.mark.parametrize("t_max", [1.0, 20.0, 40.0])
def test_device_tanh_where_p_and_h_cancel(cuda, t_max):
    """p = fl(x + t), h = -t with t uniform on [-t_max, t_max] and x on a
    dense grid of [-20, 20]: p + h cancels, and each point's error stays
    within 3e-7 + 5e-8 (|p| + |h|) (C p and C h are each rounded); past
    |p| or |h| ~ 20.8 the single-exponent form takes over."""
    g = torch.Generator(device=cuda).manual_seed(int(t_max))
    x = torch.linspace(-20, 20, 4_000_001, device=cuda)
    t = t_max * (2 * torch.rand(x.shape, generator=g, device=cuda) - 1)
    p, h = x + t, -t
    err = (device_tanh(p, h, 0).double()
           - torch.tanh(p.double() + h.double())).abs()
    assert bool((err <= 3e-7 + 5e-8 * (p.abs() + h.abs()).double()).all())


def check_tail(x, w, b, k, route):
    """One logit-tail call on ``route`` against the plain version: the
    exact inputs' top-k values and columns must be equal, ties included;
    the logsumexp sums exp in another order."""
    before = tkernel.logit_tail.launches
    by_route = dict(tkernel.logit_tail.launches_by_route)
    vals, idx, lse = tkernel.logit_tail(x, w, b, k)
    rv, ri, rl = tkernel._logit_tail_plain(x, w, b, k)
    torch.cuda.synchronize()
    assert tkernel.logit_tail.launches == before + 1
    assert tkernel.logit_tail.launches_by_route[route] == by_route[route] + 1
    assert torch.equal(idx, ri)
    assert torch.equal(vals, rv)
    torch.testing.assert_close(lse, rl, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("rows,dw,v,k,dtype,route", [
    (1, 40, 9, 8, torch.bfloat16, "wmma"),
    (67, 128, 300, 5, torch.bfloat16, "wmma"),
    (130, 96, 1000, 1, torch.float32, "f32"),
    (64, 512, 2053, 5, torch.float32, "f32"),
    (1280, 512, 13056, 5, torch.bfloat16, "wgmma"),
    (1024, 512, 13056, 1, torch.bfloat16, "wgmma"),
    (1280, 512, 12995, 5, torch.bfloat16, "wmma"),
    (67, 128, 304, 5, torch.bfloat16, "wgmma"),
    (1, 40, 16, 8, torch.bfloat16, "wgmma"),
    (300, 72, 1000, 3, torch.bfloat16, "wgmma"),
    (129, 8, 520, 7, torch.bfloat16, "wgmma")])
def test_logit_tail_kernel_matches_plain(cuda, rows, dw, v, k, dtype, route):
    """The main shapes (rows 1280 at k 5, 1024 at k 1) and ragged ones:
    rows off the 128-row tile, vocabs off the 256-column strip, depths
    off the 64-deep stage; the ragged vocab 12995 and widths that are not
    whole 16 bytes take the wmma route."""
    check_tail(*exact_tail_inputs(rows, dw, v, dtype, cuda), k, route)


def test_logit_tail_unaligned_base_takes_the_wmma_route(cuda):
    """A base one element past 16-byte alignment cannot be a TMA tile's
    origin: the wrapper picks the wmma route from the address."""
    x, w, b = exact_tail_inputs(65, 64, 520, torch.bfloat16, cuda, seed=3)
    flat = torch.empty(w.numel() + 1, dtype=w.dtype, device=cuda)
    flat[1:] = w.flatten()
    w = flat[1:].view(w.shape)
    assert w.is_contiguous() and w.data_ptr() % 16 != 0
    check_tail(x, w, b, 5, "wmma")


@pytest.mark.parametrize("v,route", [(700, "wmma"), (704, "wgmma")])
def test_logit_tail_kernel_zero_weights_pick_lowest_columns(cuda, v, route):
    x = torch.randn(33, 64, device=cuda).bfloat16()
    w = torch.zeros(64, v, device=cuda).bfloat16()
    b = torch.zeros(v, device=cuda)
    by_route = dict(tkernel.logit_tail.launches_by_route)
    vals, idx, lse = tkernel.logit_tail(x, w, b, 8)
    assert tkernel.logit_tail.launches_by_route[route] == by_route[route] + 1
    assert torch.equal(idx.cpu(), torch.arange(8).expand(33, 8))
    assert float(vals.abs().max()) == 0.0
    torch.testing.assert_close(lse.cpu(), torch.full((33,), np.log(v)))


@pytest.mark.parametrize("v,k", [(13056, 5), (13056, 1), (12995, 5)])
def test_logit_tail_kernel_is_deterministic(cuda, v, k):
    """Two calls on the same gaussian operands agree bit for bit on the
    wgmma (V 13056) and wmma (12995) routes: every sum has a fixed order."""
    g = torch.Generator(device=cuda).manual_seed(v + k)
    x = torch.tanh(torch.randn(1280, 512, generator=g, device=cuda))
    w = (0.1 * torch.randn(512, v, generator=g, device=cuda)).bfloat16()
    b = torch.randn(v, generator=g, device=cuda)
    first = tkernel.logit_tail(x, w, b, k)
    second = tkernel.logit_tail(x, w, b, k)
    ref = tkernel._logit_tail_plain(x, w, b, k)
    torch.cuda.synchronize()
    for p, q, r in zip(first, second, ref):
        assert torch.equal(p, q)
    torch.testing.assert_close(first[0], ref[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(first[2], ref[2], rtol=0, atol=1e-4)


def spatial_inputs(bc, nb, k, r, s, dr, reg_dtype, device, seed):
    """Kernel 4's operands; h_satt is a strided column slice of a wider
    projection, as in the step."""
    g = torch.Generator(device=device).manual_seed(seed)
    hp = torch.randn(bc * nb, s + 9, generator=g, device=device)
    pregion = torch.randn(bc, k, r, s, generator=g, device=device)
    regions = torch.randn(bc, k, r, dr, generator=g,
                          device=device).to(reg_dtype)
    u = 3.0 * torch.randn(s, generator=g, device=device) / s ** 0.5
    c_s = torch.tensor(0.3, device=device)
    return hp[:, 9:], pregion, regions, u, c_s


def check_spatial(args, route):
    """One spatial-core call on ``route`` against the plain version at
    float32 on the same inputs."""
    before = tkernel.spatial_core.launches
    by_route = dict(tkernel.spatial_core.launches_by_route)
    got = tkernel.spatial_core(*args, torch.float32)
    ref = tstep._spatial_core(*args, torch.float32)
    torch.cuda.synchronize()
    assert tkernel.spatial_core.launches == before + 1
    assert tkernel.spatial_core.launches_by_route[route] == by_route[route] + 1
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y.float(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("bc,k,nb,r,s,dr,reg_dtype,route", [
    (3, 5, 1, 7, 12, 10, torch.float32, "simple"),
    (3, 5, 3, 49, 130, 67, torch.bfloat16, "simple"),
    (3, 5, 8, 37, 13, 301, torch.bfloat16, "simple"),
    (3, 5, 5, 49, 1024, 1024, torch.bfloat16, "tma"),
    (4, 28, 5, 49, 1024, 1024, torch.bfloat16, "tma"),
    (4, 28, 1, 49, 1024, 1024, torch.bfloat16, "tma"),
    (3, 29, 8, 37, 1024, 304, torch.bfloat16, "tma"),
    (2, 9, 8, 49, 1024, 1024, torch.float32, "tma"),
    (3, 1, 3, 1, 8, 8, torch.bfloat16, "tma"),
    (3, 8, 2, 33, 264, 72, torch.float32, "tma"),
    (2, 6, 4, 49, 1544, 1024, torch.bfloat16, "tma")])
def test_spatial_core_kernel_matches_plain(cuda, bc, k, nb, r, s, dr,
                                           reg_dtype, route):
    """The path-A shape (nb 5 and 1, K 28, R 49, s = Dr = 1024) and ragged
    ones on the tma route: K 29 (blocks of 6 frames, the last one short),
    nb 8, R 1, 33 and 37, s off the 256-column chunk (264, 1544: chunks
    rounded up to a power of two), Dr 72 and 304, float32 regions;
    widths that are not multiples of 8 take the simple route."""
    check_spatial(spatial_inputs(bc, nb, k, r, s, dr, reg_dtype, cuda,
                                 seed=r + k), route)


def test_spatial_core_unaligned_base_takes_the_simple_route(cuda):
    """A regions base one element past 16-byte alignment cannot be a bulk
    copy's source: the wrapper picks the simple route from the address."""
    h, pregion, regions, u, c_s = spatial_inputs(
        2, 6, 3, 49, 256, 128, torch.bfloat16, cuda, seed=6)
    flat = torch.empty(regions.numel() + 1, dtype=regions.dtype, device=cuda)
    flat[1:] = regions.flatten()
    regions = flat[1:].view(regions.shape)
    assert regions.is_contiguous() and regions.data_ptr() % 16 != 0
    check_spatial((h, pregion, regions, u, c_s), "simple")


@pytest.mark.parametrize("scale_p,scale_h", [(30.0, 1.0), (1.0, 25.0),
                                             (40.0, 40.0)])
def test_spatial_core_out_of_range_inputs(cuda, scale_p, scale_h):
    """pregion or beam states past the product form's range (every second
    frame, every second beam state): those units take the single-exponent
    form, and the results still agree with the plain version."""
    h, pregion, regions, u, c_s = spatial_inputs(
        2, 5, 7, 49, 1024, 1024, torch.bfloat16, cuda, seed=22)
    pregion = pregion.clone()
    pregion[:, ::2] *= scale_p
    h = h.clone()
    h[::2] *= scale_h
    check_spatial((h, pregion, regions, u, c_s), "tma")


@pytest.mark.parametrize("nb,route", [(5, "tma"), (1, "tma"),
                                      (5, "simple")])
def test_spatial_core_kernel_is_deterministic(cuda, nb, route):
    """Two calls on the same operands agree bit for bit: partial scores
    are summed in a fixed order and every reduction has a fixed shape."""
    args = spatial_inputs(4, nb, 28, 49, 1024, 1024, torch.bfloat16, cuda,
                          seed=nb)
    first = tkernel._spatial_core_cuda(*args, route=route)
    second = tkernel._spatial_core_cuda(*args, route=route)
    torch.cuda.synchronize()
    for p, q in zip(first, second):
        assert torch.equal(p, q)


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


def gates_route_of(mode, kx, dim):
    """The route the wrapper must pick for aligned operands: rows of x a
    whole 16 bytes apart (bf16 x is dense here; int8 x comes padded to
    128 bytes from ``quantize_rows``), the stack copied to its padded
    K-major transpose where it is not one, which serves any dim."""
    if mode == "f32":
        return "f32"
    if mode == "int8":
        return "wgmma"
    return "wgmma" if kx % 8 == 0 else "wmma"


def check_gates(ops, mode, route):
    """One gates+LSTM call on ``route`` against the plain version.  The
    int8 sums are exact, so int8 is held to 1e-5; bf16 and float32 sums
    in another order to 1e-4."""
    before = tkernel.gates_lstm.launches
    by_route = dict(tkernel.gates_lstm.launches_by_route)
    got = tkernel.gates_lstm(*ops)
    ref = tstep._gates_lstm(*ops)
    torch.cuda.synchronize()
    assert tkernel.gates_lstm.launches == before + 1
    assert tkernel.gates_lstm.launches_by_route[route] == by_route[route] + 1
    tol = 1e-5 if mode == "int8" else 1e-4
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("rows,kx,dim", [
    (1, 16, 8), (37, 272, 128), (185, 277, 100), (130, 5120, 35),
    (1280, 5120, 3584), (300, 1040, 200), (129, 5120, 96), (37, 272, 100)])
def test_gates_lstm_kernel_matches_plain(cuda, mode, rows, kx, dim):
    """The path-B shape (1280, 5120, 3584) and ragged rows, depths and
    dims in every mode: rows off the 128-row tile, dims off the 64-dim
    strip, depths off the stage.  Dense bf16 x of kx 277 is off the
    16-byte grid TMA needs: the wmma route (int8 x comes padded); dims 35
    and 100 take wgmma, whose K-major gate blocks start at any row."""
    ops = gates_operands(rows, kx, dim, mode, cuda, seed=rows)
    check_gates(ops, mode, gates_route_of(mode, kx, dim))


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_gates_lstm_unaligned_base_takes_the_wmma_route(cuda, mode):
    """x one element past 16-byte alignment cannot be a TMA tile's
    origin: the wrapper picks the wmma route from the address."""
    x, *rest = gates_operands(65, 272, 64, mode, cuda, seed=7)
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    flat[1:] = x.flatten()
    x = flat[1:].view(x.shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    check_gates((x, *rest), mode, "wmma")


@pytest.mark.parametrize("mode,rows,kx,dim", [
    ("bf16", 1280, 5120, 3584), ("int8", 1280, 5120, 3584),
    ("bf16", 185, 277, 100)])
def test_gates_lstm_kernel_is_deterministic(cuda, mode, rows, kx, dim):
    """Two calls on the same operands agree bit for bit (wgmma at the
    path-B shape, wmma at a ragged one): every sum has a fixed order."""
    ops = gates_operands(rows, kx, dim, mode, cuda, seed=3)
    first = tkernel.gates_lstm(*ops)
    second = tkernel.gates_lstm(*ops)
    torch.cuda.synchronize()
    for p, q in zip(first, second):
        assert torch.equal(p, q)


# The reference recipes' shapes (recipes/*.json: dim 3518, dim_word 468,
# vocab 13010 / 20000; Kx 468 + 3518 + 1024 or 2048), decode batch 256 x
# beam 5 rows, on the padded layouts the port stores
RECIPE_TAILS = [(1280, 468, 13010), (1280, 468, 20000)]
RECIPE_GATES = [(1280, 5010, 3518), (1280, 6034, 3518)]


@pytest.mark.parametrize("rows,dw,v", RECIPE_TAILS)
@pytest.mark.parametrize("k", [5, 1])
def test_logit_tail_recipe_shapes_on_padded_rows(cuda, rows, dw, v, k):
    """Kernel 2 at the recipes' shapes: x and W in rows padded to 16
    bytes take wgmma and equal the plain version (top-k ids and values
    exactly on the exact-tie inputs); the dense operands (the wmma route)
    give the same values and ids."""
    x, w, b = exact_tail_inputs(rows, dw, v, torch.bfloat16, cuda, seed=v)
    xp, wp = tstep.pad_cols(x), tstep.pad_cols(w)
    assert xp.stride(0) % 8 == 0 and wp.stride(0) % 8 == 0
    check_tail(xp, wp, b, k, "wgmma")
    padded = tkernel.logit_tail(xp, wp, b, k)
    dense = tkernel._logit_tail_cuda(x, w, b, k, route="wmma")
    torch.cuda.synchronize()
    assert torch.equal(padded[0], dense[0])
    assert torch.equal(padded[1], dense[1])
    torch.testing.assert_close(padded[2], dense[2], rtol=1e-5, atol=1e-4)


def recipe_gates_operands(rows, kx, dim, mode, device, seed):
    """(x, w, b, c, s_r, scale) as the decode step stores them: x in rows
    padded to 16 bytes, the stack as its padded K-major transpose (int8:
    ``quantize_rows`` / ``quantize_weights``)."""
    x, w, b, c, s_r, scale = gates_operands(rows, kx, dim, mode, device,
                                            seed=seed)
    if mode != "int8":
        x, w = tstep.pad_cols(x), tstep.kmajor([w], w.dtype)
    per = 16 // x.element_size()
    assert x.stride(0) % per == 0 and w.t().stride(0) % per == 0
    return x, w, b, c, s_r, scale


@pytest.mark.parametrize("rows,kx,dim", RECIPE_GATES)
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_gates_lstm_recipe_shapes_on_padded_rows(cuda, mode, rows, kx, dim):
    """Kernel 3 at both recipes' gates shapes (Kx 5010 and 6034, dim
    3518), bf16 and int8, on the padded layouts: wgmma, equal to the plain
    version within 1e-4 (int8 1e-5); the dense operands (the wmma route)
    give the same within the same bound."""
    ops = recipe_gates_operands(rows, kx, dim, mode, cuda, seed=kx)
    check_gates(ops, mode, "wgmma")
    padded = tkernel.gates_lstm(*ops)
    dense = tkernel._gates_lstm_cuda(ops[0].contiguous(),
                                     ops[1].contiguous(), *ops[2:],
                                     route="wmma")
    torch.cuda.synchronize()
    tol = 1e-5 if mode == "int8" else 1e-4
    for p, q in zip(padded, dense):
        torch.testing.assert_close(p, q, rtol=tol, atol=tol)


@pytest.mark.parametrize("rows,kx,dim", RECIPE_GATES)
def test_plain_gates_over_the_padded_depth_at_recipe_shapes(cuda, rows, kx,
                                                            dim):
    """The plain bf16 gates (cuBLAS's float32-out product, then the LSTM
    pointwise) over the depth the decode step pads to (5056 and 6080,
    zero columns of x and rows of the K-major stack) against the float32
    plain version of the same bf16 values, within 1e-4, as over Kx."""
    x, w, b, c, _, _ = recipe_gates_operands(rows, kx, dim, "bf16", cuda,
                                             seed=kx)
    xw = tstep.padded_buffer(rows, kx, torch.bfloat16, cuda)
    xw[:, :kx].copy_(x)
    ww = tstep.kmajor_padded([w], torch.bfloat16)
    kp = -(-kx // 64) * 64
    assert xw.shape[1] == ww.shape[0] == kp > kx
    wide = tstep._gates_lstm(x, w, b, c, padded_ops=(xw, ww))
    narrow = tstep._gates_lstm(x, w, b, c)
    ref = tstep._gates_lstm(x.float(), w.float(), b, c)
    torch.cuda.synchronize()
    for got in (wide, narrow):
        for p, q in zip(got, ref):
            torch.testing.assert_close(p, q, rtol=1e-4, atol=1e-4)


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


# ---------------------------------------------------------------------------
# Training kernels: spatial backward step, train-scan tail, dWs_att GEMM
# ---------------------------------------------------------------------------

F32, BF16 = torch.float32, torch.bfloat16


def rel_err(got, ref) -> float:
    """Max abs difference over the reference's largest entry."""
    scale = max(float(ref.float().abs().max()), 1e-30)
    return float((got.float() - ref.float()).abs().max()) / scale


def spatial_bwd_inputs(b, k, r, s, dr, cd, acc, device):
    """(args without Dpe, Dpe) of one spatial backward step; h_satt is a
    column view of a wider projection, as in the scan."""
    g = torch.Generator(device=device).manual_seed(r + s)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=device)
    hp = rnd(b, s + 5)
    pregion = (0.5 * rnd(b, k, r, s)).to(cd)
    regions = rnd(b, k, r, dr).to(cd)
    alpha_s = torch.softmax(rnd(b, k, r), -1)
    alpha_prev = torch.softmax(rnd(b, k, r), -1)
    dspat, u_s = rnd(b, k, dr), rnd(s) / s ** 0.5
    dpe0 = (0.1 * rnd(b, k, r, s)).to(acc)
    return (hp[:, 5:], pregion, regions, alpha_s, alpha_prev, dspat,
            u_s), dpe0


@pytest.mark.parametrize("b,k,r,s,dr,cd,acc,route", [
    (1, 1, 1, 8, 8, F32, F32, "vector"),
    (3, 5, 49, 130, 67, BF16, BF16, "element"),
    (2, 7, 37, 1024, 1024, BF16, F32, "vector"),
    (5, 3, 49, 64, 96, F32, F32, "vector"),
    (4, 28, 49, 1024, 1024, BF16, BF16, "vector"),
    (2, 3, 1, 1024, 1024, BF16, BF16, "vector"),
    (2, 3, 64, 256, 128, BF16, F32, "vector"),
    (3, 1, 49, 1024, 1024, F32, F32, "vector"),
    (2, 4, 49, 1024, 72, BF16, BF16, "vector"),
    (2, 4, 49, 1024, 72, BF16, F32, "vector"),
    (2, 4, 49, 1024, 72, F32, F32, "vector"),
    (2, 3, 33, 1000, 10, F32, F32, "element")])
def test_spatial_bwd_kernel_matches_plain(cuda, b, k, r, s, dr, cd, acc,
                                          route):
    """R 1, 33, 37, 49 and 64, K 1, s = 1024 with Dr 72 (9 vectors: 8
    region lanes in the regions pass), widths that are not whole 16-byte
    vectors (element loads), all three dtype mixes; Dpe is updated in
    place.  float32: 1e-4 of the largest entry (sums in another order);
    bf16: 1e-2 (the kernel rounds where the plain version does, but tanh
    may differ by one bf16 ulp)."""
    args, dpe0 = spatial_bwd_inputs(b, k, r, s, dr, cd, acc, cuda)
    dpe_k, dpe_p = dpe0.clone(), dpe0.clone()
    before = tkernel.spatial_bwd.launches
    by_route = dict(tkernel.spatial_bwd.launches_by_route)
    got = tkernel.spatial_bwd(*args, dpe_k)
    ref = tkernel._spatial_bwd_plain(*args, dpe_p)
    torch.cuda.synchronize()
    assert tkernel.spatial_bwd.launches == before + 1
    assert tkernel.spatial_bwd.launches_by_route[route] == by_route[route] + 1
    tol = 1e-4 if cd == F32 else 1e-2
    for name, x, y in zip(("dpe", "dh_satt", "du_s", "dss", "spat_prev"),
                          (dpe_k, *got), (dpe_p, *ref)):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert rel_err(x, y) <= tol, (name, rel_err(x, y))


@pytest.mark.parametrize("cd,acc", [(F32, F32), (BF16, F32), (BF16, BF16)])
def test_spatial_bwd_kernel_is_deterministic(cuda, cd, acc):
    """Two calls on the same inputs (Dpe restored between them) agree bit
    for bit: every cross-thread and cross-block sum has a fixed order."""
    args, dpe0 = spatial_bwd_inputs(3, 28, 49, 1024, 1024, cd, acc, cuda)
    outs = []
    for _ in range(2):
        dpe = dpe0.clone()
        outs.append((dpe, *tkernel.spatial_bwd(*args, dpe)))
    torch.cuda.synchronize()
    for x, y in zip(*outs):
        assert torch.equal(x, y)


def train_tail_inputs(rows, dc, dim, cd, device):
    """x_pre is one step of a time-major view of a batch-major array and
    h_gates a column view of the h-projection, as in the scan."""
    g = torch.Generator(device=device).manual_seed(rows + dim)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=device)
    x_pre = rnd(rows, 3, 4 * dim).transpose(0, 1)[1]
    hp = rnd(rows, 4 * dim + 9)
    ctx_t, c = rnd(rows, dc), rnd(rows, dim)
    wc = (rnd(dc, 4 * dim) / dc ** 0.5).to(cd)
    return ctx_t, x_pre, hp[:, :4 * dim], c, wc, cd


@pytest.mark.parametrize("rows,dc,dim,cd,route", [
    (64, 1024, 3584, BF16, "wgmma"), (128, 1024, 3584, BF16, "wgmma"),
    (37, 272, 104, BF16, "wgmma"), (1, 16, 8, BF16, "wgmma"),
    (64, 1024, 3584, BF16, "wmma"), (128, 1024, 3584, BF16, "wmma"),
    (37, 272, 100, BF16, "wmma"), (1, 16, 8, BF16, "wmma"),
    (130, 277, 35, BF16, "wmma"), (130, 277, 35, F32, "f32"),
    (64, 1024, 128, F32, "f32")])
def test_train_tail_kernel_matches_plain(cuda, rows, dc, dim, cd, route):
    """Each route against the plain version: the training shape, two row
    tiles (128 rows), ragged rows, depths and dims (a partial 32-dim
    strip at dim 104 and 8; element loads on wmma at dc 277).  At dim
    100 Wc's gate blocks start off 16-byte boundaries, which TMA cannot
    load: that shape is wmma's (test_train_tail_takes_its_route)."""
    args = train_tail_inputs(rows, dc, dim, cd, cuda)
    before = tkernel.train_tail.launches
    by_route = dict(tkernel.train_tail.launches_by_route)
    got = tkernel._train_tail_cuda(*args, route=route)
    ref = tkernel._train_tail_plain(*args)
    torch.cuda.synchronize()
    assert tkernel.train_tail.launches == before + 1
    assert (tkernel.train_tail.launches_by_route[route]
            == by_route[route] + 1)
    for x, y in zip(got, ref):
        assert x.dtype == F32 and x.shape == y.shape
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rows,dc,dim,cd,offset,route", [
    (64, 1024, 3584, BF16, 0, "wgmma"), (37, 272, 104, BF16, 0, "wgmma"),
    (64, 1024, 3584, BF16, 1, "wmma"), (37, 272, 100, BF16, 0, "wmma"),
    (130, 277, 35, BF16, 0, "wmma"),
    (64, 1024, 128, F32, 0, "f32")])
def test_train_tail_takes_its_route(cuda, rows, dc, dim, cd, offset, route):
    """``train_tail`` launches on ``train_tail_route``'s route: a bf16
    ctx_t whose base is 2 bytes past a 16-byte boundary (``offset`` 1)
    takes 'wmma', as TMA cannot describe it, and still agrees."""
    ctx_t, *rest = train_tail_inputs(rows, dc, dim, cd, cuda)
    buf = torch.empty(rows * dc + offset, dtype=cd, device=cuda)
    ctx_c = buf[offset:].view(rows, dc)
    ctx_c.copy_(ctx_t)
    assert (tkernel.train_tail_route(rows, dc, dim, cd, ctx_c.data_ptr(),
                                     rest[-2].data_ptr()) == route)
    by_route = dict(tkernel.train_tail.launches_by_route)
    got = tkernel.train_tail(ctx_c, *rest)
    ref = tkernel._train_tail_plain(ctx_c, *rest)
    torch.cuda.synchronize()
    assert (tkernel.train_tail.launches_by_route[route]
            == by_route[route] + 1)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rows", [64, 128, 37])
def test_train_tail_wgmma_is_deterministic(cuda, rows):
    """Two calls on the same operands agree bit for bit: every sum has a
    fixed order (one block a tile, the depth in ring order)."""
    args = train_tail_inputs(rows, 1024, 3584, BF16, cuda)
    first = tkernel._train_tail_cuda(*args, route="wgmma")
    second = tkernel._train_tail_cuda(*args, route="wgmma")
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def check_dws(a, b, route):
    """One dWs_att GEMM call against the plain version, on ``route``.
    Both sum bf16 products in float32, in another order: 1e-4 of the
    largest entry."""
    before = tkernel.dws_gemm.launches
    by_route = dict(tkernel.dws_gemm.launches_by_route)
    got = tkernel.dws_gemm(a, b)
    ref = tkernel._dws_plain(a, b)
    torch.cuda.synchronize()
    assert tkernel.dws_gemm.launches == before + 1
    assert tkernel.dws_gemm.launches_by_route[route] == by_route[route] + 1
    assert got.dtype == F32 and got.shape == (a.shape[1], b.shape[1])
    assert rel_err(got, ref) <= 1e-4


@pytest.mark.parametrize("n,dr,s,dtype,route", [
    (1, 8, 8, BF16, "wgmma"), (1000, 24, 40, F32, "f32"),
    (777, 130, 67, BF16, "mma"), (20000, 1024, 1024, BF16, "wgmma"),
    (5000, 200, 136, F32, "f32"), (87808, 1024, 1024, BF16, "wgmma"),
    (1000, 128, 256, BF16, "wgmma"), (37, 64, 64, BF16, "wgmma"),
    (3000, 1000, 520, BF16, "wgmma"), (300, 8, 264, BF16, "wgmma"),
    (999, 130, 67, F32, "f32")])
def test_dws_gemm_kernel_matches_plain(cuda, n, dr, s, dtype, route):
    """The main shape (87808, 1024, 1024) and ragged ones: N not a
    multiple of the 64-row stage (1000, 20000, 3000) or below one stage
    (1, 37), Dr and s multiples of 8 but not of the 128 x 256 tile (1000 x
    520, 8 x 264); widths that are not whole 16-byte chunks (130 x 67)
    take the wmma route (bf16) or element loads (float32)."""
    g = torch.Generator(device=cuda).manual_seed(n)
    a = torch.randn(n, dr, generator=g, device=cuda).to(dtype)
    b = torch.randn(n, s, generator=g, device=cuda).to(dtype)
    check_dws(a, b, route)


def test_dws_gemm_unaligned_base_takes_the_mma_route(cuda):
    """A base one element past 16-byte alignment cannot be a TMA tile's
    origin: the wrapper picks the wmma route from the address."""
    g = torch.Generator(device=cuda).manual_seed(5)
    n, dr, s = 500, 64, 128
    flat = torch.randn(n * dr + 1, generator=g, device=cuda).to(BF16)
    a = flat[1:].view(n, dr)
    b = torch.randn(n, s, generator=g, device=cuda).to(BF16)
    assert a.is_contiguous() and a.data_ptr() % 16 != 0
    check_dws(a, b, "mma")


@pytest.mark.parametrize("n,dr,s,dtype", [
    (87808, 1024, 1024, BF16), (777, 130, 67, BF16), (5000, 200, 136, F32)])
def test_dws_gemm_kernel_is_deterministic(cuda, n, dr, s, dtype):
    """Two calls on the same operands agree bit for bit on every route:
    each split sums in a fixed order, and the splits are summed in order
    (no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(n)
    a = torch.randn(n, dr, generator=g, device=cuda).to(dtype)
    b = torch.randn(n, s, generator=g, device=cuda).to(dtype)
    first = tkernel.dws_gemm(a, b)
    second = tkernel.dws_gemm(a, b)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def tiny_train(cuda, spatial, **model):
    """A small config, its synthetic batch on the card and fresh leaves."""
    from stvd_torch.config import ModelConfig
    from stvd_torch.data.bank import to_device
    from stvd_torch.data.batching import gather_batch, synthetic_dataset
    from stvd_torch.model.decoder import init_params
    sp = dict(use_spatial=True, n_regions=5, region_dim=24) if spatial else {}
    cfg = ModelConfig(n_words=48, dim_word=16, dim=40, ctx_dim=32,
                      n_frames=6, compute_dtype="float32", use_dropout=False,
                      **sp, **model)
    ds = synthetic_dataset(n_videos=6, k=6, d=32, maxlen=9, seed=0,
                           n_regions=5 if spatial else 0, region_dim=24)
    batch = gather_batch(to_device(ds.bank, cuda), ds.captions,
                         np.arange(5, dtype=np.int32))
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    for p in params.values():
        with torch.no_grad():
            p.mul_(30.0)            # larger than the 0.01 init scale
    return cfg, batch, params


@pytest.mark.parametrize("spatial", [False, True])
def test_train_kernels_match_plain_gradients(cuda, spatial):
    """Loss and every gradient of a small model with every training
    kernel on against the plain path, float32 on the card; each kernel
    of the path launches once per step (the dWs_att GEMM once).  Weights
    at 30 times the init scale make the recurrence amplify float32
    rounding in other orders to ~1e-4 of a leaf: the bar is 1e-3.
    c_att and cs_att shift every score of a softmax alike, so their
    gradient is zero up to rounding: they are held to the bar of the
    largest gradient entry of the model."""
    from stvd_torch.train.loss import loss_fn
    on = dict(spatial_bwd_kernel="on", train_tail_kernel="on",
              train_fwd_kernel="on")
    off = dict(spatial_bwd_kernel="off", train_tail_kernel="off",
               train_fwd_kernel="off")
    out = {}
    for name, kw in (("kernel", on), ("plain", off)):
        cfg, batch, params = tiny_train(cuda, spatial, **kw)
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        counts = [f.launches for f in (tkernel.spatial_bwd,
                                       tkernel.train_tail, tkernel.dws_gemm,
                                       tkernel.attention_core)]
        loss, _ = loss_fn(leaves, cfg, batch, train=False)
        loss.backward()
        torch.cuda.synchronize()
        launched = [f.launches - c for f, c in zip(
            (tkernel.spatial_bwd, tkernel.train_tail, tkernel.dws_gemm,
             tkernel.attention_core), counts)]
        steps = batch["tokens"].shape[1]
        if name == "kernel":
            assert launched == ([steps, steps, 1, steps] if spatial
                                else [0, steps, 0, steps])
        else:
            assert launched == [0, 0, 0, 0]
        out[name] = (float(loss.detach()),
                     {k: v.grad for k, v in leaves.items()})
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    top = max(float(v.abs().max()) for v in gp.values())
    for k in gp:
        err = float((gk[k] - gp[k]).abs().max())
        scale = top if k in ("c_att", "cs_att") else float(
            gp[k].abs().max())
        assert err <= 1e-3 * scale, (k, err, scale)


def test_training_kernel_wrappers_reject_what_the_kernels_do_not_take(cuda):
    z = lambda *s, dtype=F32: torch.zeros(*s, device=cuda, dtype=dtype)
    with pytest.raises(ValueError):            # f32 compute, bf16 Dpe
        tkernel.spatial_bwd(z(1, 4), z(1, 2, 3, 4), z(1, 2, 3, 5),
                            z(1, 2, 3), z(1, 2, 3), z(1, 2, 5), z(4),
                            z(1, 2, 3, 4, dtype=BF16))
    with pytest.raises(ValueError):            # x_pre not float32
        tkernel.train_tail(z(2, 8), z(2, 16, dtype=BF16), z(2, 16), z(2, 4),
                           z(8, 16), F32)
    with pytest.raises(ValueError):            # mixed operand dtypes
        tkernel.dws_gemm(z(4, 8), z(4, 6, dtype=BF16))


def test_preset3_scan_at_a_bucket_length_matches_the_plain_tail(cuda):
    """Preset 3 at full width (bf16, dim 3584, ctx 1024, K 28), batch 64,
    cut to a length bucket of T 10 as bucketed training runs it: the
    loss and gradients with the train-scan tail kernel on (10 launches,
    all on wgmma) against the plain tail.  The two sum the tail in other
    orders, and a 1e-7 difference can flip a bf16 rounding downstream,
    which moves the small attention leaves (their largest entries are
    1e-4 to 1e-10 of the model's) by a few bf16 ulps of their own size:
    so every leaf is held to 1e-3 of the model's largest gradient entry,
    as the float32 test above holds c_att, and the loss to 1e-3
    relative."""
    from stvd_torch.config import preset
    from stvd_torch.data.bank import to_device
    from stvd_torch.data.batching import gather_batch, synthetic_dataset
    from stvd_torch.model.decoder import init_params
    from stvd_torch.train.loss import loss_fn
    cfg = preset("msvd-beam")
    m = cfg.model
    ds = synthetic_dataset(n_videos=64, k=m.n_frames, d=m.ctx_dim,
                           maxlen=cfg.train.maxlen, seed=0)
    batch = gather_batch(to_device(ds.bank, cuda, BF16), ds.captions,
                         np.arange(64, dtype=np.int32), seq_len=10)
    batch["weight"] = torch.ones(64, device=cuda)
    out = {}
    for tail in ("on", "off"):
        mc = dataclasses.replace(m, train_tail_kernel=tail,
                                 use_dropout=False)
        params = init_params(mc, torch.Generator(device=cuda).manual_seed(0),
                             cuda)
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        before = dict(tkernel.train_tail.launches_by_route)
        loss, _ = loss_fn(leaves, mc, batch, train=False)
        loss.backward()
        torch.cuda.synchronize()
        launched = {r: n - before[r]
                    for r, n in tkernel.train_tail.launches_by_route.items()}
        assert launched == ({"wgmma": 10, "wmma": 0, "f32": 0} if tail == "on"
                            else {"wgmma": 0, "wmma": 0, "f32": 0})
        out[tail] = (float(loss.detach()),
                     {k: v.grad.float() for k, v in leaves.items()})
    (lk, gk), (lp, gp) = out["on"], out["off"]
    assert abs(lk - lp) <= 1e-3 * abs(lp)
    top = max(float(v.abs().max()) for v in gp.values())
    for k in gp:
        err = float((gk[k] - gp[k]).abs().max())
        assert err <= 1e-3 * top, (k, err, top)


# ---------------------------------------------------------------------------
# Kernels 1 and 4 under a gradient; kernel 3 refuses one
# ---------------------------------------------------------------------------

def grads_of(fn, args, diff, cot):
    """Outputs of ``fn(*args)`` and the gradients of ``args[i]`` for i in
    ``diff`` against the cotangents ``cot``."""
    leaves = [a.detach().clone().requires_grad_(i in diff)
              if torch.is_tensor(a) else a for i, a in enumerate(args)]
    out = fn(*leaves)
    torch.autograd.backward(out, cot)
    return out, [leaves[i].grad for i in diff]


@pytest.mark.parametrize("bc,nb,k,a,dc", [(64, 1, 28, 1024, 1024),
                                          (5, 3, 37, 72, 40)])
def test_attention_core_function_carries_the_plain_vjp(cuda, bc, nb, k, a,
                                                       dc):
    """Under a gradient kernel 1 runs forward (one launch) and its
    Function's backward is the plain core's VJP: the outputs within the
    kernel's tolerance, every cotangent within 1e-5 of its largest
    entry (the backward runs the same plain math on the same inputs)."""
    args = attention_inputs(bc, nb, k, a, dc, torch.float32, cuda, seed=3)
    g = torch.Generator(device=cuda).manual_seed(4)
    cot = (torch.randn(bc * nb, dc, generator=g, device=cuda),
           torch.randn(bc * nb, k, generator=g, device=cuda))
    diff = (0, 1, 2, 3, 5, 6, 7)
    before = tkernel.attention_core.launches
    got, g_k = grads_of(lambda *x: tkernel.attention_core(*x, True), args,
                        diff, cot)
    assert tkernel.attention_core.launches == before + 1
    assert got[0].grad_fn.name().startswith("AttentionCore")
    ref, g_p = grads_of(lambda *x: tstep._attention_core(*x, True), args,
                        diff, cot)
    torch.cuda.synchronize()
    assert tkernel.attention_core.launches == before + 1
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-4)
    for i, x, y in zip(diff, g_k, g_p):
        assert rel_err(x, y) <= 1e-5, i


@pytest.mark.parametrize("bc,nb,k,r,s,dr", [(4, 1, 28, 49, 1024, 1024),
                                            (3, 2, 5, 7, 12, 10)])
def test_spatial_core_function_carries_the_plain_vjp(cuda, bc, nb, k, r, s,
                                                     dr):
    """Kernel 4 under a gradient: one forward launch, the plain core's
    float32 VJP backward."""
    args = spatial_inputs(bc, nb, k, r, s, dr, torch.float32, cuda, seed=5)
    g = torch.Generator(device=cuda).manual_seed(6)
    cot = (torch.randn(bc, nb, k, dr, generator=g, device=cuda),
           torch.randn(bc, nb, k, r, generator=g, device=cuda))
    diff = (0, 1, 2, 3, 4)
    before = tkernel.spatial_core.launches
    got, g_k = grads_of(lambda *x: tkernel.spatial_core(*x, torch.float32),
                        args, diff, cot)
    assert tkernel.spatial_core.launches == before + 1
    assert got[0].grad_fn.name().startswith("SpatialCore")
    ref, g_p = grads_of(lambda *x: tstep._spatial_core(*x, torch.float32),
                        args, diff, cot)
    torch.cuda.synchronize()
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5)
    for i, x, y in zip(diff, g_k, g_p):
        assert rel_err(x, y) <= 1e-5, i


@pytest.mark.parametrize("switch", ["on", "auto"])
def test_gates_kernel_under_a_gradient_raises_on_the_card(cuda, switch):
    """The gates+LSTM kernel has no backward: the scheduled-sampling scan
    through the kernel step raises for 'on' and for 'auto' on CUDA
    tensors, and launches no gates kernel."""
    from stvd_torch.train.loss import loss_fn
    cfg, batch, params = tiny_train(cuda, False, gates_kernel=switch)
    leaves = {k: v.requires_grad_(True) for k, v in params.items()}
    before = tkernel.gates_lstm.launches
    with pytest.raises(ValueError, match="gates_kernel"):
        loss_fn(leaves, cfg, batch, train=False, ss_prob=0.5,
                step_fn=tkernel.step_kernels)
    assert tkernel.gates_lstm.launches == before


@pytest.mark.parametrize("scan", ["autodiff", "sampled"])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("spatial", [False, True])
def test_autograd_scans_launch_kernels_1_and_4(cuda, spatial, remat, scan):
    """The autodiff and scheduled-sampling scans through the kernel step
    on the card: kernel 1 (and kernel 4 on the spatial model) launch once
    a step, twice with remat (the backward runs each step's forward
    again), the dWs_att GEMM once in the region projection's backward;
    the loss and every gradient against the plain step's (the same coins
    on both sides)."""
    from stvd_torch.train.loss import loss_fn
    extra = dict(fused_seq_grad=False) if scan == "autodiff" else {}
    ss = 0.5 if scan == "sampled" else 0.0
    out = {}
    for name, step_fn in (("kernel", tkernel.step_kernels),
                          ("plain", tstep.step)):
        cfg, batch, params = tiny_train(cuda, spatial, remat=remat, **extra)
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        fns = (tkernel.attention_core, tkernel.spatial_core, tkernel.dws_gemm)
        counts = [f.launches for f in fns]
        loss, _ = loss_fn(leaves, cfg, batch,
                          torch.Generator(device=cuda).manual_seed(1),
                          train=True, ss_prob=ss, step_fn=step_fn)
        loss.backward()
        torch.cuda.synchronize()
        launched = [f.launches - c for f, c in zip(fns, counts)]
        steps = batch["tokens"].shape[1] * (2 if remat else 1)
        want = ([steps, steps if spatial else 0, 1 if spatial else 0]
                if name == "kernel" else [0, 0, 1 if spatial else 0])
        assert launched == want, (name, launched, want)
        out[name] = (float(loss.detach()),
                     {k: v.grad for k, v in leaves.items() if v.grad is not
                      None})
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    assert sorted(gk) == sorted(gp)
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    top = max(float(v.abs().max()) for v in gp.values())
    for k in gp:
        scale = top if k in ("c_att", "cs_att") else float(gp[k].abs().max())
        assert float((gk[k] - gp[k]).abs().max()) <= 1e-3 * scale, k


ARTIFACT_KERNELS = ("attention_core", "logit_tail", "spatial_core",
                    "gates_lstm")


@pytest.mark.parametrize("model,engaged", [
    ({}, ("attention_core", "logit_tail")),
    ({"decode_quant": "int8", "gates_kernel": "on"},
     ("attention_core", "logit_tail", "gates_lstm")),
    ({"use_spatial": True, "n_regions": 7, "region_dim": 64},
     ("attention_core", "logit_tail", "spatial_core")),
])
def test_artifact_equals_live_on_the_kernels(cuda, tmp_path, model,
                                             engaged):
    """A CUDA artifact (bf16, beam 3, sizes 2 and 4) captions 7 videos
    as the live Captioner does; inside the loaded graph each engaged
    kernel launches maxlen times a chunk (4 on b=4, then 3 on b=4), on
    the route the live path takes, and the others not at all."""
    from stvd_torch.api import Captioner
    from stvd_torch.config import Config, DecodeConfig, ModelConfig
    from stvd_torch.data.text import Vocab
    from stvd_torch.export_aot import load_artifact, save_artifact
    from stvd_torch.model.decoder import init_params
    m = ModelConfig(n_words=1000, dim_word=64, dim=128, ctx_dim=128,
                    n_frames=8, compute_dtype="bfloat16", **model)
    cfg = Config(model=m, decode=DecodeConfig(beam_size=3, maxlen=6,
                                              decode_batch=4))
    params = init_params(m, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    for p in params.values():
        p.mul_(30.0)                # larger than the 0.01 init scale
    vocab = Vocab({f"w{i}": i for i in range(2, m.n_words)})
    out = str(tmp_path / "artifact")
    manifest = save_artifact(out, params, cfg, vocab, batch_sizes=(2, 4))
    assert manifest["custom_ops"] == sorted("stvd_torch::" + k
                                            for k in engaged)
    served = load_artifact(out, device=cuda)
    cap = Captioner(params, cfg, vocab, device=cuda)
    rng = np.random.RandomState(0)
    feats = [rng.randn(int(f), m.ctx_dim).astype(np.float32)
             for f in rng.randint(3, 12, size=7)]
    regs = ([rng.randn(f.shape[0], m.n_regions, m.region_dim)
             .astype(np.float32) for f in feats] if m.use_spatial else None)
    fns = [getattr(tkernel, k) for k in ARTIFACT_KERNELS]
    runs = {}
    for name, c in (("aot", served), ("live", cap)):
        before = [(f.launches, dict(f.launches_by_route)) for f in fns]
        caps = c.caption(feats, regs)
        torch.cuda.synchronize()
        runs[name] = (caps, [
            (f.launches - n, {r: f.launches_by_route[r] - by[r] for r in by})
            for f, (n, by) in zip(fns, before)])
    assert runs["aot"][0] == runs["live"][0]
    for k, (n, by) in zip(ARTIFACT_KERNELS, runs["aot"][1]):
        assert n == (2 * cfg.decode.maxlen if k in engaged else 0), k
    live_steps = runs["live"][1][0][0]
    for (n, by), (ln, lby) in zip(runs["aot"][1], runs["live"][1]):
        # the live loop may exit early: the same routes, at most as often
        assert {r for r in by if by[r]} == {r for r in lby if lby[r]}
        assert ln <= n and (ln == 0) == (n == 0)
    assert live_steps <= 2 * cfg.decode.maxlen


def _tp_graph_rank(mesh1, root, params, cfg_json, feats):
    """One rank of a 1 x 2 mesh on the card: a tiny float32 decode
    exported for the card with the kernel step and with the plain step
    (``save_artifact(model_parallel=2)``), both loaded and captioning
    ``feats``, beside the live TP decode with the kernels."""
    import os
    from stvd_torch import export_aot
    from stvd_torch.api import pack_request
    from stvd_torch.config import Config
    from stvd_torch.data.text import Vocab
    from stvd_torch.decode import parallel as dparallel
    cfg = Config.from_json(cfg_json)
    vocab = Vocab({f"w{i}": i for i in range(2, cfg.model.n_words)})
    out = {}
    for name, use in (("kernel", True), ("plain", False)):
        path = os.path.join(root, name)
        export_aot.save_artifact(path, params, cfg, vocab,
                                 batch_sizes=(len(feats),), use_kernel=use,
                                 model_parallel=2, device="cuda")
        cap = export_aot.load_artifact(path, device="cuda")
        out[name] = cap.caption(feats)
        out[f"{name}_ops"] = cap.manifest["custom_ops"]
    part = dparallel.shard_decode_params(
        {k: torch.from_numpy(v).cuda() for k, v in params.items()},
        cap._mesh)
    d = cfg.decode
    with torch.no_grad():
        toks = dparallel.make_tp_beam_decode(
            cfg.model, cap._mesh, d.beam_size, d.maxlen, d.length_norm,
            tail="auto", step_fn=tkernel.step_kernels)(
                part, pack_request(cfg.model, feats, device="cuda")).tokens
    out["live"] = [" ".join(vocab.decode(r)) for r in toks.cpu().numpy()]
    return out


def test_tp_kernel_graph_gives_the_plain_graph_s_tokens(cuda, tmp_path):
    """A tensor-parallel artifact for the card runs the live TP decode's
    kernel step (kernel 1 whole, kernel 2 on the rank's vocab shard),
    where the JAX package exports the plain step: at float32 its
    captions equal the plain graph's, the live TP decode's and one
    device's, on 2 ranks sharing the card over gloo."""
    from stvd_torch.api import Captioner
    from stvd_torch.config import Config, DecodeConfig, ModelConfig
    from stvd_torch.data.text import Vocab
    from stvd_torch.model.decoder import init_params
    from stvd_torch.train import parallel
    m = ModelConfig(n_words=48, dim_word=16, dim=32, ctx_dim=32,
                    n_frames=6, compute_dtype="float32")
    cfg = Config(model=m, decode=DecodeConfig(beam_size=3, maxlen=8,
                                              decode_batch=4))
    g = torch.Generator().manual_seed(5)
    params = {k: ((torch.randn(v.shape, generator=g) / v.shape[0] ** 0.5)
                  if v.ndim >= 2 else 0.5 * torch.randn(v.shape, generator=g)
                  ).numpy()
              for k, v in init_params(m, torch.Generator(), "cpu").items()}
    feats = np.random.RandomState(3).randn(4, m.n_frames, m.ctx_dim).astype(
        np.float32)
    ranks = parallel.spawn(_tp_graph_rank, 2,
                           (str(tmp_path), params, cfg.to_json(), feats),
                           device="cuda:0", backend="gloo", timeout=600)
    one = Captioner(params, cfg, Vocab({f"w{i}": i for i in range(2, 48)}),
                    device=cuda).caption(feats)
    for r in ranks:
        assert r["kernel_ops"] == ["stvd_torch::attention_core",
                                   "stvd_torch::logit_tail"]
        assert r["plain_ops"] == []
        assert r["kernel"] == r["plain"] == r["live"] == one
