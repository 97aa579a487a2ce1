"""The kernel build and the wrappers' route choices, on the CPU.

The library is named by a digest of the sources and flags, so a source
missing from ``_build.SOURCES`` / ``HEADERS``, or a flag passed outside
the digest, would let a stale library be reused.  ``build`` is driven
here with nvcc replaced by a recorder.  The route helpers of kernels 1-7
are pure functions of shapes, dtype and addresses, and the device
tanh of kernels 1 and 4 is mirrored in numpy.
"""

import re
import shutil
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from stvd_torch import _build
from stvd_torch.model import kernel as tkernel

BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8


def test_every_csrc_file_is_a_source_or_a_header():
    files = {p.name for p in _build._CSRC.iterdir() if p.is_file()}
    listed = set(_build.SOURCES) | set(_build.HEADERS)
    assert files == listed
    assert all(n.endswith(".cu") for n in _build.SOURCES)
    assert all(n.endswith(".cuh") for n in _build.HEADERS)


def test_every_included_header_is_listed():
    """A header a source includes is hashed into the digest, so an edit
    to it (the shared Hopper helpers, the gates mainloop) rebuilds."""
    included = set()
    for name in _build.SOURCES + _build.HEADERS:
        text = (_build._CSRC / name).read_text()
        included |= set(re.findall(r'#include "([^"]+)"', text))
    assert included == set(_build.HEADERS)
    for name in ("dws_gemm.cu", "logit_tail.cu", "gates_lstm.cu",
                 "attn_core.cu", "spatial_core.cu", "train_tail.cu"):
        assert '#include "hopper.cuh"' in (_build._CSRC / name).read_text()
    for name in ("gates_lstm.cu", "train_tail.cu"):
        text = (_build._CSRC / name).read_text()
        assert '#include "gates_wgmma.cuh"' in text
    for name in ("attn_core.cu", "spatial_core.cu"):
        text = (_build._CSRC / name).read_text()
        assert '#include "attn_score.cuh"' in text


def recorded_build(monkeypatch, tmp_path):
    """Run ``_build.build`` into ``tmp_path`` with nvcc replaced by a
    recorder; return the commands it issued."""
    calls = []

    class Proc:
        returncode = 0

        def __init__(self, cmd, **kwargs):
            calls.append(cmd)

        def communicate(self):
            return ("", None)

    def run(cmd, **kwargs):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Proc)
    monkeypatch.setattr(_build.subprocess, "run", run)
    out = _build.build()
    assert out.is_file() and out == _build.library_path()
    return calls


def flags_of(cmd):
    """A command's arguments without nvcc, ``-o`` and the paths."""
    args = cmd[1:]
    out = args[args.index("-o") + 1]
    return [a for a in args if a not in ("-o", out)
            and not a.endswith((".cu", ".o"))]


def test_build_passes_only_flags_the_digest_sees(monkeypatch, tmp_path):
    calls = recorded_build(monkeypatch, tmp_path)
    assert len(calls) == len(_build.SOURCES) + 1
    compiled = [Path(c[-1]).name for c in calls[:-1]]
    assert compiled == list(_build.SOURCES)
    for cmd in calls[:-1]:
        assert flags_of(cmd) == [*_build.NVCC_FLAGS, "-c"]
    assert flags_of(calls[-1]) == list(_build.LINK_FLAGS)


@pytest.mark.parametrize("name", ["NVCC_FLAGS", "LINK_FLAGS"])
def test_digest_changes_with_every_flag(monkeypatch, name):
    base = _build._digest()
    flags = getattr(_build, name)
    for i in range(len(flags)):
        monkeypatch.setattr(_build, name, flags[:i] + flags[i + 1:])
        assert _build._digest() != base, (name, flags[i])
    monkeypatch.setattr(_build, name, (*flags, "-DEXTRA"))
    assert _build._digest() != base


@pytest.mark.parametrize("which", ["source", "header"])
def test_digest_changes_with_every_file(monkeypatch, tmp_path, which):
    names = _build.SOURCES if which == "source" else _build.HEADERS
    base = _build._digest()
    for name in names:
        csrc = tmp_path / name
        shutil.copytree(_build._CSRC, csrc)
        with open(csrc / name, "a") as f:
            f.write("\n// edited\n")
        monkeypatch.setattr(_build, "_CSRC", csrc)
        assert _build._digest() != base, name


@pytest.mark.parametrize("n,dr,s,dtype,a_ptr,b_ptr,route", [
    (87808, 1024, 1024, BF16, 0, 256, "wgmma"),
    (1, 8, 8, BF16, 16, 32, "wgmma"),
    (3000, 1000, 520, BF16, 0, 0, "wgmma"),
    (777, 130, 67, BF16, 0, 0, "mma"),
    (500, 64, 128, BF16, 2, 0, "mma"),
    (500, 64, 128, BF16, 0, 8, "mma"),
    (500, 64, 132, BF16, 0, 0, "mma"),
    (2 ** 31, 64, 64, BF16, 0, 0, "mma"),
    (87808, 1024, 1024, F32, 0, 0, "f32"),
    (777, 130, 67, F32, 4, 4, "f32")])
def test_dws_route(n, dr, s, dtype, a_ptr, b_ptr, route):
    """wgmma only for bf16 with Dr and s multiples of 8 (TMA row strides
    of whole 16 bytes), 16-byte aligned bases and int32 row coordinates;
    the wmma route for the other bf16 operands; float32 its own."""
    assert tkernel.dws_route(n, dr, s, dtype, a_ptr, b_ptr) == route
    assert route in tkernel.DWS_ROUTES


@pytest.mark.parametrize("rows,dw,v,dtype,x_ptr,w_ptr,route", [
    (1280, 512, 13056, BF16, 0, 256, "wgmma"),
    (1024, 512, 13056, BF16, 16, 32, "wgmma"),
    (1, 8, 8, BF16, 0, 0, "wgmma"),
    (67, 128, 304, BF16, 0, 0, "wgmma"),
    (1280, 512, 12995, BF16, 0, 0, "wmma"),
    (67, 128, 300, BF16, 0, 0, "wmma"),
    (1, 40, 9, BF16, 0, 0, "wmma"),
    (64, 36, 64, BF16, 0, 0, "wmma"),
    (1280, 512, 13056, BF16, 2, 0, "wmma"),
    (1280, 512, 13056, BF16, 0, 8, "wmma"),
    (1280, 512, 13056, F32, 0, 0, "f32"),
    (130, 96, 1001, F32, 4, 4, "f32")])
def test_logit_tail_route(rows, dw, v, dtype, x_ptr, w_ptr, route):
    """wgmma only for bf16 with dw and V multiples of 8 (TMA row strides
    of whole 16 bytes) and 16-byte aligned bases; the wmma route for the
    ragged vocab and other bf16 operands; float32 its own."""
    assert tkernel.logit_tail_route(rows, dw, v, dtype, x_ptr,
                                    w_ptr) == route
    assert route in tkernel.LOGIT_TAIL_ROUTES


@pytest.mark.parametrize("rows,kx,dim,dtype,x_ptr,w_ptr,route", [
    (1280, 5120, 3584, BF16, 0, 256, "wgmma"),
    (1280, 5120, 3584, I8, 16, 32, "wgmma"),
    (1, 16, 8, BF16, 0, 0, "wgmma"),
    (1, 16, 8, I8, 0, 0, "wgmma"),
    (37, 272, 128, I8, 0, 0, "wgmma"),
    (130, 5120, 35, I8, 0, 0, "wgmma"),
    (130, 5120, 35, BF16, 0, 0, "wgmma"),
    (185, 277, 100, BF16, 0, 0, "wmma"),
    (185, 277, 100, I8, 0, 0, "wmma"),
    (37, 272, 100, BF16, 0, 0, "wgmma"),
    (37, 272, 100, I8, 0, 0, "wgmma"),
    (1280, 5120, 3588, BF16, 0, 0, "wgmma"),
    (37, 264, 128, I8, 0, 0, "wmma"),
    (1280, 5120, 3584, BF16, 2, 0, "wmma"),
    (1280, 5120, 3584, I8, 0, 8, "wmma"),
    (1280, 5120, 3584, F32, 0, 0, "f32"),
    (185, 277, 100, F32, 4, 4, "f32")])
def test_gates_route(rows, kx, dim, dtype, x_ptr, w_ptr, route):
    """wgmma for bf16 with Kx a multiple of 8 and int8 with Kx a
    multiple of 16 (dense rows of x and of the stack's K-major
    transpose, both a whole 16 bytes; a gate's block starts at a row of
    the transpose, so dim is free), both bases aligned; the wmma route
    for the other bf16 and int8 shapes; float32 its own."""
    assert tkernel.gates_route(rows, kx, dim, dtype, x_ptr, w_ptr) == route
    assert route in tkernel.GATES_ROUTES


@pytest.mark.parametrize("rows,dc,dim,dtype,x_ptr,w_ptr,route", [
    (64, 1024, 3584, BF16, 0, 256, "wgmma"),
    (128, 1024, 3584, BF16, 16, 32, "wgmma"),
    (37, 272, 104, BF16, 0, 0, "wgmma"),
    (1, 16, 8, BF16, 0, 0, "wgmma"),
    (37, 272, 100, BF16, 0, 0, "wmma"),
    (130, 277, 35, BF16, 0, 0, "wmma"),
    (64, 1020, 3584, BF16, 0, 0, "wmma"),
    (64, 1024, 35, BF16, 0, 0, "wmma"),
    (64, 1024, 3584, BF16, 2, 0, "wmma"),
    (64, 1024, 3584, BF16, 0, 8, "wmma"),
    (64, 1024, 3584, F32, 0, 0, "f32"),
    (130, 277, 35, F32, 4, 4, "f32")])
def test_train_tail_route(rows, dc, dim, dtype, x_ptr, w_ptr, route):
    """wgmma for bf16 when TMA can describe ctx_t (rows of dc elements)
    and Wc (rows of 4 dim, gate blocks from column g dim): dc and dim
    multiples of 8, both bases 16-byte aligned; the wmma route for the
    other bf16 shapes (dim 100: gate blocks off 16-byte boundaries);
    float32 its own."""
    assert tkernel.train_tail_route(rows, dc, dim, dtype, x_ptr,
                                    w_ptr) == route
    assert route in tkernel.TRAIN_TAIL_ROUTES


@pytest.mark.parametrize("s,dr,cdtype,ptrs,route", [
    (1024, 1024, BF16, (0, 16, 32, 48), "vector"),
    (1024, 72, BF16, (0, 0, 0, 0), "vector"),
    (1024, 1024, F32, (0, 0, 0, 0), "vector"),
    (1000, 12, F32, (0, 0, 0, 0), "vector"),
    (1000, 12, BF16, (0, 0, 0, 0), "element"),
    (130, 67, BF16, (0, 0, 0, 0), "element"),
    (1024, 1024, BF16, (0, 0, 8, 0), "element"),
    (1024, 1024, F32, (4, 0, 0, 0), "element")])
def test_spatial_bwd_route(s, dr, cdtype, ptrs, route):
    """16-byte loads only when s and Dr are whole vectors of the compute
    dtype (8 bf16, 4 float32) and every streamed operand is aligned."""
    assert tkernel.spatial_bwd_route(s, dr, cdtype, ptrs) == route
    assert route in tkernel.SPATIAL_BWD_ROUTES


@pytest.mark.parametrize("nb,k,a,dc,dtype,pctx_ptr,ctx_ptr,route", [
    (5, 28, 1024, 1024, BF16, 0, 256, "cluster"),
    (1, 28, 1024, 1024, BF16, 16, 32, "cluster"),
    (8, 40, 1024, 1024, F32, 0, 0, "cluster"),
    (1, 28, 1024, 1024, F32, 0, 0, "cluster"),
    (3, 1, 8, 8, BF16, 0, 0, "cluster"),
    (5, 28, 1024, 1024, BF16, 4, 0, "simple"),
    (5, 28, 1024, 1024, BF16, 0, 2, "simple"),
    (5, 28, 100, 304, BF16, 0, 0, "simple"),
    (5, 28, 1024, 300, F32, 0, 0, "simple"),
    (5, 28, 2048, 1024, BF16, 0, 0, "cluster"),
    (5, 28, 1024, 2048, BF16, 0, 0, "cluster"),
    (8, 400, 1024, 1024, F32, 0, 0, "simple"),
    (5, 28, 2048, 2048, F32, 0, 0, "cluster"),
    (1, 28, 2048, 2048, F32, 0, 0, "cluster"),
    (5, 28, 2056, 2048, F32, 0, 0, "simple"),
    (5, 28, 2048, 4096, BF16, 0, 0, "simple")])
def test_attention_core_route(nb, k, a, dc, dtype, pctx_ptr, ctx_ptr,
                              route):
    """'cluster' only when A and Dc are whole 16-byte vectors of float32
    (multiples of 8 also for the bf16 TMA span) of at most 2048 columns
    (four warps a CTA up to 1024, eight above), both bases are 16-byte
    aligned and a CTA's ctx slice (or its partial sums over it) fits
    shared memory: 20 float32 frames of 1024 a CTA (80 KB, K 40 at 8
    beams) fit; K 400 at 8 beams, 100 float32 frames a CTA, does not."""
    assert tkernel.attention_core_route(nb, k, a, dc, dtype, pctx_ptr,
                                        ctx_ptr) == route
    assert route in tkernel.ATTENTION_CORE_ROUTES


@pytest.mark.parametrize("nb,k,dtype,kc,route", [
    (1, 28, F32, 28, "cluster"),
    (1, 60, F32, 60, "simple"),
    (5, 28, BF16, 28, "cluster"),
    (8, 400, BF16, 100, "cluster"),
    (8, 400, BF16, 112, "simple")])
def test_attention_core_route_of_a_given_plan(nb, k, dtype, kc, route):
    """With the frames per CTA given (a forced plan), the route checks
    that plan's slice against shared memory, not the default split's:
    28 float32 frames of 1024 (115 KB) fit, 60 (246 KB) do not; 100 bf16
    frames of 8 beams fit, 112 do not."""
    assert tkernel.attention_core_route(nb, k, 1024, 1024, dtype, 0, 0,
                                        kc) == route


@pytest.mark.parametrize("k,nb,plan", [
    (1, 1, (1, 1)), (2, 1, (2, 1)), (5, 1, (3, 2)), (28, 1, (4, 7)),
    (29, 1, (4, 8)), (40, 1, (4, 10)), (28, 2, (4, 7)), (28, 3, (2, 14)),
    (28, 5, (2, 14)), (28, 8, (2, 14)), (29, 5, (2, 15)), (1, 5, (1, 1)),
    (5, 5, (2, 3))])
def test_attention_core_split(k, nb, plan):
    """At most 4 CTAs a row, frames as even as whole frames allow, no CTA
    without a frame (the last CTA holds 1..kc of them); from 3 beams up,
    2 CTAs a row (one wave of ~512 CTAs at a decode batch of 256).  The
    plan takes no row count: a row's frames are summed in one order
    whatever the batch it is decoded in."""
    splits, kc = tkernel.attention_core_split(k, nb)
    assert (splits, kc) == plan
    assert 1 <= splits <= 4 and (splits - 1) * kc < k <= splits * kc
    if nb >= 3:
        assert splits <= 2


@pytest.mark.parametrize("k,nb,a,dc,el,plan", [
    (28, 5, 2048, 2048, 4, (4, 7)), (28, 5, 2048, 2048, 2, (2, 14)),
    (28, 1, 2048, 2048, 4, (4, 7)), (28, 8, 2048, 2048, 4, (4, 7)),
    (5, 5, 2048, 2048, 4, (2, 3)), (28, 5, 1024, 1024, 2, (2, 14)),
    (28, 5, 1024, 1024, 4, (2, 14))])
def test_attention_core_split_by_shared_memory(k, nb, a, dc, el, plan):
    """From 3 beams up the 2-CTA plan holds unless its CTA's shared
    memory leaves room for one CTA an SM: preset 4's 14 float32 frames of
    2048 (115 KB) take 4 CTAs of 7 frames; the same frames in bf16 (57 KB)
    or preset 3's keep (2, 14).  Without A and Dc the plan is the 2-CTA
    rule's."""
    assert tkernel.attention_core_split(k, nb, a, dc, el) == plan
    if nb >= 3 and plan != tkernel.attention_core_split(k, nb):
        assert plan[0] == min(4, k)


@pytest.mark.parametrize("nb,r,s,dr,dtype,pregion_ptr,regions_ptr,route", [
    (5, 49, 1024, 1024, BF16, 0, 256, "tma"),
    (1, 49, 1024, 1024, BF16, 16, 32, "tma"),
    (8, 49, 1024, 1024, F32, 0, 0, "tma"),
    (3, 49, 136, 72, BF16, 0, 0, "tma"),
    (8, 37, 13, 301, BF16, 0, 0, "simple"),
    (3, 49, 130, 64, BF16, 0, 0, "simple"),
    (5, 49, 1024, 1024, BF16, 8, 0, "simple"),
    (5, 49, 1024, 1024, BF16, 0, 2, "simple"),
    (5, 49, 4096, 1024, BF16, 0, 0, "simple"),
    (5, 64, 1024, 1024, F32, 0, 0, "simple")])
def test_spatial_core_route(nb, r, s, dr, dtype, pregion_ptr, regions_ptr,
                            route):
    """'tma' only when s and Dr are multiples of 8, s fits the eight warps'
    256-column chunks, both bases are 16-byte aligned and a frame's
    regions slab fits shared memory beside the partial scores (64 float32
    regions of 1024 do not)."""
    assert tkernel.spatial_core_route(nb, r, s, dr, dtype, pregion_ptr,
                                      regions_ptr) == route
    assert route in tkernel.SPATIAL_CORE_ROUTES


@pytest.mark.parametrize("k,fpb", [(1, 1), (5, 5), (7, 7), (8, 4),
                                   (28, 7), (29, 6), (40, 7)])
def test_spatial_core_frames(k, fpb):
    assert tkernel.spatial_core_frames(k) == fpb
    blocks = -(-k // fpb)
    assert fpb <= 7 and (blocks - 1) * fpb < k


@pytest.mark.parametrize("width,nq", [(8, 1), (256, 1), (264, 2),
                                      (768, 4), (1024, 4), (2048, 8)])
def test_score_chunks_divide_the_warps(width, nq):
    assert tkernel.score_chunks(width) == nq


def mirror_tanh(p, h):
    """numpy float32 mirror of attn_score.cuh's tanh(p + h): the product
    form 1 - 2 / (1 + 2^(C p) 2^(C h)) while |C p| and |C h| are at most
    60, else the single-exponent form 1 - 2 / (1 + 2^(C (p + h))).  ex2
    is correctly rounded (the card's ex2.approx is within 2 ulp), the
    reciprocal correctly rounded (rcp.approx is within 1 ulp); an fma is a
    float64 product and sum rounded once."""
    f32, f64 = np.float32, np.float64
    c = f32(2.885390081777927)
    ap, ah = (p * c).astype(f32), (h * c).astype(f32)
    with np.errstate(over="ignore"):
        ep = np.exp2(ap.astype(f64)).astype(f32)
        eh = np.exp2(ah.astype(f64)).astype(f32)
        d = (ep.astype(f64) * eh + 1.0).astype(f32)
        t = np.exp2((c * (p + h).astype(f32)).astype(f64)).astype(f32)
    inside = (np.abs(ap) <= 60) & (np.abs(ah) <= 60)
    d = np.where(inside, d, (t.astype(f64) + 1.0).astype(f32))
    r = (1.0 / d.astype(f64)).astype(f32)
    return (1.0 - 2.0 * r.astype(f64)).astype(f32)


@pytest.mark.parametrize("lo,hi,n", [(-20.0, 20.0, 2_000_001),
                                     (-4.0, 4.0, 2_000_001),
                                     (-0.5, 0.5, 1_000_001),
                                     (-1e-3, 1e-3, 200_001),
                                     (20.0, 40.0, 200_001),
                                     (8.0, 90.0, 100_001)])
def test_device_tanh_algebra(lo, hi, n):
    """The formula of the TMA cores' tanh(p + h), with p = 0.7 x and h =
    0.3 x as the card's sweep forms them, against np.tanh in float64 on a
    dense grid: absolute error below 3e-7 everywhere, through the
    cancellation near 0 (the result is 1 - 2 r with r near 1/2), the
    saturation at large |x| (exactly +-1 from |x| = 10) and the switch to
    the single-exponent form past |x| ~ 29.7 (|C p| > 60)."""
    x = np.concatenate([np.linspace(lo, hi, n, dtype=np.float32),
                        -np.linspace(lo, hi, n, dtype=np.float32)])
    p = (x * np.float32(0.7)).astype(np.float32)
    h = (x * np.float32(0.3)).astype(np.float32)
    got = mirror_tanh(p, h)
    ref = np.tanh(p.astype(np.float64) + h.astype(np.float64))
    err = np.abs(got.astype(np.float64) - ref)
    assert err.max() < 3e-7, float(err.max())
    big = np.abs(x) >= 10
    assert np.array_equal(got[big], np.sign(x[big]))


def test_device_tanh_error_grows_with_the_rounded_exponents():
    """Over p, h uniform on [-20, 20]: C p and C h are each rounded to
    float32 (relative 2^-24), which costs up to ~4.3e-8 (|p| + |h|) of
    absolute error where p + h cancels; the single-exponent form of the
    sum C p + C h has the same bound.  No element exceeds 3e-7 + 5e-8
    (|p| + |h|)."""
    rng = np.random.RandomState(0)
    p = rng.uniform(-20, 20, 1_000_000).astype(np.float32)
    h = rng.uniform(-20, 20, 1_000_000).astype(np.float32)
    got = mirror_tanh(p, h).astype(np.float64)
    ref = np.tanh(p.astype(np.float64) + h.astype(np.float64))
    bound = 3e-7 + 5e-8 * (np.abs(p) + np.abs(h))
    assert np.all(np.abs(got - ref) <= bound)


def test_device_tanh_split_range_stays_normal():
    """|C p|, |C h| <= 60 keeps 1 + 2^(C p) 2^(C h) finite and the
    product a normal float32 (ex2.approx.ftz would flush a subnormal)."""
    f32 = np.float32
    hi, lo = f32(2.0 ** 60), f32(2.0 ** -60)
    assert np.isfinite(hi * hi + f32(1))
    assert lo * lo >= np.finfo(np.float32).tiny


def test_route_counters_start_at_zero_on_the_cpu():
    """CPU tensors take the plain versions and touch no route counter."""
    a = torch.randn(10, 8)
    kernels = (tkernel.dws_gemm, tkernel.logit_tail, tkernel.gates_lstm,
               tkernel.attention_core, tkernel.spatial_core,
               tkernel.train_tail)
    before = [dict(k.launches_by_route) for k in kernels]
    tkernel.dws_gemm(a, torch.randn(10, 16))
    tkernel.logit_tail(a, torch.randn(8, 12), torch.randn(12), 3)
    tkernel.gates_lstm(a, torch.randn(8, 16), torch.randn(16),
                       torch.randn(10, 4))
    tkernel.attention_core(torch.randn(4, 8), torch.randn(4),
                           torch.randn(2, 3, 8), torch.randn(2, 3, 5),
                           torch.ones(2, 3), torch.randn(8),
                           torch.tensor(0.1), torch.tensor(0.2), True)
    tkernel.spatial_core(torch.randn(4, 8), torch.randn(2, 3, 4, 8),
                         torch.randn(2, 3, 4, 5), torch.randn(8),
                         torch.tensor(0.1), torch.float32)
    tkernel.train_tail(torch.randn(3, 8), torch.randn(3, 16),
                       torch.randn(3, 16), torch.randn(3, 4),
                       torch.randn(8, 16), torch.bfloat16)
    assert [dict(k.launches_by_route) for k in kernels] == before
    assert set(before[0]) == set(tkernel.DWS_ROUTES)
    assert set(before[1]) == set(tkernel.LOGIT_TAIL_ROUTES)
    assert set(before[2]) == set(tkernel.GATES_ROUTES)
    assert set(before[3]) == set(tkernel.ATTENTION_CORE_ROUTES)
    assert set(before[4]) == set(tkernel.SPATIAL_CORE_ROUTES)
    assert set(before[5]) == set(tkernel.TRAIN_TAIL_ROUTES)
    assert set(tkernel.spatial_bwd.launches_by_route) == set(
        tkernel.SPATIAL_BWD_ROUTES)


@pytest.mark.parametrize("source", ["attn_core.cu", "spatial_core.cu"])
def test_custom_op_fakes_take_the_kernels_beam_limit(source):
    """The custom ops' fakes check the beams a context row without the
    library: their limit is the kernels' kMaxBeams."""
    text = (_build._CSRC / source).read_text()
    limit = int(re.search(r"constexpr int kMaxBeams = (\d+);", text).group(1))
    assert tkernel.MAX_BEAMS == limit
