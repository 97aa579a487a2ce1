"""The kernel build and the wrappers' route choices, on the CPU.

The library is named by a digest of the sources and flags, so a source
missing from ``_build.SOURCES`` / ``HEADERS``, or a flag passed outside
the digest, would let a stale library be reused.  ``build`` is driven
here with nvcc replaced by a recorder.  The route helpers of kernels 2,
3, 5 and 7 are pure functions of shapes, dtype and addresses.
"""

import re
import shutil
import types
from pathlib import Path

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
    for name in ("dws_gemm.cu", "logit_tail.cu", "gates_lstm.cu"):
        assert '#include "hopper.cuh"' in (_build._CSRC / name).read_text()


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
    (130, 5120, 35, BF16, 0, 0, "wmma"),
    (185, 277, 100, BF16, 0, 0, "wmma"),
    (185, 277, 100, I8, 0, 0, "wmma"),
    (37, 264, 128, I8, 0, 0, "wmma"),
    (1280, 5120, 3584, BF16, 2, 0, "wmma"),
    (1280, 5120, 3584, I8, 0, 8, "wmma"),
    (1280, 5120, 3584, F32, 0, 0, "f32"),
    (185, 277, 100, F32, 4, 4, "f32")])
def test_gates_route(rows, kx, dim, dtype, x_ptr, w_ptr, route):
    """wgmma for bf16 with Kx a multiple of 8 and dim even (row strides of
    whole 16 bytes for x and the (Kx, 4 dim) stack), for int8 with Kx a
    multiple of 16 (x and the K-major grid), both bases aligned; the wmma
    route for the other bf16 and int8 shapes; float32 its own."""
    assert tkernel.gates_route(rows, kx, dim, dtype, x_ptr, w_ptr) == route
    assert route in tkernel.GATES_ROUTES


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


def test_route_counters_start_at_zero_on_the_cpu():
    """CPU tensors take the plain versions and touch no route counter."""
    a = torch.randn(10, 8)
    kernels = (tkernel.dws_gemm, tkernel.logit_tail, tkernel.gates_lstm)
    before = [dict(k.launches_by_route) for k in kernels]
    tkernel.dws_gemm(a, torch.randn(10, 16))
    tkernel.logit_tail(a, torch.randn(8, 12), torch.randn(12), 3)
    tkernel.gates_lstm(a, torch.randn(8, 16), torch.randn(16),
                       torch.randn(10, 4))
    assert [dict(k.launches_by_route) for k in kernels] == before
    assert set(before[0]) == set(tkernel.DWS_ROUTES)
    assert set(before[1]) == set(tkernel.LOGIT_TAIL_ROUTES)
    assert set(before[2]) == set(tkernel.GATES_ROUTES)
    assert set(tkernel.spatial_bwd.launches_by_route) == set(
        tkernel.SPATIAL_BWD_ROUTES)
