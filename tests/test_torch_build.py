"""The kernel build and the wrappers' route choices, on the CPU.

The library is named by a digest of the sources and flags, so a source
missing from ``_build.SOURCES`` / ``HEADERS``, or a flag passed outside
the digest, would let a stale library be reused.  ``build`` is driven
here with nvcc replaced by a recorder.  The route helpers of kernels 5
and 7 are pure functions of shapes, dtype and addresses.
"""

import shutil
import types
from pathlib import Path

import pytest
import torch

from stvd_torch import _build
from stvd_torch.model import kernel as tkernel

BF16, F32 = torch.bfloat16, torch.float32


def test_every_csrc_file_is_a_source_or_a_header():
    files = {p.name for p in _build._CSRC.iterdir() if p.is_file()}
    listed = set(_build.SOURCES) | set(_build.HEADERS)
    assert files == listed
    assert all(n.endswith(".cu") for n in _build.SOURCES)
    assert all(n.endswith(".cuh") for n in _build.HEADERS)


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
    before = dict(tkernel.dws_gemm.launches_by_route)
    tkernel.dws_gemm(a, torch.randn(10, 16))
    assert tkernel.dws_gemm.launches_by_route == before
    assert set(before) == set(tkernel.DWS_ROUTES)
    assert set(tkernel.spatial_bwd.launches_by_route) == set(
        tkernel.SPATIAL_BWD_ROUTES)
