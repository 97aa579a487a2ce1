"""Build the port's CUDA kernels on first use and load them with ctypes.

The ``.cu`` sources in ``stvd_torch/csrc`` compile with ``nvcc``, one
process per source, all started together, into objects that link into one
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds).  The library lands in ``build/stvd_torch/`` beside the
package, named by a hash of the sources and flags, so an unchanged tree
reuses it.  Every C entry returns ``cudaGetLastError()`` of its launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "stvd_torch"
SOURCES = ("attn_core.cu", "logit_tail.cu", "spatial_core.cu",
           "gates_lstm.cu", "spatial_bwd.cu", "train_tail.cu", "dws_gemm.cu")
HEADERS = ("attn_score.cuh", "gates_mma.cuh", "gates_wgmma.cuh",
           "hopper.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "stvd_attn_core": [_P, _L, _P, _L, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _P],
    "stvd_attn_core_max_beams": [],
    "stvd_tanh_f32": [_P, _P, _P, _L, _I, _P],
    "stvd_logit_tail": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                        _I, _I, _I, _I, _P],
    "stvd_logit_tail_ntiles": [_I, _I],
    "stvd_spatial_core": [_P, _L, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _I, _I, _I, _P],
    "stvd_spatial_core_max_beams": [],
    "stvd_gates_lstm": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _P],
    "stvd_spatial_bwd": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                         _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "stvd_train_tail": [_P, _P, _I, _P, _L, _P, _L, _P, _P, _P, _P, _I, _I,
                        _I, _P],
    "stvd_dws_splits": [_L, _I, _I, _I],
    "stvd_dws_gemm": [_P, _P, _I, _P, _P, _L, _I, _I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()   # server threads may race the first build
build_seconds: float = 0.0


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand, "bin", "nvcc")
        if cand and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def compile_command(nvcc: str, source: str, obj: str) -> list:
    """One source's nvcc command (a header is found beside the source
    that includes it, so no include path is passed)."""
    return [nvcc, *NVCC_FLAGS, "-c", "-o", obj, source]


def link_command(nvcc: str, so: str, objs) -> list:
    return [nvcc, *LINK_FLAGS, "-o", so, *objs]


def _digest() -> str:
    # the commands themselves, paths left blank: every flag they pass
    h = hashlib.sha256(repr((compile_command("", "", ""),
                             link_command("", "", []))).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libstvd_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists:
    one ``nvcc -c`` per source in parallel, then one link.  The
    compiler's report (registers, spills) goes to ``build.log``."""
    global build_seconds
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [str(Path(tmpdir, Path(name).stem + ".o")) for name in SOURCES]
        cmds = [compile_command(nvcc, str(_CSRC / name), obj)
                for name, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        outputs = [proc.communicate()[0] for proc in procs]
        so = str(Path(tmpdir, out.name))
        link = link_command(nvcc, so, objs)
        failed = [(cmd, text) for cmd, text, proc
                  in zip(cmds, outputs, procs) if proc.returncode != 0]
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            outputs.append(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append((link, outputs[-1]))
        (BUILD_DIR / "build.log").write_text("".join(
            " ".join(cmd) + "\n" + text
            for cmd, text in zip(cmds + [link], outputs)))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                " ".join(cmd) + "\n" + text[-4000:] for cmd, text in failed))
        os.replace(so, out)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, by one thread)."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                so = ctypes.CDLL(str(build()))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(so, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _lib = so
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
