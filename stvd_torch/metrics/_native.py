"""ctypes loader for the C++ metrics core, with the port's own build.

The port compiles ``native/metrics_core.cpp`` (read, never written) with
the host C++ compiler and ``native/Makefile``'s flags into
``build/stvd_torch/libstvd_metrics_<hash>.so``, named by a hash of the
source and the command, so an unchanged tree reuses it.  A build
compiles to a temporary name in that directory and ``os.replace``s it
into place: a process that reads the library sees either no file or a
whole one, however many processes build at once, and a process that
finds the final name loads it without building.

The port uses the core for ROUGE-L's LCS and METEOR's alignment only:
its BLEU and CIDEr n-gram counts key n-grams by a 64-bit mix of token
ids that is not injective (interned bigrams (44, 16) and (45, 81) share
a key), so the port counts n-grams in Python (``bleu.py``,
``cider.py``).

``STVD_NO_NATIVE=1`` asks for the pure-Python scorers, as in the JAX
package (every helper below then returns None).  Any other failure to
build or load the library raises, with the compiler's output.
``python -m stvd_torch.metrics._native`` builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "metrics_core.cpp"
BUILD_DIR = _REPO / "build" / "stvd_torch"
# native/Makefile: $(CXX) $(CXXFLAGS) -shared -o $@ $(SRCS)
CXXFLAGS = ("-O3", "-mtune=native", "-std=c++17", "-fPIC", "-Wall",
            "-Wextra")

_lib: Optional[ctypes.CDLL] = None


def _cxx_name() -> str:
    return os.environ.get("CXX") or "g++"


def _cxx() -> str:
    cxx = _cxx_name()
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found: the metrics "
                           "core needs one (set CXX), or set "
                           "STVD_NO_NATIVE=1 for the pure-Python scorers")
    return found


def compile_command(cxx: str, out: str) -> list:
    return [cxx, *CXXFLAGS, "-shared", "-o", out, str(SOURCE)]


def library_path() -> Path:
    """The library's name in ``BUILD_DIR``: a hash of the source and the
    compile command (compiler name and flags, paths left out)."""
    h = hashlib.sha256(repr(compile_command(_cxx_name(), "")).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libstvd_metrics_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """The library's path, compiled first unless it exists: to a
    temporary file beside it, moved into place by ``os.replace``."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.stem + ".", suffix=".tmp",
                               dir=out.parent)
    os.close(fd)
    try:
        cmd = compile_command(_cxx(), tmp)
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"metrics core build failed (rc {proc.returncode}):\n"
                + " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        os.chmod(tmp, 0o755)     # mkstemp made it private
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(path: Path) -> ctypes.CDLL:
    """``ctypes.CDLL`` of a built library, with its C signatures."""
    lib = ctypes.CDLL(str(path))
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.stvd_lcs_len.argtypes = [i32p, ctypes.c_int32, i32p, ctypes.c_int32]
    lib.stvd_lcs_len.restype = ctypes.c_int32
    lib.stvd_meteor_align.argtypes = [i32p, i32p, i32p, ctypes.c_int32,
                                      i32p, i32p, i32p, ctypes.c_int32,
                                      i32p, i32p]
    lib.stvd_meteor_align.restype = None
    lib.stvd_meteor_corpus.argtypes = [i32p, i32p, i32p, i32p, i32p, i32p,
                                       i32p, ctypes.c_int32,
                                       ctypes.c_double, ctypes.c_double,
                                       ctypes.c_double, i32p]
    lib.stvd_meteor_corpus.restype = None
    lib.stvd_lcs_batch.argtypes = [i32p, i32p, i32p, i32p, ctypes.c_int32,
                                   i32p, i32p, i32p]
    lib.stvd_lcs_batch.restype = None
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded core (built on first call); None when
    ``STVD_NO_NATIVE`` is set, read at every call."""
    global _lib
    if os.environ.get("STVD_NO_NATIVE"):
        return None
    if _lib is None:
        _lib = load(build())
    return _lib


def _as_i32(x: Sequence[int]) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, dtype=np.int32))


def _csr(items) -> Tuple[np.ndarray, np.ndarray]:
    """Id arrays flattened, with their offsets (CSR layout)."""
    off = np.zeros(len(items) + 1, np.int32)
    for i, x in enumerate(items):
        off[i + 1] = off[i] + len(x)
    flat = (np.concatenate([_as_i32(x) for x in items])
            if items else np.zeros(0, np.int32))
    return np.ascontiguousarray(flat), np.ascontiguousarray(off)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class Interner:
    """string -> contiguous int32 ids (tokens cross the C ABI as ids)."""

    def __init__(self):
        self._d: Dict[str, int] = {}

    def __call__(self, toks: Sequence[str]) -> np.ndarray:
        d = self._d
        out = np.empty(len(toks), np.int32)
        for i, t in enumerate(toks):
            v = d.get(t)
            if v is None:
                v = len(d)
                d[t] = v
            out[i] = v
        return out


def lcs_len(a_ids: np.ndarray, b_ids: np.ndarray) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    a = _as_i32(a_ids)
    b = _as_i32(b_ids)
    return int(lib.stvd_lcs_len(_ptr(a), len(a), _ptr(b), len(b)))


def meteor_align(hyp, hyp_stem, hyp_syn, ref, ref_stem, ref_syn
                 ) -> Optional[Tuple[int, int]]:
    """Returns (matches, chunks) or None if native lib unavailable.

    References longer than 62 tokens return None (the native beam
    resolver tracks used ref positions in a 64-bit mask); the caller's
    pure-Python resolver has no such limit."""
    lib = get_lib()
    if lib is None or len(ref) > 62:
        return None
    h, hs = _as_i32(hyp), _as_i32(hyp_stem)
    r, rs = _as_i32(ref), _as_i32(ref_stem)
    if hyp_syn is None or ref_syn is None:
        hy = ry = None
        hyp_ptr = syn_null = ctypes.cast(None, ctypes.POINTER(ctypes.c_int32))
        rp = syn_null
    else:
        hy, ry = _as_i32(hyp_syn), _as_i32(ref_syn)
        hyp_ptr, rp = _ptr(hy), _ptr(ry)
    m = ctypes.c_int32(0)
    c = ctypes.c_int32(0)
    lib.stvd_meteor_align(_ptr(h), _ptr(hs), hyp_ptr, len(h),
                          _ptr(r), _ptr(rs), rp, len(r),
                          ctypes.byref(m), ctypes.byref(c))
    return int(m.value), int(c.value)


def lcs_batch(hyp_ids, refs_ids) -> Optional[np.ndarray]:
    """LCS lengths for every (video hyp, video ref) pair in one call.

    Returns a flat int32 array ordered video-major (all of video 0's
    refs, then video 1's, ...), or None without the native lib.
    """
    lib = get_lib()
    if lib is None:
        return None

    h_flat, h_off = _csr(hyp_ids)
    all_refs = [r for refs in refs_ids for r in refs]
    r_flat, r_off = _csr(all_refs)
    pair_h, pair_r = [], []
    ri = 0
    for v, refs in enumerate(refs_ids):
        for _ in refs:
            pair_h.append(v)
            pair_r.append(ri)
            ri += 1
    ph = _as_i32(pair_h)
    pr = _as_i32(pair_r)
    out = np.zeros(len(pair_h), np.int32)
    lib.stvd_lcs_batch(_ptr(h_flat), _ptr(h_off), _ptr(r_flat), _ptr(r_off),
                       np.int32(len(pair_h)), _ptr(ph), _ptr(pr), _ptr(out))
    return out


def meteor_corpus(hyp_ids, hyp_stems, refs_ids, refs_stems,
                  alpha: float, beta: float, gamma: float
                  ) -> Optional[np.ndarray]:
    """Per-video best-ref (m, hlen, rlen, chunks), or None.

    ``hyp_ids[v]`` / ``hyp_stems[v]``: id arrays; ``refs_ids[v]`` /
    ``refs_stems[v]``: lists of id arrays.
    """
    lib = get_lib()
    if lib is None:
        return None
    n_vid = len(hyp_ids)

    h_flat, h_off = _csr(hyp_ids)
    hs_flat, _ = _csr(hyp_stems)
    all_refs = [r for refs in refs_ids for r in refs]
    all_stems = [r for refs in refs_stems for r in refs]
    r_flat, r_off = _csr(all_refs)
    rs_flat, _ = _csr(all_stems)
    vid_off = np.zeros(n_vid + 1, np.int32)
    for v, refs in enumerate(refs_ids):
        vid_off[v + 1] = vid_off[v] + len(refs)
    out = np.zeros(n_vid * 4, np.int32)
    lib.stvd_meteor_corpus(
        _ptr(h_flat), _ptr(hs_flat), _ptr(h_off),
        _ptr(r_flat), _ptr(rs_flat), _ptr(r_off),
        _ptr(np.ascontiguousarray(vid_off)), np.int32(n_vid),
        float(alpha), float(beta), float(gamma), _ptr(out))
    return out.reshape(n_vid, 4)


if __name__ == "__main__":
    print("metrics core:", build())
