"""What every cell of the benchmark shares: finding a cell's files by name,
the weights and the feature bank made from the seed on the device, the
trace window and its reduction, and the result line.

Everything a cell needs is found by the names in ``BENCHMARK.json``:

    configs/<config>.json   a model configuration (the recipe's sections)
    traffic/<traffic>.json  a traffic mix, naming its driver
    drivers/<driver>.py     ``run(ctx) -> Readings``, and ``calibrate``
                            for ``gpubench.calibrate``
    metrics/<metric>.py     ``read(readings) -> float | None``
    limits/<cell>.json      the limit of each number the check compares

so a later cell, mix or metric is a new file and a new entry.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that no process of the benchmark may load: JAX
# and the JAX package beside the port (compared whole, so ``stvd_torch``
# is not ``stvd``)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "stvd")

# NVIDIA H100 SXM data sheet, dense: HBM3 3.35 TB/s; tensor cores 989
# TFLOP/s bf16; 67 TFLOP/s float32 outside them (frozen from chip_smoke.py)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}


def bound_s(n_bytes: float, n_ops: float, kind: str) -> float:
    """The least time the card could take for a call: the larger of its
    bytes (each input read once, each output written once) over the
    memory rate and its operations over the peak rate of their type."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS_PER_S[kind])


# ---------------------------------------------------------------------------
# Finding things by name
# ---------------------------------------------------------------------------

def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str, here: Path = HERE) -> dict:
    return load_json(here / "configs" / f"{name}.json")


def traffic(name: str, here: Path = HERE) -> dict:
    return load_json(here / "traffic" / f"{name}.json")


def limits(cell_name: str, here: Path = HERE) -> Dict[str, float]:
    return load_json(here / "limits" / f"{cell_name}.json")


def load_module(kind: str, name: str, here: Path = HERE):
    """``<kind>/<name>.py`` as a module (a metric's name may hold dots),
    from ``here`` or else from the benchmark's own folder; a file of the
    benchmark's own folder whose name is a module name is imported as
    ``gpubench.<kind>.<name>``, the one module of that file."""
    path = here / kind / f"{name}.py"
    if not path.is_file():
        path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {name}.py")
    if path.parent.parent == HERE and name.isidentifier():
        return importlib.import_module(f"gpubench.{kind}.{name}")
    spec = importlib.util.spec_from_file_location(
        f"gpubench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell_name: str, section: str) -> List[dict]:
    """The entries of ``section`` ('end_to_end' or 'per_layer') that the
    cell reports: those that list it, and those without a list whose
    end-to-end metric (``moves``, for a per-layer one) the cell reports."""
    e2e = [m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


# ---------------------------------------------------------------------------
# What a driver hands back
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Readings:
    """What a run measured: the window (host clock), counts of work, host
    spans, the traced window's device events, and the numbers the check
    compared. Metric readers take what they need from here."""

    cell: dict
    config: dict
    traffic: dict
    chips: int = 1
    setup_s: float = 0.0
    window_s: float = 0.0
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    trace: Optional["Trace"] = None
    compared: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0


# ---------------------------------------------------------------------------
# Weights and features made from the seed, on the device
# ---------------------------------------------------------------------------

def make_params(specs, generator, device) -> Dict[str, "torch.Tensor"]:
    """float32 weights of ``specs`` ((name, shape, std) tuples) from one
    draw of ``generator`` on ``device``, each a view of one buffer scaled
    in place."""
    import torch
    sizes = [math.prod(shape) for _, shape, _ in specs]
    flat = torch.randn(sum(sizes), generator=generator, device=device)
    out, o = {}, 0
    for (name, shape, std), n in zip(specs, sizes):
        out[name] = flat[o:o + n].view(shape).mul_(std)
        o += n
    return out


def frame_counts(n: int, lo: int, hi: int, rng) -> np.ndarray:
    """Frame counts lo..hi in turn, shuffled: the same multiset for every
    seed."""
    return rng.permutation(lo + np.arange(n) % (hi - lo + 1))


def make_bank(m: dict, n: int, counts: np.ndarray, generator, device,
              dtype) -> Dict[str, "torch.Tensor"]:
    """A feature bank of ``n`` videos on ``device`` in ``dtype``: each
    video a signature plus per-frame noise (unit scale), K = n_frames slots
    of which the first min(count, K) hold frames (a longer video is
    subsampled to K). Streams: frames (N, K, ctx or appearance dim),
    frame_mask (N, K) float32, regions (N, K, R, Dr) with spatial
    attention, motion (N, K, Dm) with the motion stream."""
    import torch
    k = m["n_frames"]
    valid = torch.from_numpy(np.minimum(counts, k)).to(device)
    mask = (torch.arange(k, device=device)[None] < valid[:, None]).float()

    def stream(*tail):
        out = torch.empty((n, k) + tail, dtype=dtype, device=device)
        step = max(1, (1 << 28) // max(1, k * math.prod(tail)))
        for s in range(0, n, step):
            e = min(n, s + step)
            base = torch.randn((e - s, 1) + tail, generator=generator,
                               device=device)
            noise = torch.randn((e - s, k) + tail, generator=generator,
                                device=device)
            x = 0.8 * base + 0.6 * noise
            x *= mask[s:e].view((e - s, k) + (1,) * len(tail))
            out[s:e] = x.to(dtype)
        return out

    frame_dim = m["ctx_dim"]
    bank = {"frames": stream(frame_dim), "frame_mask": mask}
    if m.get("use_spatial"):
        bank["regions"] = stream(m["n_regions"], m["region_dim"])
    if m.get("use_motion"):
        bank["motion"] = stream(m["motion_dim"])
    return bank


def pinned_host(t: "torch.Tensor", chunk_bytes: int = 1 << 28
                ) -> np.ndarray:
    """``t`` as a numpy array in pinned host memory, copied from the card a
    chunk of rows at a time; bf16 becomes float16, which numpy has, in
    half the bytes of float32 (a unit-scale feature's bf16 values all
    but exactly: about 2 in a million, the smallest, move by up to 3e-8).
    On the CPU a plain copy."""
    import torch
    dtype = torch.float16 if t.dtype == torch.bfloat16 else t.dtype
    if t.device.type != "cuda":
        return t.to(dtype).numpy().copy()
    out = torch.empty(tuple(t.shape), dtype=dtype, pin_memory=True)
    rows = max(1, chunk_bytes // max(1, out[:1].nbytes))
    for s in range(0, t.shape[0], rows):
        out[s:s + rows].copy_(t[s:s + rows])
    return out.numpy()


def vocab_words(n_words: int) -> Dict[str, int]:
    """A vocabulary of ``n_words`` ids with one word each (0 is EOS and 1
    UNK by the recipes' convention), so a caption maps back to its ids."""
    return {f"w{i}": i for i in range(2, n_words)}


def caption_ids(text: str, words: Dict[str, int], maxlen: int) -> List[int]:
    """A served caption's ids, EOS-terminated when shorter than maxlen."""
    toks = [1 if w == "UNK" else words[w] for w in text.split()]
    if len(toks) < maxlen:
        toks.append(0)
    return toks


# ---------------------------------------------------------------------------
# Device, environment and the result line
# ---------------------------------------------------------------------------

def device_info(chips: int) -> dict:
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "torch": torch.__version__,
            "cuda": torch.version.cuda}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def forbidden_loaded() -> List[str]:
    """Modules of JAX or the JAX package in this process, by top-level
    name."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN_MODULES})


def run_environment() -> None:
    """Keep libraries from loading JAX on their own."""
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def percentile(values: List[float], q: float) -> Optional[float]:
    """The q-th percentile (linear between order statistics)."""
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def emit(d: dict) -> None:
    """One JSON line on standard output."""
    print(json.dumps(d), flush=True)


class Phases:
    """The set-up's phases on the host clock: ``mark(name)`` ends the phase
    that began at the previous mark (the first at ``start``) and prints its
    seconds to standard error, so a run shows where its set-up went."""

    def __init__(self, start: float):
        self.last = start
        self.seconds: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        took, self.last = now - self.last, now
        self.seconds[name] = self.seconds.get(name, 0.0) + took
        say(f"setup {name} {took:.3f} s")


# ---------------------------------------------------------------------------
# The traced window
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Trace:
    """A profiled window reduced to device intervals: kernels (and copies)
    as (name, start_us, end_us), the window's start and end, counts of the
    driver's work inside it, and the host operation in progress at the
    start of each idle gap."""

    start_us: float
    end_us: float
    kernels: List[tuple]
    host: List[tuple]
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_intervals(self) -> List[tuple]:
        """The union of the device intervals, clipped to the window."""
        out: List[list] = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            s, e = max(s, self.start_us), min(e, self.end_us)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def device_s(self, match: Callable[[str], bool]) -> float:
        """Summed device seconds of the kernels whose name ``match``es."""
        return sum(e - s for n, s, e in self.kernels if match(n)) / 1e6

    def calls(self, match: Callable[[str], bool]) -> int:
        return sum(1 for n, _, _ in self.kernels if match(n))

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.kernels:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[k[:120], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The device's idle time by what the host was doing when each gap
        began: the benchmark's innermost span open then (``bench.*``) and
        the innermost host operation open then; the ``n`` largest."""
        import bisect
        busy = self.busy_intervals()
        edges = [self.start_us] + [x for iv in busy for x in iv] + [
            self.end_us]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        spans = sorted((h for h in self.host if h[0].startswith("bench.")
                        and h[0] != "bench.window"), key=lambda h: h[1])
        ops = sorted((h for h in self.host
                      if not h[0].startswith("bench.")), key=lambda h: h[1])

        def open_at(seq, starts, t, look):
            i = bisect.bisect_right(starts, t)
            for j in range(i - 1, max(-1, i - look), -1):
                if seq[j][2] >= t:
                    return seq[j][0]
            return None

        s_starts, o_starts = [h[1] for h in spans], [h[1] for h in ops]
        by: Dict[str, float] = {}
        for g0, g1 in gaps:
            parts = (open_at(spans, s_starts, g0, 64),
                     open_at(ops, o_starts, g0, 400))
            label = " > ".join(x for x in parts if x) or "host idle"
            by[label] = by.get(label, 0.0) + (g1 - g0) / 1e6
        return [[k[:120], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def start_trace(stack, dev):
    """Enter a profile of CPU and CUDA activity, and the ``bench.window``
    span that bounds the traced window, on ``stack``; returns the
    profile."""
    import torch
    prof = stack.enter_context(torch.profiler.profile(
        activities=profiler_activities(dev)))
    stack.enter_context(torch.profiler.record_function("bench.window"))
    return prof


def profiler_activities(dev) -> list:
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def warm_profiler(dev) -> None:
    """Profile one small operation, so that the profiler's own start-up
    (CUPTI and Kineto) falls in the set-up and not in the traced window."""
    import torch
    with torch.profiler.profile(activities=profiler_activities(dev)) as p:
        torch.ones(8, device=dev).sum().item()
    p.events()


def reduce_profile(prof, counts: Dict[str, float]) -> Trace:
    """A ``torch.profiler.profile`` (CPU and CUDA activities) reduced to a
    ``Trace`` in microseconds: device kernels, copies and sets (not the
    device's copies of host annotations); host operations; the window is
    the ``bench.window`` annotation. Reads the profiler's raw events,
    which is many times faster than building its event tree."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kernels, host = [], []
    lo, hi = math.inf, -math.inf
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s, e = ev.start_ns() / 1e3, ev.end_ns() / 1e3
        if ev.device_type() == cuda:
            if (ev.is_user_annotation() or name.startswith("bench.")
                    or name.startswith("Activity Buffer")):
                continue
            kernels.append((name, s, e))
        else:
            host.append((name, s, e))
            if name == "bench.window":
                lo, hi = s, e
    if not math.isfinite(lo):
        every = kernels + host
        lo = min(x[1] for x in every)
        hi = max(x[2] for x in every)
    return Trace(lo, hi, kernels, host, dict(counts))


def result_line(correct: bool, r: Readings, metrics: Dict[str, dict],
                device: dict, trace: bool) -> dict:
    dev = dict(device)
    dev["memory_peak_bytes"] = int(r.memory_peak_bytes)
    out = {"correct": bool(correct), "attempted": int(r.attempted),
           "failed": int(r.failed), "metrics": metrics, "device": dev}
    if trace and r.trace is not None:
        dev["busy_s"] = r.trace.busy_s()
        dev["window_s"] = r.trace.window_s
        out["breakdown"] = {"device_ops": r.trace.top_ops(),
                            "idle_gaps": r.trace.idle_gaps()}
    out["compared"] = r.compared
    return out
