#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one
NVIDIA GPU.

Builds the port's seven CUDA kernels from ``stvd_torch/csrc``, holds each
against its plain PyTorch version at the shapes of the paths below
(reporting its time beside the plain version's, the least time the card
could take for the work, and, for the dWs_att GEMM and the bf16
gates+LSTM step, the time of the one PyTorch call that computes it),
then drives at full width with random
weights made from ``--seed`` (dim 3584, dim_word 512, ctx 1024, K 28,
vocab 13056, bf16):

* serving through ``stvd_torch.api.Captioner`` (beam 5, decode batch
  256): preset 3 (``msvd-beam``: attention core + logit tail, cuBLAS
  gates), preset 2 (``msvd-spatial``, R 49, Dr 1024: + the spatial
  core) and preset 3 with ``decode_quant='int8'``, ``gates_kernel='on'``
  (+ the W8A8 gates+LSTM kernel);
* training through ``stvd_torch.train.loop.make_train_step`` (batch 64,
  T 30, adadelta, clip 10): preset 2 (spatial backward step and dWs_att
  GEMM) and preset 3 with ``train_tail_kernel='on'`` (train-scan tail);
* the autograd train scans (``train_autodiff``): preset 3 with
  scheduled sampling (``ss_prob=0.25``) and preset 2's autodiff scan
  with remat through ``make_train_step(mcfg, tcfg,
  kernel.step_kernels)``, kernels 1 and 4 carrying gradients through
  their autograd Functions; float32 gradients of the kernel step
  against the plain step and of the autodiff scan against the hand VJP;
  the sampled tokens of kernel and plain steps on the same coins; a
  3-update ``fit`` with scheduled sampling, the profiler window and
  ``debug_nans``;
* model selection through ``stvd_torch.train.loop.fit`` (``eval_fit``):
  a corpus written to disk and read back by ``load_splits``, preset 3
  trained at bucketed lengths with the train-scan tail, valid and test
  decoded (attention core, logit tail) and scored by METEOR each round;
* the user entry points (``cli``), preset 3 on such a corpus:
  ``stvd_torch.cli.train`` (train-scan tail on), ``cli.sample`` (beam
  samples, n-best, top-k sampling, attention maps, NLL), ``cli.score``,
  ``cli.convert`` of the bank, and ``cli.serve`` over the run dir with
  the bank resident (feature, n-best, id and concurrent requests, and a
  weight swap), each request's captions held to ``Captioner``'s;
* AOT serving artifacts (``aot``): preset 3 exported by
  ``stvd_torch.export_aot.save_artifact`` at batch sizes 1 and 256 with
  n-best graphs, ``cli.export --check`` in a subprocess, 257 videos
  through the loaded graphs held to the live ``Captioner`` (every
  caption equal; kernels 1 and 2 launched as custom ops from inside the
  graph, 30 a chunk on their fast routes), artifact against live
  captions/s and one-video latency, ``cli.serve --artifact`` over HTTP
  with the bank resident (caption, ids, n-best, swap); path B and
  preset 2 (decode batch 64) as one export each;
* preset 4 (``msrvtt``: appearance and motion streams fused to a
  2048-wide float32 context, vocab 20096): kernels 1, 2 and 6 at its
  shapes (kernel 1 on its eight-warp cluster route), serving with and
  without the frame-LSTM encoder, the kernel step against the plain
  step, a training update and float32 gradients of kernel and plain
  paths, ``cli.convert --motion`` and ``cli.serve`` with the motion bank
  resident;
* the reference-exact recipes (``recipes``: ``recipes/msvd.json``, the
  spatial model at vocab 13010, and ``recipes/msrvtt.json``, dual stream
  at ctx 2048 and vocab 20000; both dim 3518, dim_word 468, loaded by
  ``Config.from_json``): kernel 2 at (1280, 468, V) and kernel 3 at Kx
  5010 / 6034 on the padded rows the decode stores, each against its
  plain version and timed beside its wmma route, the library product
  and ``torch.lstm_cell``; serving (beam 5, 256 videos, natural EOS and
  EOS suppressed) with every kernel-2 launch on wgmma, the worst case
  again with kernel 2 forced onto wmma; the int8 decode with the gates
  kernel on (every kernel-3 launch on wgmma); the kernel step against
  the plain step (float32; int8 against plain int8 gates and the
  all-plain step, msvd's at 64 videos); one training update each;
* preset 5 (``msvd-dp``, ``data_parallel``) on two ranks that share the
  card over gloo (spawned processes; NCCL refuses two ranks on one
  card): data-parallel training through ``make_train_step(..., mesh,
  use_shard_map)`` (ranks equal bit for bit, the float32 update equal
  to one process's), ``cli.train --data-parallel``, the validation
  decode split over the ranks and a bank sharded over them
  (``caption_ids``, ``nbest_ids``), every caption equal to the
  single-device decode of the same batch.  Its times are of two ranks
  sharing one card: no scaling figure;
* tensor parallelism (``tensor_parallel``) on ranks that share the card
  over gloo, meshes of 1 x 2 and 2 x 2 (data x model): presets 3 and 2
  trained with the weights sharded by ``TP_RULES`` (the gathered weights
  against one process's, the replicated ones bitwise equal on the ranks,
  kernels 5 and 7 on each rank, kernel 7 on its Dr slice), preset 3
  decoded by ``make_tp_beam_decode`` and ``generate_captions(...,
  mesh)`` with kernel 2 on each rank's vocab shard (captions against the
  single-device decode), ``cli.train --model-parallel 2`` and its
  checkpoint in one process.  No scaling figure either;
* sharded serving (``sharded_serving``) on ranks that share the card
  over gloo: ``cli.serve --bank-shards 2`` as a two-rank daemon driven
  over HTTP, ``cli.export --data-parallel 2`` and that artifact served
  by the daemon with the bank on its mesh, ``cli.export
  --model-parallel 2`` graphs (kernel 2 on each rank's vocab shard from
  inside the graph) against the live TP decode, int8 decode under DP
  (kernel 3 on each rank) and TP (the int32 reduce), the TP decode of
  ``eval_fit``'s fitted weights, and the 2 x 4 layout on 8 ranks.

Each path's kernel launches are counted from zero over its run: those of
the path must equal its decode steps (serving and the entry points; the
logit tail and the int8 gates+LSTM step all on their wgmma routes), its
scan steps (the train-scan tail of the entry points) or 30 per update (the
dWs_att GEMM once, all on its wgmma route; the spatial backward step all
on its 16-byte-load route; the train-scan tail all on its wgmma route),
the others 0.  The kernels with routes (logit tail, gates+LSTM step,
spatial backward step, train-scan tail, dWs_att GEMM) also report the
route each case took, their share of the bound, and that two calls agree
bit for bit; the logit tail, the gates step and the train-scan tail are
timed beside their wmma route and the library product (``torch.mm``,
``torch._int_mm``), the bf16 gates step beside ``torch.lstm_cell``.  The
kernel path is then compared with the plain path: decoded captions on
the serving paths, the loss and every gradient of one preset-2 train
step at float32.

Each phase prints one JSON line with its seconds; the card's
``nvidia-smi`` name and power limit, then a ``{"kernels": [...]}``
summary come before the last line, ``{"ok": true, "device": {...}}``.
Any failed check raises, so the run exits non-zero and prints no result.
There is no CPU path: without a CUDA device the script exits 1.

    python3 chip_smoke.py [--seed N] [--profile]
    python3 chip_smoke.py --serving-only [--root TREE]   # serving A/B
    python3 chip_smoke.py --kernels-only [--root TREE]   # kernels 6, 3 A/B
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

NAME = "msvd-beam"     # preset 3: the serving path bench.py measures
SPATIAL = "msvd-spatial"   # preset 2: the model the paper is named for
MSRVTT = "msrvtt-fused"    # preset 4: appearance + motion, ctx 2048
DP = "msvd-dp"             # preset 5: data-parallel training
KERNEL_TOL = 1e-4      # float32 sums over A=1024 / K=28 / dw=512 in another order
INT8_TOL = 1e-5        # int32 sums are exact; only the pointwise math differs
TRAIN_BF16_TOL = 1e-2  # of the largest entry: one bf16 ulp of tanh may flip
GRAD_TOL = 1e-4        # per leaf, of its largest entry: kernel vs plain
# int8 decode, kernel step against the all-plain step: it read 0.922-0.957
# over runs and weight draws, the attention core's first design and the
# tree before it 0.953 on the same weights and videos (PERF.md)
INT8_PLAIN_SHARE = 0.90
KERNELS = ("attention_core", "spatial_core", "gates_lstm", "logit_tail",
           "spatial_bwd", "train_tail", "dws_gemm")
# the route every launch of a serving path must take
SERVING_ROUTES = {"attention_core": "cluster", "logit_tail": "wgmma"}
# NVIDIA H100 SXM data sheet, dense: HBM3 3.35 TB/s; tensor cores 989
# TFLOP/s bf16, 1979 TOP/s int8; 67 TFLOP/s float32 outside them
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


_T0 = [time.perf_counter()]


def emit(obj) -> None:
    """One JSON line; a phase line also carries its seconds."""
    if "phase" in obj:
        now = time.perf_counter()
        obj["phase_seconds"] = now - _T0[0]
        _T0[0] = now
    print(json.dumps(obj), flush=True)


def reset_launches(kernel) -> None:
    for name in KERNELS:
        fn = getattr(kernel, name)
        fn.launches = 0
        for route in getattr(fn, "launches_by_route", {}):
            fn.launches_by_route[route] = 0


def read_routes(kernel) -> dict:
    """Launches by route of the kernels that have more than one."""
    return {name: dict(getattr(kernel, name).launches_by_route)
            for name in KERNELS
            if hasattr(getattr(kernel, name), "launches_by_route")}


def route_taken(fn, call):
    """``call()``'s result and the one route of ``fn`` it launched."""
    before = dict(fn.launches_by_route)
    out = call()
    taken = [r for r, n in fn.launches_by_route.items() if n != before[r]]
    require(len(taken) == 1, f"expected one launch on one route: {taken}")
    return out, taken[0]


def read_launches(kernel) -> dict:
    return {name: getattr(kernel, name).launches for name in KERNELS}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, iters: int = 50) -> float:
    """Device time of one call, from CUDA events around ``iters`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph,
    replayed and timed by CUDA events, so the wrappers' host work (tens of
    microseconds a call) does not hide a shorter kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def cold_device_ms(fn, iters: int = 20) -> float:
    """Device time of one call that finds the L2 cold, as in the train
    scan, where other products run between two calls: in the graph each
    call follows a 128 MB write (more than the 50 MB L2), whose own
    device time, captured alone, is taken off."""
    buf = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    both = device_ms(lambda: (buf.zero_(), fn()), iters)
    alone = device_ms(buf.zero_, iters)
    del buf
    return both - alone


def max_err(got, ref) -> float:
    return max(float((g.float() - r.float()).abs().max())
               for g, r in zip(got, ref))


def rel_err(got, ref) -> float:
    """Max abs difference over the reference's largest entry."""
    return max(float((g.float() - r.float()).abs().max())
               / max(float(r.float().abs().max()), 1e-30)
               for g, r in zip(got, ref))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float, kind: str) -> dict:
    """The least time the card could take for the work: the larger of
    its bytes (each input read once, each output written once) over the
    memory rate and its operations over the peak rate of their type
    (tanh and exp count as one operation)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": n_ops, "ops_type": kind}


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": line,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build(build) -> None:
    t0 = time.perf_counter()
    cached = build.library_path().is_file()
    build.lib()
    log = build.BUILD_DIR / "build.log"
    ptxas = ([ln.strip() for ln in log.read_text().splitlines()
              if "registers" in ln or "spill" in ln] if log.is_file() else [])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": build.build_seconds, "cached": cached,
          "ptxas": ptxas})


def repeats(fn, args) -> bool:
    """Whether two calls of ``fn(*args)`` agree bit for bit."""
    first, second = fn(*args), fn(*args)
    torch.cuda.synchronize()
    return all(torch.equal(p, q) for p, q in zip(first, second))


def phase_attention(kernel, step_mod, dev, g, cfg, splits=False,
                    shapes=None, phase="kernel_attention_core") -> dict:
    """Kernel 1 at the serving shape (preset 3: Bc=256, nb=5, K=28,
    A=Dc=1024, ctx bf16), at the training shape (batch 64, nb 1: the
    train forward scan with ``train_fwd_kernel='on'``) and at path A's
    (its float32 per-beam context: 1280 rows of 1 beam), pctx float32;
    masked frames, one fully-masked row and one row whose last cluster
    CTA holds only masked frames.  Each must take route 'cluster', agree
    with the plain version and repeat bit for bit; each is timed beside
    route 'simple' on the same operands.  ms and simple_ms are CUDA-event
    times of the wrapper called back to back, as for every other kernel,
    which the wrapper's host work bounds here; device_ms and
    simple_device_ms are device times (``device_ms``).  With ``splits``
    (--profile), split_ms gives the device time with 1-4 CTAs a row.
    ``shapes`` ((name, rows, nb, ctx dtype) tuples) replaces the three
    cases, e.g. preset 4's (its fused context is float32)."""
    m = cfg.model
    k, a, dc = m.n_frames, m.attn_dim, m.ctx_dim
    rows = cfg.decode.decode_batch
    cases = {}
    for name, bc, nb, cdt in shapes or (
            ("serving", rows, cfg.decode.beam_size, torch.bfloat16),
            ("training", cfg.train.batch_size, 1, torch.bfloat16),
            ("path_a", rows * cfg.decode.beam_size, 1, torch.float32)):
        hp = torch.randn(bc * nb, a + 1, generator=g, device=dev)
        pctx = 0.5 * torch.randn(bc, k, a, generator=g, device=dev)
        ctx = torch.randn(bc, k, dc, generator=g, device=dev).to(cdt)
        mask = (torch.rand(bc, k, generator=g, device=dev) > 0.25).float()
        mask[:, 0] = 1.0
        n_split, kc = kernel.attention_core_split(k, nb, a, dc,
                                                  ctx.element_size())
        mask[3, (n_split - 1) * kc:] = 0.0
        mask[7] = 0.0
        u = 3.0 * torch.randn(a, generator=g, device=dev) / a ** 0.5
        c_att = torch.tensor(0.1, device=dev)
        b_sel = torch.tensor(-0.2, device=dev)
        errs = {}
        for selector in (True, False):
            args = (hp[:, :a], hp[:, a], pctx, ctx, mask, u, c_att, b_sel,
                    selector)
            got, route = route_taken(kernel.attention_core,
                                     lambda: kernel.attention_core(*args))
            ref = step_mod._attention_core(*args)
            torch.cuda.synchronize()
            errs[f"selector_{selector}"] = max_err(got, ref)
            require(route == "cluster",
                    f"attention kernel {name} took the {route} route")
            require(float(got[1][7 * nb:8 * nb].abs().max()) == 0.0
                    and float(got[0][7 * nb:8 * nb].abs().max()) == 0.0,
                    "attention kernel: fully-masked row is not zero")
            require(bool(torch.isfinite(got[0]).all()),
                    "attention kernel: non-finite output")
        err = max(errs.values())
        require(err <= KERNEL_TOL, f"attention kernel {name} disagrees: "
                                   f"{errs}")
        args = (hp[:, :a], hp[:, a], pctx, ctx, mask, u, c_att, b_sel, True)
        same = repeats(kernel.attention_core, args)
        require(same, f"attention kernel {name} is not deterministic")
        bs = bc * nb
        # in: h_att, beta, pctx, ctx, mask, u; out: ctx_t, alpha.  Per
        # (row, frame): tanh-score over A, then the context sum over Dc
        traffic = (4 * bs * (a + 1) + nbytes(pctx, ctx, mask, u)
                   + 4 * bs * (dc + k))

        def simple():
            return kernel._attention_core_cuda(*args, route="simple")
        cases[name] = {
            "shape": [bc, nb, k, a, dc], "ctx": str(cdt).split(".")[-1],
            "max_abs_err": err, "errs": errs, "route": route,
            "splits": n_split, "bitwise_repeatable": same,
            "ms": time_ms(lambda: kernel.attention_core(*args)),
            "simple_ms": time_ms(simple),
            "device_ms": device_ms(lambda: kernel.attention_core(*args)),
            "simple_device_ms": device_ms(simple),
            "plain_ms": time_ms(lambda: step_mod._attention_core(*args)),
            "library_ms": None,
            **bound(traffic, bs * k * (4 * a + 2 * dc), "f32")}
        c = cases[name]
        if splits:
            # a plan whose ctx slice does not fit shared memory (1 CTA a
            # row of 28 float32 frames of 2048) has no time
            c["split_ms"] = {n: device_ms(lambda: kernel._attention_core_cuda(
                *args, route="cluster", splits=n))
                if kernel.attention_core_route(
                    nb, k, a, dc, cdt, pctx.data_ptr(), ctx.data_ptr(),
                    -(-k // n)) == "cluster" else None
                for n in (1, 2, 3, 4)}
        c["bound_share"] = c["bound_ms"] / c["device_ms"]
        c["simple_ratio"] = c["device_ms"] / c["simple_device_ms"]
    out = {"phase": phase, "tol": KERNEL_TOL,
           "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
           "cases": cases, **{key: val for key, val in cases["serving"].items()
                              if key != "max_abs_err"}}
    emit(out)
    return out


def device_tanh(build, p, h, mode):
    """stvd_tanh_f32: tanh(p + h) on the card by ``mode``."""
    y = torch.empty_like(p)
    build.check(build.lib().stvd_tanh_f32(
        p.data_ptr(), h.data_ptr(), y.data_ptr(), p.numel(), mode,
        torch.cuda.current_stream().cuda_stream), "tanh kernel")
    torch.cuda.synchronize()
    return y


def phase_tanh(build, dev, seed) -> dict:
    """The device tanh of the TMA attention cores against torch.tanh in
    float64, over a dense float32 grid x of [-20, 20] (2^24 + 1 points)
    and +-0, +-inf, NaN: the score pass's product form of tanh(p + h)
    with p = fl(0.7 x), h = fl(0.3 x), its single-exponent form (taken out
    of the product form's range) and libdevice's tanhf, both of x.  Then
    p and h of opposite signs, where p + h cancels: p = fl(x + t), h = -t
    with t uniform on [-20, 20], through the score pass's form (the
    product form while |p| and |h| are below ~20.8); each point's error
    must stay within 3e-7 + 5e-8 (|p| + |h|), since C p and C h are each
    rounded."""
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                            float("nan")], device=dev)
    x = torch.cat([torch.linspace(-20, 20, 2 ** 24 + 1, device=dev),
                   special])
    zero = torch.zeros_like(x)
    modes = {}
    for mode, name in enumerate(("product", "single_exponent", "tanhf")):
        p, h = (x * 0.7, x * 0.3) if mode == 0 else (x, zero)
        ref = torch.tanh(p.double() + h.double())
        finite = torch.isfinite(ref)
        y = device_tanh(build, p, h, mode)
        err = float((y.double() - ref)[finite].abs().max())
        tail = y[-5:].tolist()
        modes[name] = {"worst_abs_err": err, "special": tail[:4],
                       "nan_kept": tail[4] != tail[4]}
        require(err <= 1e-6 and tail[:4] == [0.0, 0.0, 1.0, -1.0]
                and tail[4] != tail[4], f"device tanh {name}: {modes[name]}")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = x[:-5]
    t = 40.0 * torch.rand(x.shape, generator=g, device=dev) - 20.0
    p, h = x + t, -t
    err = (device_tanh(build, p, h, 0).double()
           - torch.tanh(p.double() + h.double())).abs()
    ratio = float((err / (3e-7 + 5e-8 * (p.abs() + h.abs()).double())).max())
    modes["product_opposite_signs"] = {
        "worst_abs_err": float(err.max()), "worst_share_of_bound": ratio}
    require(ratio <= 1.0, f"device tanh, opposite signs: "
                          f"{modes['product_opposite_signs']}")
    emit({"phase": "device_tanh", "points": x.numel(), "modes": modes,
          "worst_abs_err": max(modes[m]["worst_abs_err"]
                               for m in ("product", "single_exponent")),
          "worst_abs_err_opposite_signs": float(err.max())})
    return modes


def exact_tail_inputs(rows, dw, v, dtype, dev, rng):
    """Logits that are exact in float32 in any summation order (multiples
    of 1/16 below 2^20): top-k columns must agree exactly, ties included."""
    x = rng.randint(-1, 2, (rows, dw)).astype(np.float32)
    w = (rng.randint(-8, 9, (dw, v)) / 16.0).astype(np.float32)
    b = (rng.randint(-64, 65, v) / 16.0).astype(np.float32)
    return (torch.from_numpy(x).to(dev, dtype),
            torch.from_numpy(w).to(dev, dtype), torch.from_numpy(b).to(dev))


def padded_tail_inputs(step_mod, x, w, b):
    """Kernel 2's operands in the rows the decode gives it: x cast to W's
    dtype by the wrapper into padded rows, W padded once a decode call
    (``make_logit_tail``); both no-ops at widths of whole 16 bytes."""
    return step_mod.pad_cols(x), step_mod.pad_cols(w), b


def phase_tail(kernel, dev, g, seed, cfg, phase="kernel_logit_tail"
               ) -> dict:
    """Kernel 2 at the serving shapes (preset 3: rows=1280, dw=512,
    V=13056; or a recipe's dw 468, V 13010 / 20000) with k=5 and 1 in
    bf16, plus a vocab 61 columns shorter, float32 operands and all-zero
    weights, each on the padded rows the decode stores (``pad_cols``),
    and one W one element past 16-byte alignment; each case reports its
    route (padded operands must take wgmma, the unaligned W wmma).  Timed
    beside the plain version: the wmma route on the dense operands, and
    ``torch.mm`` of the product alone (``product_ms``: no one PyTorch call
    gives top-k and logsumexp, so ``library_ms`` is null)."""
    from stvd_torch.model import step as step_mod
    rows = cfg.decode.decode_batch * cfg.decode.beam_size
    dw, v = cfg.model.dim_word, cfg.model.n_words
    rng = np.random.RandomState(seed)
    cases = {}

    def check(name, x, w, b, k, exact, want):
        got, route = route_taken(kernel.logit_tail,
                                 lambda: kernel.logit_tail(x, w, b, k))
        ref = kernel._logit_tail_plain(x, w, b, k)
        torch.cuda.synchronize()
        same_idx = bool(torch.equal(got[1], ref[1]))
        err = max_err((got[0], got[2]), (ref[0], ref[2]))
        cases[name] = {"max_abs_err": err, "idx_equal": same_idx,
                       "route": route}
        require(err <= KERNEL_TOL, f"logit tail {name} disagrees: {err}")
        require(same_idx or not exact, f"logit tail {name}: top-k ids differ")
        require(route == want, f"logit tail {name} took the {route} route")
        return err

    for k in (5, 1):
        check(f"exact_bf16_k{k}", *padded_tail_inputs(
            step_mod, *exact_tail_inputs(rows, dw, v, torch.bfloat16, dev,
                                         rng)), k, True, "wgmma")
    check(f"exact_bf16_k5_v{v - 61}", *padded_tail_inputs(
        step_mod, *exact_tail_inputs(rows, dw, v - 61, torch.bfloat16, dev,
                                     rng)), 5, True, "wgmma")
    xu, wu, bu = padded_tail_inputs(step_mod, *exact_tail_inputs(
        rows, dw, v, torch.bfloat16, dev, rng))
    flat = torch.empty(wu.shape[0] * wu.stride(0) + 1, dtype=wu.dtype,
                       device=dev)
    wu = flat[1:].as_strided(wu.shape, wu.stride()).copy_(wu)
    require(wu.data_ptr() % 16 != 0, "the unaligned W is aligned")
    check("exact_bf16_k5_unaligned_w", xu, wu, bu, 5, True, "wmma")
    del flat, xu, wu, bu
    check("exact_f32_k5",
          *exact_tail_inputs(rows, dw, v, torch.float32, dev, rng), 5, True,
          "f32")
    x = torch.tanh(torch.randn(rows, dw, generator=g, device=dev))
    wd = (0.1 * torch.randn(dw, v, generator=g, device=dev)).bfloat16()
    w = step_mod.pad_cols(wd)
    b = torch.randn(v, generator=g, device=dev)
    check("gaussian_bf16_k5", x, w, b, 5, False, "wgmma")
    zeros = torch.zeros(dw, v, device=dev).bfloat16()
    vals, idx, lse = kernel.logit_tail(x, zeros, torch.zeros(v, device=dev),
                                       5)
    require(bool((idx == torch.arange(5, device=dev)).all()),
            "logit tail: zero weights must pick columns 0..4")
    require(float((lse - np.log(v)).abs().max()) <= KERNEL_TOL,
            "logit tail: zero weights must give lse = log(V)")
    cases["zero_weights_k5"] = {"idx_equal": True}

    xd = x.bfloat16()
    xb = step_mod.pad_cols(xd)
    first = kernel.logit_tail(xb, w, b, 5)
    second = kernel.logit_tail(xb, w, b, 5)
    torch.cuda.synchronize()
    same = all(torch.equal(p, q) for p, q in zip(first, second))
    require(same, "logit tail wgmma is not deterministic")
    err = max(c.get("max_abs_err", 0.0) for c in cases.values())
    ms = time_ms(lambda: kernel.logit_tail(xb, w, b, 5))
    wmma_ms = time_ms(lambda: kernel._logit_tail_cuda(xd, wd, b, 5,
                                                      route="wmma"))
    plain_ms = time_ms(lambda: kernel._logit_tail_plain(xb, w, b, 5))
    product_ms = time_ms(lambda: torch.mm(xb, w, out_dtype=torch.float32))
    # in: x, W, b; out: k values, k int64 ids and the lse per row
    traffic = nbytes(xb, w, b) + rows * (5 * 12 + 4)
    out = {"phase": phase, "shape": [rows, dw, v, 5],
           "row_strides": [xb.stride(0), w.stride(0)],
           "max_abs_err": err, "cases": cases, "tol": KERNEL_TOL,
           "route": cases["exact_bf16_k5"]["route"],
           "bitwise_repeatable": same, "ms": ms, "wmma_ms": wmma_ms,
           "plain_ms": plain_ms, "product_ms": product_ms,
           "library_ms": None,
           **bound(traffic, 2 * rows * dw * v, "bf16")}
    out["bound_share"] = out["bound_ms"] / ms
    out["wmma_ratio"] = ms / wmma_ms
    out["product_ratio"] = ms / product_ms
    emit(out)
    return out


def phase_spatial(kernel, step_mod, dev, g, cfg) -> dict:
    """Kernel 4 at the path-A shapes (preset 2: Bc=256, K=28, R=49,
    s=Dr=1024), pregion float32, regions bf16, h_satt a strided column
    slice of the h-projection, with nb = 5 and nb = 1: route 'tma', timed
    beside route 'simple' on the same operands (simple_ms), bit for bit
    repeatable.  The plain version runs at float32 on the same inputs
    (its e_s is 7.2 GB at nb=5)."""
    m = cfg.model
    bc, k, r, s, dr = (cfg.decode.decode_batch, m.n_frames, m.n_regions,
                       m.region_dim, m.region_dim)
    off = m.attn_dim + 1
    pregion = 0.5 * torch.randn(bc, k, r, s, generator=g, device=dev)
    regions = torch.randn(bc, k, r, dr, generator=g, device=dev).bfloat16()
    u = 3.0 * torch.randn(s, generator=g, device=dev) / s ** 0.5
    c_s = torch.tensor(0.2, device=dev)
    errs, times = {}, {}

    def traffic(nb):
        # in: h_satt, pregion, regions, u_s; out: spat (bf16), alpha_s.
        # Per (row, frame, region): tanh-score over s, weighted sum over Dr
        bs = bc * nb
        return bound(4 * bs * s + nbytes(pregion, regions, u)
                     + bs * k * (2 * dr + 4 * r),
                     bs * k * r * (4 * s + 2 * dr), "f32")

    for nb in (cfg.decode.beam_size, 1):
        hp = torch.randn(bc * nb, off + s, generator=g, device=dev)
        args = (hp[:, off:], pregion, regions, u, c_s)
        got, route = route_taken(
            kernel.spatial_core,
            lambda: kernel.spatial_core(*args, torch.float32))
        ref = step_mod._spatial_core(*args, torch.float32)
        torch.cuda.synchronize()
        require(all(bool(torch.isfinite(t).all()) for t in got),
                "spatial kernel: non-finite output")
        require(route == "tma", f"spatial kernel nb {nb} took {route}")
        errs[f"nb{nb}"] = max_err(got, ref)
        del ref, got
        same = repeats(kernel.spatial_core, (*args, torch.float32))
        require(same, f"spatial kernel nb {nb} is not deterministic")
        times[f"nb{nb}"] = {
            "route": route, "bitwise_repeatable": same,
            "ms": time_ms(lambda: kernel.spatial_core(*args, torch.float32)),
            "simple_ms": time_ms(lambda: kernel._spatial_core_cuda(
                *args, route="simple")),
            "plain_ms": time_ms(
                lambda: step_mod._spatial_core(*args, torch.float32), 5),
            **traffic(nb)}
        t = times[f"nb{nb}"]
        t["bound_share"] = t["bound_ms"] / t["ms"]
        t["simple_ratio"] = t["ms"] / t["simple_ms"]
    err = max(errs.values())
    require(err <= KERNEL_TOL, f"spatial kernel disagrees: {errs}")
    nb = cfg.decode.beam_size
    out = {"phase": "kernel_spatial_core", "shape": [bc, k, r, s, dr],
           "max_abs_err": err, "errs": errs, "tol": KERNEL_TOL,
           "times": times, "library_ms": None, **times[f"nb{nb}"]}
    emit(out)
    torch.cuda.empty_cache()
    return out


def gates_operands(step_mod, rows, kx, dim, mode, dev, g):
    """(x, w, b, c, s_r, scale) of one gates+LSTM call, in the layouts
    the decode step stores (x in rows padded to 128 bytes, the stack as
    its padded K-major transpose; float32 dense); int8 operands are
    quantized with the step's own helpers, as the step does."""
    x = torch.randn(rows, kx, generator=g, device=dev)
    w = torch.randn(kx, 4 * dim, generator=g, device=dev) / kx ** 0.5
    b = 0.1 * torch.randn(4 * dim, generator=g, device=dev)
    c = torch.randn(rows, dim, generator=g, device=dev)
    if mode == "int8":
        x_q, s_r = step_mod.quantize_rows(x)
        w_q, scale = step_mod.quantize_weights(w)
        return x_q, w_q, b, c, s_r, scale
    if mode == "bf16":
        x, w = x.bfloat16(), w.bfloat16()
        if hasattr(step_mod, "kmajor"):   # a parent tree reads them dense
            x, w = step_mod.pad_cols(x), step_mod.kmajor([w], w.dtype)
        return x, w, b, c, None, None
    return x, w, b, c, None, None


def lstm_cell_operands(x, w, b, c, dw, dim):
    """``torch.lstm_cell``'s operands for the bf16 gates call (x, w, b,
    c): input [emb | ctx], hidden h, w_ih / w_hh from the [W; U; Wc]
    stack transposed, gates permuted from i, f, o, g to PyTorch's i, f,
    g, o; bias and cell state rounded to bf16 (the call takes one dtype)."""
    bf16 = torch.bfloat16
    perm = torch.cat([torch.arange(0, 2 * dim), torch.arange(3 * dim, 4 * dim),
                      torch.arange(2 * dim, 3 * dim)]).to(w.device)
    inp = torch.cat([x[:, :dw], x[:, dw + dim:]], dim=1).contiguous()
    h = x[:, dw:dw + dim].contiguous()
    w_ih = torch.cat([w[:dw], w[dw + dim:]], dim=0).t()[perm].contiguous()
    w_hh = w[dw:dw + dim].t()[perm].contiguous()
    return (inp, (h, c.to(bf16)), w_ih, w_hh, b[perm].to(bf16),
            torch.zeros_like(b, dtype=bf16))


def phase_gates(kernel, step_mod, dev, g, cfg, phase="kernel_gates_lstm"
                ) -> dict:
    """Kernel 3 at the path-B shapes (rows 1280, Kx 5120, 4 dim 14336;
    or a recipe's Kx 5010 / 6034, dim 3518) and at a ragged 185 rows,
    in float32, bf16 and int8 mode, on the step's layouts, each against
    the plain version on the same operands (the plain int8 path
    multiplies with torch._int_mm), each case with its route (bf16 and
    int8 must take wgmma).  Timed beside the plain version: the wmma route
    at the same shapes; in bf16 ``torch.lstm_cell`` (library_ms: the same
    function in one call, checked against the plain version), the product
    alone over Kx (product_ms) and over the depth the decode step pads it
    to (padded_product_ms; padded_plain_ms the plain version so); in int8,
    where no one call computes it, ``torch._int_mm`` of the product alone
    (product_ms)."""
    m = cfg.model
    rows = cfg.decode.decode_batch * cfg.decode.beam_size
    kx, dim = m.dim_word + m.dim + m.ctx_dim, m.dim
    cases, times = {}, {}
    for mode in ("f32", "bf16", "int8"):
        tol = INT8_TOL if mode == "int8" else KERNEL_TOL
        for n in (rows, 185):
            ops = gates_operands(step_mod, n, kx, dim, mode, dev, g)
            got, route = route_taken(kernel.gates_lstm,
                                     lambda: kernel.gates_lstm(*ops))
            ref = step_mod._gates_lstm(*ops)
            torch.cuda.synchronize()
            err = max_err(got, ref)
            name = f"{mode}_rows{n}"
            cases[name] = {"max_abs_err": err, "route": route}
            require(all(bool(torch.isfinite(t).all()) for t in got),
                    f"gates kernel {mode}: non-finite output")
            require(err <= tol, f"gates kernel {mode} rows {n}: {err}")
            want = "f32" if mode == "f32" else "wgmma"
            require(route == want, f"gates kernel {name} took {route}")
            if n != rows or mode == "f32":
                continue
            again = kernel.gates_lstm(*ops)
            torch.cuda.synchronize()
            same = all(torch.equal(p, q) for p, q in zip(got, again))
            require(same, f"gates kernel {mode} is not deterministic")
            cases[name]["bitwise_repeatable"] = same
            # the wmma route reads dense x and the (Kx, 4 dim) stack
            # row-major
            old = (ops[0].contiguous(), ops[1].contiguous(), *ops[2:])
            t = {"ms": time_ms(lambda: kernel.gates_lstm(*ops), 20),
                 "wmma_ms": time_ms(lambda: kernel._gates_lstm_cuda(
                     *old, route="wmma"), 20),
                 "plain_ms": time_ms(lambda: step_mod._gates_lstm(*ops), 20)}
            if mode == "bf16":
                lc = lstm_cell_operands(*ops[:4], m.dim_word, dim)
                lib_out = torch.lstm_cell(*lc)
                t["library_rel_err"] = rel_err(lib_out, ref)
                require(t["library_rel_err"] <= TRAIN_BF16_TOL,
                        f"torch.lstm_cell is not the gates function: "
                        f"{t['library_rel_err']}")
                t["library_ms"] = time_ms(lambda: torch.lstm_cell(*lc), 20)
                t["product_ms"] = time_ms(
                    lambda: torch.mm(ops[0], ops[1], out_dtype=torch.float32),
                    20)
                # the same product over the depth padded to 128 bytes,
                # zero columns of x and rows of the K-major stack, as the
                # decode step takes it (a ragged Kx leaves cuBLAS on sm80)
                kp = -(-kx // 64) * 64
                xw = torch.nn.functional.pad(ops[0], (0, kp - kx))
                ww = torch.nn.functional.pad(ops[1].t(), (0, kp - kx)).t()
                t["padded_depth"] = kp
                t["padded_product_ms"] = time_ms(
                    lambda: torch.mm(xw, ww, out_dtype=torch.float32), 20)
                if hasattr(step_mod, "padded_buffer"):  # not a parent's
                    wide = lambda: step_mod._gates_lstm(   # noqa: E731
                        *ops, padded_ops=(xw, ww))
                    t["padded_plain_err"] = max_err(wide(), ref)
                    require(t["padded_plain_err"] <= KERNEL_TOL,
                            "plain gates over the padded depth: "
                            f"{t['padded_plain_err']}")
                    t["padded_plain_ms"] = time_ms(wide, 20)
                del lc, lib_out, xw, ww
            else:
                t["library_ms"] = None
                t["product_ms"] = time_ms(
                    lambda: step_mod._int8_mm(ops[0], ops[1]), 20)
            times[mode] = t
            del old, again
    # int8 mode: in x_q, W_q, bias, scale, s_r, c; out h, c.  bf16 mode:
    # in x, W (bf16), bias, c; out h, c
    times["int8"].update(bound(
        rows * kx + kx * 4 * dim + 2 * 4 * 4 * dim + 4 * rows
        + 3 * 4 * rows * dim, 2 * rows * kx * 4 * dim, "int8"))
    times["bf16"].update(bound(
        2 * rows * kx + 2 * kx * 4 * dim + 4 * 4 * dim + 3 * 4 * rows * dim,
        2 * rows * kx * 4 * dim, "bf16"))
    for t in times.values():
        t["bound_share"] = t["bound_ms"] / t["ms"]
        t["wmma_ratio"] = t["ms"] / t["wmma_ms"]
        t["product_ratio"] = t["ms"] / t["product_ms"]
        if t["library_ms"] is not None:
            t["library_ratio"] = t["ms"] / t["library_ms"]
    out = {"phase": phase, "shape": [rows, kx, 4 * dim],
           # of x and of the stack's K-major transpose, in elements
           "row_strides": {m_: step_mod.padded(1, kx, dt, "meta").stride(0)
                           for m_, dt in (("bf16", torch.bfloat16),
                                          ("int8", torch.int8))},
           "max_abs_err": cases["int8_rows%d" % rows]["max_abs_err"],
           "cases": cases, "route": cases["int8_rows%d" % rows]["route"],
           "tol": {"f32": KERNEL_TOL, "bf16": KERNEL_TOL, "int8": INT8_TOL},
           "times": times, **times["int8"]}
    emit(out)
    torch.cuda.empty_cache()
    return out


def request(rng, n, model_cfg):
    """n videos of random features with frame counts around K."""
    k = model_cfg.n_frames
    return [rng.randn(int(f), model_cfg.ctx_dim).astype(np.float32)
            for f in rng.randint(max(1, k - 8), k + 9, size=n)]


def regions_for(feats, model_cfg, seed):
    """Random (F_i, R, Dr) region features matching each video's frames
    (1.4 GB of float32 for 256 videos: drawn with numpy's fast
    generator)."""
    if not model_cfg.use_spatial:
        return None
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((f.shape[0], model_cfg.n_regions,
                                 model_cfg.region_dim), dtype=np.float32)
            for f in feats]


def motion_for(feats, model_cfg, seed):
    """Random (F_i, Dm) motion features matching each video's frames, for
    the dual-stream model (preset 4)."""
    if not model_cfg.use_motion:
        return None
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((f.shape[0], model_cfg.motion_dim),
                                dtype=np.float32) for f in feats]


def streams(feats, model_cfg, seed):
    """The (regions, motion) arrays a request of ``feats`` carries."""
    return (regions_for(feats, model_cfg, seed),
            motion_for(feats, model_cfg, seed + 7))


def count_replays() -> None:
    """Credit the decode steps that a ``Captioner``'s CUDA graphs replay
    to the counter of the ``counted_step`` they were captured from (a
    replay calls no step function): ``beam._replay`` is wrapped once (a
    tree without graphs has none)."""
    from stvd_torch.decode import beam
    real = getattr(beam, "_replay", None)
    if real is None or getattr(real, "counts_replays", False):
        return

    def replay(graphs, chain, *args):
        before = graphs.replayed
        out = real(graphs, chain, *args)
        counter = getattr(graphs.step_fn, "counter", None)
        if counter is not None:
            counter[0] += graphs.replayed - before
        return out

    replay.counts_replays = True
    beam._replay = replay


def counted_step(inner, counter):
    """``inner`` counting its decode steps in ``counter[0]``: its calls,
    but not those made while a CUDA graph is captured (they launch
    nothing), and the steps that graphs captured from it replay."""
    count_replays()

    def step_fn(*args):
        if not torch.cuda.is_current_stream_capturing():
            counter[0] += 1
        return inner(*args)
    step_fn.make_logit_tail = inner.make_logit_tail
    step_fn.counter = counter
    return step_fn


def phase_serving(api, kernel, dev, seed, params, vocab, cfg, phase,
                  expect, modes=("natural_eos", "eos_suppressed"),
                  routes=None) -> dict:
    """Beam requests of 1, 37 and decode_batch (256) videos, with natural
    EOS and/or with EOS suppressed (every caption runs all maxlen steps).
    The launches of every kernel are counted from zero over the run:
    those in ``expect`` must equal the decode steps, the others 0, and
    each of ``routes`` (kernel -> route) all on that route."""
    cap = api.Captioner(params, cfg, vocab, device=dev)
    require(cap.step_fn is kernel.step_kernels,
            "Captioner did not pick the kernel step on the GPU")
    steps = [0]
    cap.step_fn = counted_step(cap.step_fn, steps)
    rng = np.random.RandomState(seed)
    reqs = {}
    for n in (1, 37, cfg.decode.decode_batch):
        feats = request(rng, n, cfg.model)
        reqs[n] = (feats, *streams(feats, cfg.model, seed + n))
    cap.caption(*reqs[1])                         # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()

    reset_launches(kernel)
    steps[0] = 0
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    eos_bias = cap.params["ff_logit_b"][0].clone()
    for mode in modes:
        if mode == "eos_suppressed":
            cap.params["ff_logit_b"][0] = -1e9
        for n, (feats, regs, mots) in reqs.items():
            s0 = steps[0]
            t0 = time.perf_counter()
            caps = cap.caption(feats, regs, mots)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            require(len(caps) == n, "wrong number of captions")
            words = [c.split() for c in caps]
            require(all(set(ws) <= vocab.word_to_id.keys() for ws in words),
                    "caption holds a word outside the vocabulary")
            if mode == "eos_suppressed":
                require(all(len(ws) == cfg.decode.maxlen for ws in words),
                        "with EOS suppressed every caption runs to maxlen")
            runs[f"{mode}_{n}"] = {
                "videos": n, "seconds": dt, "captions_per_s": n / dt,
                "decode_steps": steps[0] - s0,
                "mean_words": float(np.mean([len(ws) for ws in words]))}
    cap.params["ff_logit_b"][0] = eos_bias
    launches = read_launches(kernel)
    want = {k: (steps[0] if k in expect else 0) for k in KERNELS}
    require(steps[0] > 0 and launches == want,
            f"{phase}: kernel launches {launches} != {want}")
    by_route = read_routes(kernel)
    for name, route in (routes or {}).items():
        require(by_route[name][route] == want[name],
                f"{phase}: {name} launches by route {by_route[name]}, "
                f"want all {want[name]} on {route}")
    out = {"phase": phase,
           "config": {"use_spatial": cfg.model.use_spatial,
                      "use_motion": cfg.model.use_motion,
                      "encoder": cfg.model.encoder,
                      "ctx_dim": cfg.model.ctx_dim,
                      "n_words": cfg.model.n_words,
                      "decode_quant": cfg.model.decode_quant,
                      "gates_kernel": cfg.model.gates_kernel},
           "runs": runs, "decode_steps": steps[0], "launches": launches,
           "launches_by_route": by_route,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit(out)
    return out


# the route every launch inside an exported graph must take
AOT_ROUTES = {"attention_core": "cluster", "logit_tail": "wgmma",
              "gates_lstm": "wgmma", "spatial_core": "tma"}


def aot_counted(kernel, fn, engaged, chunks, maxlen, what):
    """``fn()`` with every kernel's launches counted from zero: each of
    ``engaged`` must launch maxlen times a decode chunk, all on its
    ``AOT_ROUTES`` route, and the others not at all.  Returns fn's
    result and the launches."""
    reset_launches(kernel)
    out = fn()
    torch.cuda.synchronize()
    launches = read_launches(kernel)
    want = {k: (chunks * maxlen if k in engaged else 0) for k in KERNELS}
    require(launches == want, f"{what}: launches {launches} != {want}")
    by_route = read_routes(kernel)
    for k in engaged:
        require(by_route[k][AOT_ROUTES[k]] == want[k],
                f"{what}: {k} launches by route {by_route[k]}, want all "
                f"{want[k]} on {AOT_ROUTES[k]}")
    return out, launches


def dir_bytes(path) -> dict:
    return {f: os.path.getsize(os.path.join(path, f))
            for f in sorted(os.listdir(path))}


def ab_seconds(fns: dict, reps: int = 7) -> dict:
    """Wall seconds of each of ``fns`` (synced), the calls interleaved
    rep by rep so that drift of the host hits every one alike: {name:
    (median, min, max)}."""
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[k].append(time.perf_counter() - t0)
    return {k: (float(np.median(v)), min(v), max(v))
            for k, v in times.items()}


def eos_weights(params, mode: str) -> dict:
    """The weights of a throughput mode: as they are (``natural_eos``:
    random weights seldom emit EOS, so captions run all 30 steps), EOS
    suppressed, or EOS favoured after any word (``eos_after_one_word``,
    so the live loop exits after about two steps while a graph runs all
    30): the zero embedding of step 0 leaves activation 0 near -1,
    every word's embedding lifts it to near 0, and only EOS reads it."""
    if mode == "natural_eos":
        return params
    p = dict(params)
    b = p["ff_logit_b"].clone()
    if mode == "eos_suppressed":
        b[0] = -1e9
        return dict(p, ff_logit_b=b)
    emb, lstm_b, w = (p[k].clone() for k in ("Wemb", "ff_logit_lstm_b",
                                             "ff_logit_W"))
    emb[:, 0] = 3.0
    lstm_b[0] = -3.0
    w[0, :] = 0.0
    w[0, 0] = 10.0
    b[0] = 2.5
    return dict(p, Wemb=emb, ff_logit_lstm_b=lstm_b, ff_logit_W=w,
                ff_logit_b=b)


def op_dispatch_us(kernel, dev, cfg) -> dict:
    """Host microseconds a call of kernels 1 and 2 at the preset-3
    serving shapes, through the wrapper's direct launch and through the
    custom op an exported graph calls (the dispatcher's cost)."""
    g = torch.Generator(device=dev).manual_seed(3)
    m = cfg.model
    bc, nb, k, a, dc = (cfg.decode.decode_batch, cfg.decode.beam_size,
                        m.n_frames, m.attn_dim, m.ctx_dim)
    hp = torch.randn(bc * nb, a + 1, generator=g, device=dev)
    attn = (hp[:, :a], hp[:, a],
            0.5 * torch.randn(bc, k, a, generator=g, device=dev),
            torch.randn(bc, k, dc, generator=g, device=dev).bfloat16(),
            torch.ones(bc, k, device=dev),
            torch.randn(a, generator=g, device=dev) / a ** 0.5,
            torch.tensor(0.1, device=dev), torch.tensor(-0.2, device=dev),
            True)
    tail = (torch.randn(bc * nb, m.dim_word, generator=g,
                        device=dev).bfloat16(),
            torch.randn(m.dim_word, m.n_words, generator=g,
                        device=dev).bfloat16(),
            torch.randn(m.n_words, generator=g, device=dev),
            cfg.decode.beam_size)
    ops = torch.ops.stvd_torch
    return {
        "attention_core_direct_us": host_us(
            lambda: kernel._attention_core_cuda(*attn)),
        "attention_core_op_us": host_us(lambda: ops.attention_core(*attn)),
        "logit_tail_direct_us": host_us(
            lambda: kernel._logit_tail_cuda(*tail)),
        "logit_tail_op_us": host_us(lambda: ops.logit_tail(*tail))}


def aot_export_check(api, kernel, dev, seed, params, vocab, cfg, root,
                     phase, engaged) -> dict:
    """One export of ``cfg`` at its decode batch held to the live
    ``Captioner``: a decode batch of videos (natural EOS) through the
    loaded graph, every caption equal, the engaged kernels maxlen
    launches each on their fast routes."""
    from stvd_torch.export_aot import load_artifact, save_artifact
    out = os.path.join(root, phase)
    b = cfg.decode.decode_batch
    manifest = save_artifact(out, params, cfg, vocab)
    t0 = time.perf_counter()
    served = load_artifact(out, device=dev)
    load_s = time.perf_counter() - t0
    feats = request(np.random.RandomState(seed + 3), b, cfg.model)
    regs, mots = streams(feats, cfg.model, seed + 3)
    got, launches = aot_counted(
        kernel, lambda: served.caption(feats, regs, mots), engaged, 1,
        cfg.decode.maxlen, phase)
    want = api.Captioner(params, cfg, vocab, device=dev).caption(
        feats, regs, mots)
    diff = [i for i, (x, y) in enumerate(zip(got, want)) if x != y]
    require(not diff, f"{phase}: artifact != live for videos {diff[:8]}")
    res = {"phase": phase, "videos": b, "equal": len(got),
           "custom_ops": manifest["custom_ops"],
           "export_seconds": manifest["export_seconds"],
           "load_seconds": load_s, "bytes": dir_bytes(out),
           "launches": launches}
    emit(res)
    return res


def phase_aot(api, kernel, dev, seed, params, vocab, cfg, cfg_q, root
              ) -> dict:
    """The AOT serving path at preset 3 (the serving phase's weights):
    ``save_artifact`` of the b=1 and b=256 decode and n-best graphs,
    ``cli.export --check`` in a subprocess (run beside that export, done
    before any timing), 257 videos through the loaded
    graphs against the live ``Captioner`` (every caption equal; kernels 1
    and 2 30 launches a chunk from inside the graph, on cluster / wgmma),
    n-best entry 0 against ``caption``, worst-case (EOS suppressed) and
    natural-EOS captions/s and one-video latency of artifact and live,
    ``cli.serve --artifact`` over HTTP with the bank resident; then path
    B (int8 gates kernel) as one export at batch 256."""
    import argparse
    import threading
    from stvd_torch import export_aot
    from stvd_torch.cli import serve
    from stvd_torch.data.bank import pack_bank
    maxlen = cfg.decode.maxlen
    engaged = ("attention_core", "logit_tail")
    # cli.export --check in its own process, on a run dir of the weights,
    # started first: its export runs beside this process's (each traces
    # on one core) and its check's decodes end before the timing below
    run = os.path.join(root, "run")
    os.makedirs(run)
    with open(os.path.join(run, "config.json"), "w") as f:
        f.write(cfg.to_json())
    vocab.save_pickle(os.path.join(run, "vocab.pkl"))
    torch.save({"params": {k: v.detach().cpu() for k, v in params.items()}},
               os.path.join(run, "ckpt.pt"))
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.abspath(export_aot.__file__)))
    env = dict(os.environ, PYTHONPATH=pkg_root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cli, t_cli = {}, time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "stvd_torch.cli.export", "--run-dir", run,
         "--out", os.path.join(root, "cli"), "--check"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)

    def reap():
        try:
            cli["out"], cli["err"] = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            cli["out"], cli["err"] = proc.communicate()
        cli["seconds"] = time.perf_counter() - t_cli

    reaper = threading.Thread(target=reap, daemon=True)
    reaper.start()
    out = os.path.join(root, "preset3")
    torch.cuda.reset_peak_memory_stats()
    manifest = export_aot.save_artifact(out, params, cfg, vocab,
                                        batch_sizes=(1, 256), nbest=True)
    # the subprocess's decodes must not overlap the timing below
    reaper.join(timeout=600)
    require(manifest["custom_ops"] == ["stvd_torch::attention_core",
                                       "stvd_torch::logit_tail"],
            f"aot: graph ops {manifest['custom_ops']}")
    t0 = time.perf_counter()
    served = export_aot.load_artifact(out, device=dev)
    load_s = time.perf_counter() - t0
    res = {"phase": "aot", "export_seconds": manifest["export_seconds"],
           "bytes": dir_bytes(out), "load_seconds": load_s}
    live = api.Captioner(params, cfg, vocab, device=dev)
    rng = np.random.RandomState(seed + 5)
    feats = request(rng, 257, cfg.model)
    t0 = time.perf_counter()
    first = served.caption(feats[:1])
    torch.cuda.synchronize()
    res["first_call_b1_seconds"] = time.perf_counter() - t0
    got, res["launches"] = aot_counted(
        kernel, lambda: served.caption(feats), engaged, 2, maxlen,
        "aot 257 videos")
    want = live.caption(feats)
    diff = [i for i, (x, y) in enumerate(zip(got, want)) if x != y]
    require(not diff, f"aot: artifact != live for videos {diff[:8]}")
    require(first == got[:1], "aot: b=1 graph != the b=256 chunk")
    res["videos_equal"] = len(got)
    nb = served.nbest(feats[:16])
    require([v[0][0] for v in nb] == got[:16],
            "aot: n-best entry 0 != caption")

    # throughput and latency; weights are call-time inputs, so EOS is
    # suppressed in the artifact's weights as in the live Captioner's
    batch = feats[:256]
    for mode in ("natural_eos", "eos_suppressed", "eos_after_one_word"):
        w = eos_weights(params, mode)
        for c in (served, live):
            c.swap_params(w)
        secs = ab_seconds({"aot": lambda: served.caption(batch),
                           "live": lambda: live.caption(batch)})
        for name, (med, lo, hi) in secs.items():
            res[f"{name}_{mode}_captions_per_s"] = 256 / med
            res[f"{name}_{mode}_seconds_min_max"] = [lo, hi]
        words = [len(c.split()) for c in served.caption(batch)]
        require(words == [len(c.split()) for c in live.caption(batch)],
                f"aot: {mode} caption lengths differ from live")
        res[f"{mode}_mean_words"] = float(np.mean(words))
    for c in (served, live):
        c.swap_params(params)
    secs = ab_seconds({"aot_b1": lambda: served.caption(feats[:1]),
                       "live_b256_chunk": lambda: live.caption(feats[:1])})
    for name, (med, lo, hi) in secs.items():
        res[f"{name}_1_video_seconds"] = med
        res[f"{name}_1_video_seconds_min_max"] = [lo, hi]
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["op_dispatch"] = op_dispatch_us(kernel, dev, cfg)

    # the cli.export --check started above
    res["cli_export_seconds"] = cli.get("seconds")
    check = [ln for ln in cli.get("out", "").splitlines()
             if ln.startswith("check:")]
    require(proc.returncode == 0 and check and "OK" in check[0],
            f"aot: cli.export --check rc {proc.returncode}: "
            f"{cli.get('out', '')[-500:]} {cli.get('err', '')[-1500:]}")
    res["cli_export_check"] = check[0]
    res["cli_export_load_seconds"] = float(
        re.search(r"load ([0-9.e+-]+) s", check[0]).group(1))

    # cli.serve --artifact over HTTP, the bank resident
    bank = pack_bank({f"v{i:03d}": f for i, f in enumerate(batch)},
                     cfg.model.n_frames)
    bank_path = os.path.join(root, "bank.npz")
    bank.save(bank_path)
    arr = bank.frames
    videos = [bank.frames[i][bank.frame_mask[i] > 0]
              for i in range(len(bank.ids))]
    new = {k: v.detach().float().cpu().numpy() for k, v in params.items()}
    new["ff_logit_b"] = new["ff_logit_b"] + 2.0 * np.random.RandomState(
        seed).randn(*new["ff_logit_b"].shape).astype(np.float32)
    swap_path = os.path.join(root, "swap.npz")
    np.savez(swap_path, **new)
    args = argparse.Namespace(
        artifact=out, run_dir=None, bank=bank_path, bank_shards=0,
        params=None, quant=None, device=str(dev), host="127.0.0.1",
        port=0, no_warmup=False, coalesce_wait_ms=0.0, allow_swap=True,
        allow_shutdown=False, verbose=False)
    server, build_s = quiet(serve.build_server, args)
    require(server.mode == "aot", "aot serve: mode")
    srv = {"build_server_s": build_s, "warmup_s": server.warmup()}
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = "127.0.0.1", server.server_port
    try:
        t0 = time.perf_counter()
        caps = serve.request_captions(host, port, arr, timeout=300.0)
        srv["caption_256_s"] = time.perf_counter() - t0
        require(caps == live.caption(arr), "aot serve: /caption != live")
        by_id, srv["caption_ids_launches"] = aot_counted(
            kernel, lambda: serve.request_caption_ids(host, port, bank.ids,
                                                      timeout=300.0),
            engaged, 1, maxlen, "aot serve /caption_ids")
        require(by_id == live.caption(videos),
                "aot serve: /caption_ids != live")
        nbs = serve.request_nbest(host, port, arr[:16], timeout=300.0)
        require([v[0][0] for v in nbs] == caps[:16],
                "aot serve: /nbest entry 0 != /caption")
        require([[t for t, _ in v] for v in nbs]
                == [[t for t, _ in v] for v in live.nbest(arr[:16])],
                "aot serve: /nbest != live n-best")
        import http.client
        conn = http.client.HTTPConnection(host, port, timeout=300)
        conn.request("POST", "/swap_params",
                     body=json.dumps({"path": swap_path}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        st, body = resp.status, json.loads(resp.read())
        conn.close()
        require(st == 200 and body["status"] == "swapped",
                f"aot serve: /swap_params {st} {body}")
        swapped = serve.request_captions(host, port, arr[:32],
                                         timeout=300.0)
        fresh = api.Captioner(new, cfg, vocab, device=dev)
        require(swapped == fresh.caption(arr[:32]),
                "aot serve: after the swap != a fresh Captioner")
        require(swapped != caps[:32], "aot serve: the swap changed nothing")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    res["serve"] = srv
    emit(res)
    del served, server, live
    torch.cuda.empty_cache()
    res["path_b"] = aot_export_check(
        api, kernel, dev, seed, params, vocab, cfg_q, root, "aot_int8_gates",
        ("attention_core", "gates_lstm", "logit_tail"))
    torch.cuda.empty_cache()
    return res


def simple_attention_step(kernel, step_mod):
    """The kernel step with the attention core on route 'simple' (the
    first design), for a witness on the same weights and videos."""
    def step_fn(params, cfg, state, sc, emb_t):
        return step_mod.step_with_core(
            params, cfg, state, sc, emb_t,
            attention_core=lambda *a: kernel._attention_core_cuda(
                *a, route="simple"),
            spatial_core=kernel.spatial_core,
            gates_core=kernel._gates_core(cfg))
    step_fn.make_logit_tail = kernel.make_logit_tail
    return step_fn


def plain_spatial_step(kernel, step_mod):
    """The kernel step with the spatial core's plain version, which
    rounds its scores and its weighted sum to the compute dtype as the
    JAX einsums do, where kernel 4 sums in float32: the witness that
    separates that rounding from the other kernels under bf16."""
    def step_fn(params, cfg, state, sc, emb_t):
        return step_mod.step_with_core(
            params, cfg, state, sc, emb_t,
            attention_core=kernel.attention_core,
            spatial_core=step_mod._spatial_core,
            gates_core=kernel._gates_core(cfg))
    step_fn.make_logit_tail = kernel.make_logit_tail
    return step_fn


def decode_all(api, dev, seed, params, vocab, cfg, runs):
    """Captions of one decode batch of videos (made from ``seed``)
    through each of ``runs`` ((name, step_fn, cfg) triples), and the
    seconds each took."""
    feats = request(np.random.RandomState(seed + 1),
                    cfg.decode.decode_batch, cfg.model)
    regs, mots = streams(feats, cfg.model, seed + 1)
    caps, secs = {}, {}
    for name, fn, c in runs:
        t0 = time.perf_counter()
        caps[name] = api.Captioner(params, c, vocab, step_fn=fn,
                                   device=dev).caption(feats, regs, mots)
        secs[name + "_seconds"] = time.perf_counter() - t0
    return caps, secs


def share(caps, a, b) -> float:
    """The share of videos whose captions agree between runs a and b."""
    return float(np.mean([x == y for x, y in zip(caps[a], caps[b])]))


def phase_kernel_vs_plain(api, kernel, step_mod, dev, seed, params, vocab,
                          cfg, phase, plain_cfg=None) -> None:
    """The full decode of one decode batch of videos through the kernel
    step and through the plain step on the same config.  Both sum in
    different orders, so a near-tie can flip a beam: the bar is a share of
    videos (0.95).  With ``plain_cfg`` (the int8 gates) that bar holds the
    kernel step against the kernel step under ``plain_cfg`` (every kernel
    but the one under test), and the share against the plain step must
    reach INT8_PLAIN_SHARE: int8 rounding of the activations turns the
    other kernels' ~1e-6 differences from plain into whole quanta, so
    near-ties of random weights flip more beams there.  Beside it, as a
    witness on the same weights and videos, the share of the step with
    the attention core's first design (route 'simple') against plain.
    Under spatial attention the bar against the plain step holds the
    kernel step with the plain spatial core (``plain_spatial_step``):
    kernel 4 sums in float32 where the plain core rounds to bf16, a
    difference int8 rounding turns into flipped beams; the share of the
    whole kernel step is reported beside it."""
    spatial = plain_cfg is not None and cfg.model.use_spatial
    runs = [("kernels", kernel.step_kernels, cfg),
            ("plain", step_mod.step, cfg)]
    if plain_cfg is not None:
        runs += [("reference", kernel.step_kernels, plain_cfg),
                 ("simple_attention", simple_attention_step(kernel, step_mod),
                  cfg)]
    if spatial:
        runs.append(("plain_spatial_core",
                     plain_spatial_step(kernel, step_mod), cfg))
    caps, secs = decode_all(api, dev, seed, params, vocab, cfg, runs)
    same = share(caps, "kernels", "plain" if plain_cfg is None
                 else "reference")
    extra = {} if plain_cfg is None else {
        "share_vs_plain": share(caps, "kernels", "plain"),
        "share_vs_plain_bar": INT8_PLAIN_SHARE,
        "simple_attention_share_vs_plain": share(caps, "simple_attention",
                                                 "plain")}
    if spatial:
        extra["plain_spatial_core_share_vs_plain"] = share(
            caps, "plain_spatial_core", "plain")
    held = extra.get("plain_spatial_core_share_vs_plain",
                     extra.get("share_vs_plain"))
    emit({"phase": phase, "videos": len(caps["kernels"]),
          "decode_batch": cfg.decode.decode_batch,
          "compute_dtype": cfg.model.compute_dtype,
          "decode_quant": cfg.model.decode_quant,
          "token_match_share": same, "bar": 0.95, **extra, **secs})
    require(same >= 0.95, f"{phase}: kernel and plain paths agree on "
                          f"{same:.3f}")
    require(plain_cfg is None or held >= INT8_PLAIN_SHARE,
            f"{phase}: kernel and all-plain paths agree on {extra}")
    torch.cuda.empty_cache()


def phase_profile(api, dev, params, vocab, seed, cfg, phase) -> None:
    """Device time by kernel over one worst-case decode of decode_batch
    videos."""
    from torch.profiler import ProfilerActivity, profile
    cap = api.Captioner(params, cfg, vocab, device=dev)
    eos_bias = cap.params["ff_logit_b"][0].clone()
    cap.params["ff_logit_b"][0] = -1e9
    feats = request(np.random.RandomState(seed + 2),
                    cfg.decode.decode_batch, cfg.model)
    regs, mots = streams(feats, cfg.model, seed + 2)
    cap.caption(feats, regs, mots)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cap.caption(feats, regs, mots)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cap.params["ff_logit_b"][0] = eos_bias
    # device-side activities only (kernels, copies): the host ops that
    # launched them carry the same time again; one stream, so no overlap
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and not ev.key.startswith("Activity Buffer")),
                  reverse=True)
    total = sum(r[0] for r in rows)
    emit({"phase": phase, "wall_s": wall, "device_s": total / 1e6,
          "idle_share": 1.0 - total / 1e6 / wall if wall else None,
          "top": [{"name": k[:80], "ms": us / 1e3, "count": c}
                  for us, k, c in rows[:20]]})


def phase_spatial_bwd(kernel, dev, g, cfg, batch) -> dict:
    """Kernel 5 at the preset-2 training shapes (B 64, K 28, R 49,
    s = Dr = 1024): float32 operands with a float32 accumulator, and bf16
    operands with a bf16 (the default) and a float32 accumulator, each
    against the plain version on the same inputs, the accumulator
    updated in place by both; each case reports its load route, its share
    of the bound and whether two calls from the same Dpe agree bit for
    bit (they must)."""
    m = cfg.model
    b, k, r, s, dr = batch, m.n_frames, m.n_regions, m.region_dim, \
        m.region_dim
    off = 4 * m.dim + m.attn_dim + 1
    f32, bf16 = torch.float32, torch.bfloat16
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    hp = rnd(b, off + s)
    pregion = 0.5 * rnd(b, k, r, s)
    regions = rnd(b, k, r, dr)
    alpha_s = torch.softmax(rnd(b, k, r), -1)
    alpha_prev = torch.softmax(rnd(b, k, r), -1)
    dspat, u_s = rnd(b, k, dr), 3.0 * rnd(s) / s ** 0.5
    dpe0 = 0.01 * rnd(b, k, r, s)
    cases, times = {}, {}
    for cd, acc in ((f32, f32), (bf16, f32), (bf16, bf16)):
        name = f"{str(cd)[6:]}_acc_{str(acc)[6:]}"
        args = (hp[:, off:], pregion.to(cd), regions.to(cd), alpha_s,
                alpha_prev, dspat, u_s)
        dpe_k, dpe_p = dpe0.to(acc, copy=True), dpe0.to(acc, copy=True)
        dpe_2 = dpe0.to(acc, copy=True)
        out_k, route = route_taken(kernel.spatial_bwd,
                                   lambda: kernel.spatial_bwd(*args, dpe_k))
        got = (dpe_k, *out_k)
        again = (dpe_2, *kernel.spatial_bwd(*args, dpe_2))
        ref = (dpe_p, *kernel._spatial_bwd_plain(*args, dpe_p))
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        require(same, f"spatial backward kernel {name} is not deterministic")
        del again, dpe_2
        require(all(bool(torch.isfinite(t).all()) for t in got),
                f"spatial backward kernel {name}: non-finite output")
        tol = KERNEL_TOL if cd == f32 else TRAIN_BF16_TOL
        cases[name] = {"max_abs_err": max_err(got, ref),
                       "rel_err": rel_err(got, ref), "tol_rel": tol,
                       "route": route, "bitwise_repeatable": same}
        require(cases[name]["rel_err"] <= tol,
                f"spatial backward kernel {name} disagrees: {cases[name]}")
        del got, ref
        times[name] = {
            "ms": time_ms(lambda: kernel.spatial_bwd(*args, dpe_k), 20),
            "plain_ms": time_ms(
                lambda: kernel._spatial_bwd_plain(*args, dpe_p), 5)}
        # in: h_satt, pregion, regions, alpha_s, alpha_prev, dspat, u_s,
        # Dpe; out: Dpe, dh_satt, du_s, dss, spat_prev
        cd_b, acc_b = torch.finfo(cd).bits // 8, torch.finfo(acc).bits // 8
        traffic = (4 * b * s + b * k * r * (s + dr) * cd_b
                   + 4 * (2 * b * k * r + b * k * dr + s)
                   + 2 * b * k * r * s * acc_b
                   + 4 * (b * s + s + b * k * r) + b * k * dr * cd_b)
        times[name].update(bound(traffic, b * k * r * (9 * s + 4 * dr),
                                 "f32"))
        times[name]["bound_share"] = (times[name]["bound_ms"]
                                      / times[name]["ms"])
        torch.cuda.empty_cache()
    main = "bfloat16_acc_bfloat16"
    out = {"phase": "kernel_spatial_bwd", "shape": [b, k, r, s, dr],
           "max_abs_err": cases[main]["max_abs_err"], "cases": cases,
           "route": cases[main]["route"], "times": times,
           "library_ms": None, **times[main]}
    emit(out)
    return out


def host_us(fn, calls: int = 200) -> float:
    """The host's microseconds a call of ``fn`` called back to back (its
    clock read before the card has finished)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return out


def phase_train_tail(kernel, dev, g, cfg, batch,
                     phase="kernel_train_tail") -> dict:
    """Kernel 6 at the training shapes (rows 64, dc 1024, 4 dim 14336)
    and a ragged 37 rows, bf16 and float32 Wc; x_pre is one step of the
    time-major view and h_gates a column view of the h-projection, as
    in the scan.  Each case reports its route (bf16 must take wgmma) and
    agrees with the plain version within KERNEL_TOL; the wgmma route
    repeats bit for bit.  At rows 64: ms by CUDA events, device_ms by
    CUDA graph (L2 warm: Wc stays in L2 between calls) and
    cold_device_ms (L2 flushed before each call), the same for the wmma
    route on the same operands (wmma_*), the wrapper's host microseconds
    a call,
    and, since no one PyTorch call computes the whole function, the
    product alone, ``torch.mm(ctx_t, Wc, out_dtype=float32)``
    (product_ms)."""
    m = cfg.model
    dc, dim = m.ctx_dim, m.dim
    f32, bf16 = torch.float32, torch.bfloat16
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    wc32 = rnd(dc, 4 * dim) / dc ** 0.5
    cases, times = {}, {}
    for cd in (bf16, f32):
        wc = wc32.to(cd)
        for rows in (batch, 37):
            x_pre = rnd(rows, 3, 4 * dim).transpose(0, 1)[1]
            hp = rnd(rows, 4 * dim + m.attn_dim + 1)
            ctx_t, c = rnd(rows, dc), rnd(rows, dim)
            args = (ctx_t, x_pre, hp[:, :4 * dim], c, wc, cd)
            got, route = route_taken(kernel.train_tail,
                                     lambda: kernel.train_tail(*args))
            ref = kernel._train_tail_plain(*args)
            torch.cuda.synchronize()
            name = f"{str(cd)[6:]}_rows{rows}"
            cases[name] = {"max_abs_err": max_err(got, ref),
                           "rel_err": rel_err(got, ref), "route": route}
            require(all(bool(torch.isfinite(t).all()) for t in got),
                    f"train tail kernel {name}: non-finite output")
            require(cases[name]["max_abs_err"] <= KERNEL_TOL,
                    f"train tail kernel {name} disagrees: {cases[name]}")
            want = "wgmma" if cd == bf16 else "f32"
            require(route == want, f"train tail kernel {name} took {route}")
            if cd == bf16:
                same = repeats(kernel.train_tail, args)
                require(same, f"train tail kernel {name} is not "
                              f"deterministic")
                cases[name]["bitwise_repeatable"] = same
            if rows != batch:
                continue
            call = lambda: kernel.train_tail(*args)
            t = {"ms": time_ms(call), "device_ms": device_ms(call),
                 "cold_device_ms": cold_device_ms(call),
                 "host_us": host_us(call),
                 "plain_ms": time_ms(
                     lambda: kernel._train_tail_plain(*args)),
                 "library_ms": None,
                 # in: ctx_t, Wc, x_pre, h_gates, c; out: h, c, preact
                 **bound(nbytes(ctx_t.to(cd), wc)
                         + 4 * rows * (3 * 4 * dim + 3 * dim),
                         2 * rows * dc * 4 * dim,
                         "bf16" if cd == bf16 else "f32")}
            if cd == bf16:
                old = lambda: kernel._train_tail_cuda(*args, route="wmma")
                xb = ctx_t.to(bf16)
                prod = lambda: torch.mm(xb, wc, out_dtype=f32)
                t.update(wmma_ms=time_ms(old), wmma_device_ms=device_ms(old),
                         wmma_cold_device_ms=cold_device_ms(old),
                         wmma_host_us=host_us(old), product_ms=time_ms(prod),
                         product_device_ms=device_ms(prod),
                         product_cold_device_ms=cold_device_ms(prod))
                t["wmma_ratio"] = t["device_ms"] / t["wmma_device_ms"]
                t["product_ratio"] = t["device_ms"] / t["product_device_ms"]
            t["bound_share"] = t["bound_ms"] / t["ms"]
            t["bound_share_device"] = t["bound_ms"] / t["device_ms"]
            times[str(cd)[6:]] = t
    out = {"phase": phase, "shape": [batch, dc, 4 * dim],
           "max_abs_err": cases[f"bfloat16_rows{batch}"]["max_abs_err"],
           "cases": cases, "route": cases[f"bfloat16_rows{batch}"]["route"],
           "tol": KERNEL_TOL, "times": times, **times["bfloat16"]}
    emit(out)
    return out


def phase_dws(kernel, dev, g, cfg, batch, dr=None, phase="kernel_dws"
              ) -> dict:
    """Kernel 7, dWs_att = regions^T @ d(pregion), at the preset-2
    training shapes (N = B*K*R = 87808, Dr = s = 1024; ``dr`` rows of
    regions instead, as a rank of a model axis takes its slice of Dr) in
    bf16 and in float32, against the plain version; ``torch.mm(a.t(), b,
    out_dtype=float32)`` is timed beside it as the library yardstick.
    Each case reports its route (bf16 at this shape must take wgmma), its
    share of the bound and whether two calls agree bit for bit (they
    must)."""
    m = cfg.model
    n, dr, s = (batch * m.n_frames * m.n_regions, dr or m.region_dim,
                m.region_dim)
    a32 = torch.randn(n, dr, generator=g, device=dev)
    b32 = 0.01 * torch.randn(n, s, generator=g, device=dev)
    cases, times = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        a, b = a32.to(dt), b32.to(dt)
        got, route = route_taken(kernel.dws_gemm,
                                 lambda: kernel.dws_gemm(a, b))
        same = torch.equal(got, kernel.dws_gemm(a, b))
        ref = kernel._dws_plain(a, b)
        torch.cuda.synchronize()
        name = str(dt)[6:]
        cases[name] = {"max_abs_err": max_err([got], [ref]),
                       "rel_err": rel_err([got], [ref]), "route": route,
                       "bitwise_repeatable": same}
        require(same, f"dWs_att kernel {name} is not deterministic")
        require(route == ("wgmma" if dt == torch.bfloat16 else "f32"),
                f"dWs_att kernel {name} took the {route} route")
        require(bool(torch.isfinite(got).all()),
                f"dWs_att kernel {name}: non-finite output")
        require(cases[name]["rel_err"] <= KERNEL_TOL,
                f"dWs_att kernel {name} disagrees: {cases[name]}")
        lib = ((lambda: torch.mm(a.t(), b, out_dtype=torch.float32))
               if dt == torch.bfloat16 else (lambda: torch.mm(a.t(), b)))
        times[name] = {
            "ms": time_ms(lambda: kernel.dws_gemm(a, b), 10),
            "plain_ms": time_ms(lambda: kernel._dws_plain(a, b), 10),
            "library_ms": time_ms(lib, 10),
            **bound(nbytes(a, b) + 4 * dr * s, 2 * n * dr * s,
                    "bf16" if dt == torch.bfloat16 else "f32")}
        times[name]["bound_share"] = (times[name]["bound_ms"]
                                      / times[name]["ms"])
        times[name]["library_ratio"] = (times[name]["ms"]
                                        / times[name]["library_ms"])
        del a, b, got, ref
    out = {"phase": phase, "shape": [n, dr, s],
           "max_abs_err": cases["bfloat16"]["max_abs_err"], "cases": cases,
           "tol_rel": KERNEL_TOL, "route": cases["bfloat16"]["route"],
           "times": times, **times["bfloat16"]}
    emit(out)
    del a32, b32
    torch.cuda.empty_cache()
    return out


def train_setup(cfg, dev, seed, batch):
    """A train state from ``seed`` and one synthetic batch at the
    config's widths (frames, regions for the spatial model and motion
    for the dual-stream one, made by the port's synthetic dataset from
    ``seed``)."""
    from stvd_torch.data.bank import to_device
    from stvd_torch.data.batching import (BatchIterator, gather_batch,
                                          synthetic_dataset)
    from stvd_torch.model.step import compute_dtype
    from stvd_torch.train.loop import init_train_state
    m = cfg.model
    ds = synthetic_dataset(
        n_videos=batch, captions_per_video=2, k=m.n_frames, d=m.ctx_dim,
        n_regions=m.n_regions if m.use_spatial else 0,
        region_dim=m.region_dim,
        motion_dim=m.motion_dim if m.use_motion else 0,
        maxlen=cfg.train.maxlen, seed=seed)
    bank = to_device(ds.bank, dev, compute_dtype(m))
    idx, w = next(BatchIterator(ds.captions.n, batch, seed=seed).epoch())
    b = gather_batch(bank, ds.captions, idx)
    b["weight"] = torch.from_numpy(w).to(dev)
    state = init_train_state(seed, m, cfg.train, dev)
    return state, b


def phase_train(kernel, dev, seed, cfg, phase, expect, updates=5,
                routes=None, step_fn=None, per_step=1) -> dict:
    """``make_train_step`` (with ``step_fn``, the step of the autograd
    scans) at full width, batch 64, T 30, adadelta with global-norm clip
    10: one warm-up update, then ``updates`` updates on one batch with
    every kernel's launches counted from zero.  Each update ends in a
    host read of its loss (synced wall time).  Those in ``expect`` must
    launch ``per_step`` times a step, T ``per_step`` times an update
    (``dws_gemm`` once), the others not at all, each of ``routes``
    (kernel -> route) all of its launches on that route; the loss must
    stay finite and fall."""
    from stvd_torch.train.loop import make_train_step
    state, batch = train_setup(cfg, dev, seed, cfg.train.batch_size)
    train_step = make_train_step(cfg.model, cfg.train, step_fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = train_step(state, batch)
    first = float(m["loss"])
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernel)
    losses, secs = [], []
    for _ in range(updates):
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    launches = read_launches(kernel)
    by_route = read_routes(kernel)
    steps = batch["tokens"].shape[1]
    want = {k: 0 for k in KERNELS}
    for name in expect:
        want[name] = updates * (1 if name == "dws_gemm"
                                else steps * per_step)
    require(launches == want, f"{phase}: kernel launches {launches} != "
                              f"{want}")
    for name, route in (routes or {}).items():
        require(by_route[name][route] == want[name],
                f"{phase}: {name} launches by route {by_route[name]}, "
                f"want all {want[name]} on {route}")
    require(all(np.isfinite([first] + losses)), f"{phase}: loss not finite")
    require(losses[-1] < first, f"{phase}: loss did not fall {losses}")
    step_s = float(np.median(secs))
    out = {"phase": phase,
           "config": {k: getattr(cfg.model, k) for k in (
               "use_spatial", "use_motion", "encoder", "compute_dtype",
               "spatial_bwd_kernel",
               "train_tail_kernel", "train_fwd_kernel",
               "spatial_wgrad_dtype", "fused_seq_grad", "remat")},
           "ss_prob": cfg.train.ss_prob,
           "step_fn": getattr(step_fn, "__name__", None),
           "batch": cfg.train.batch_size, "steps_T": steps,
           "optimizer": cfg.train.optimizer, "clip_c": cfg.train.clip_c,
           "warmup_update_s": warm_s, "loss_warmup": first,
           "loss_per_update": losses, "seconds_per_update": secs,
           "median_step_s": step_s, "steps_per_s": 1.0 / step_s,
           "grad_norm_last": float(m["grad_norm"]),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": launches, "launches_by_route": by_route}
    emit(out)
    del state, batch
    torch.cuda.empty_cache()
    return out


def write_corpus(root, cfg, seed, n_videos=768, per_split=256) -> None:
    """A corpus on disk, written with the port's own writers: the port's
    synthetic bank of ``n_videos`` (ids vid1..vidN, ``FeatureBank.save``),
    2 captions a video of 4-28 words drawn Zipf-like over the vocabulary
    (so captions of every bucket length occur and frequent words are
    learnable), ``{train,valid,test}_ids.txt`` of ``per_split`` videos
    each and a ``vocab.pkl`` of the model's whole vocabulary."""
    from stvd_torch.data.bank import synthetic_bank
    from stvd_torch.data.text import EOS_TOKEN, UNK_TOKEN, Vocab
    m = cfg.model
    bank = synthetic_bank(n_videos, k=m.n_frames, d=m.ctx_dim, seed=seed)
    bank = dataclasses.replace(
        bank, ids=[f"vid{i}" for i in range(1, n_videos + 1)])
    bank.save(os.path.join(root, "feats.npz"))
    words = [f"w{i}" for i in range(2, m.n_words)]
    rank = 1.0 / np.arange(1, len(words) + 1)
    rng = np.random.RandomState(seed)
    caps = {v: [" ".join(rng.choice(words, rng.randint(4, 29),
                                    p=rank / rank.sum()))
                for _ in range(2)] for v in bank.ids}
    with open(os.path.join(root, "captions.json"), "w") as f:
        json.dump(caps, f)
    for i, split in enumerate(("train", "valid", "test")):
        with open(os.path.join(root, f"{split}_ids.txt"), "w") as f:
            f.write("\n".join(bank.ids[i * per_split:(i + 1) * per_split]))
    Vocab({EOS_TOKEN: 0, UNK_TOKEN: 1,
           **{w: i + 2 for i, w in enumerate(words)}}).save_pickle(
        os.path.join(root, "vocab.pkl"))


def phase_eval_fit(kernel, step_mod, dev, seed, cfg) -> dict:
    """Model selection as a user runs it, at full width: ``load_splits``
    reads a corpus written to disk (``write_corpus``), then
    ``fit(cfg, train, valid, test_ds=test, max_updates=10)`` with
    ``metric='meteor'``, ``length_buckets='10,20,30'``, validation and
    samples every 5 updates, batch 64, the train-scan tail kernel on and
    the decode step picked by ``fit`` itself.  Every kernel's launches
    are counted from zero over the fit: the attention core and the logit
    tail once a decode step (beam-5 evaluation of valid and test, greedy
    samples), all on their Hopper routes (cluster, wgmma), the train-scan
    tail once a scan step (the updates at their bucket's length, the
    validation NLL at maxlen), all on wgmma, the others not at all.  Each
    round's decode, scoring and NLL are timed apart per split (synced);
    each round's ``score_all`` must give the same scores on the native
    core and with ``STVD_NO_NATIVE=1``; the samples files must be there;
    and the fitted weights' valid captions through the kernel step must
    agree with the plain step's on a share of 0.95 of the videos."""
    import tempfile
    from stvd_torch.data import corpus
    from stvd_torch.metrics import _native
    from stvd_torch.train import evaluate, loop
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(base, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=base) as root:
        t0 = time.perf_counter()
        write_corpus(root, cfg, seed)
        run = os.path.join(root, "run")
        cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, train_tail_kernel="on"),
            train=dataclasses.replace(
                cfg.train, metric="meteor", length_buckets="10,20,30",
                valid_freq=5, sample_freq=5, disp_freq=5, batch_size=64,
                save_dir=run),
            data=dataclasses.replace(
                cfg.data, dataset="youtube2text", data_dir=root,
                feature_file="feats.npz", captions_file="captions.json",
                vocab_file="vocab.pkl"))
        splits = corpus.load_splits(cfg)
        corpus_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        require(_native.get_lib() is not None, "eval_fit: no metrics core")
        core_s = time.perf_counter() - t0       # its build, once a tree
        require([splits[s].bank.n_videos for s in ("train", "valid", "test")]
                 == [256] * 3, "eval_fit: splits of 256 videos each")

        timed = []          # (what, seconds, args, result)

        def timing(fn, what):
            def wrapped(*args, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                # a copy: fit adds the NLL to the scores dict it returns
                timed.append((what, time.perf_counter() - t, args,
                              dict(out) if isinstance(out, dict) else out))
                return out
            return wrapped

        real = {"generate": evaluate.generate_captions,
                "score": evaluate.score_all, "nll": loop.evaluate_nll,
                "gather": loop.gather_batch, "step": kernel.step_kernels}
        steps, lengths = [0], []

        def gather(dev_bank, caps, idx, seq_len=0):
            if seq_len:                  # an update's batch, not the NLL's
                lengths.append(seq_len)
            return real["gather"](dev_bank, caps, idx, seq_len)

        evaluate.generate_captions = timing(real["generate"], "decode")
        evaluate.score_all = timing(real["score"], "scoring")
        loop.evaluate_nll = timing(real["nll"], "nll")
        loop.gather_batch = gather
        kernel.step_kernels = counted_step(real["step"], steps)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches(kernel)
            t0 = time.perf_counter()
            out = loop.fit(cfg, splits["train"], splits["valid"],
                           test_ds=splits["test"], max_updates=10,
                           device=dev)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            launches, by_route = read_launches(kernel), read_routes(kernel)
        finally:
            evaluate.generate_captions = real["generate"]
            evaluate.score_all = real["score"]
            loop.evaluate_nll = real["nll"]
            loop.gather_batch = real["gather"]
            kernel.step_kernels = real["step"]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        with open(os.path.join(run, "metrics.jsonl")) as f:
            recs = [json.loads(ln) for ln in f]
        kinds = [r["kind"] for r in recs]
        # the splits in the order fit validates them: valid, then test
        order = [(r["update"], r["kind"]) for r in recs
                 if r["kind"] in ("valid", "test")]
        require(order == [(5, "valid"), (5, "test"), (10, "valid"),
                          (10, "test")], f"eval_fit: rounds {order}")
        by_what = {w: [t for t in timed if t[0] == w]
                   for w in ("decode", "scoring", "nll")}
        require(all(len(v) == 4 for v in by_what.values()),
                f"eval_fit: timed calls {[len(v) for v in by_what.values()]}")
        rounds = []
        for i, (update, split) in enumerate(order):
            rec = next(r for r in recs if r["kind"] == split
                       and r["update"] == update)
            rounds.append({
                "update": update, "split": split,
                "decode_s": by_what["decode"][i][1],
                "scoring_s": by_what["scoring"][i][1],
                "nll_s": by_what["nll"][i][1],
                **{k: rec[k] for k in ("nll", "METEOR", "Bleu_4", "CIDEr")}})

        # the scorer on its native core against pure Python, per round
        os.environ["STVD_NO_NATIVE"] = "1"
        try:
            for i, (_, _, args, native) in enumerate(by_what["scoring"]):
                t0 = time.perf_counter()
                python = real["score"](args[0], args[1],
                                       meteor_profile=cfg.train.meteor_profile)
                rounds[i]["python_scoring_s"] = time.perf_counter() - t0
                require(python == native,
                        f"eval_fit: native {native} != python {python}")
        finally:
            del os.environ["STVD_NO_NATIVE"]

        decode_steps = steps[0]
        update_steps = sum(lengths)
        vbs = cfg.train.valid_batch_size
        nll_steps = 2 * sum(
            -(-splits[s].captions.n // min(vbs, splits[s].captions.n))
            * cfg.train.maxlen for s in ("valid", "test"))
        want = {k: 0 for k in KERNELS}
        want.update(attention_core=decode_steps, logit_tail=decode_steps,
                    train_tail=update_steps + nll_steps)
        require(decode_steps > 0 and launches == want,
                f"eval_fit: kernel launches {launches} != {want}")
        for name, route in (("attention_core", "cluster"),
                            ("logit_tail", "wgmma"),
                            ("train_tail", "wgmma")):
            require(by_route[name][route] == want[name],
                    f"eval_fit: {name} launches by route {by_route[name]}, "
                    f"want all {want[name]} on {route}")
        require(sorted(set(lengths)) == [10, 20, 30],
                f"eval_fit: bucket lengths {sorted(set(lengths))}")
        samples = {}
        for split in ("valid", "test"):
            for ext in ("txt", "json"):
                path = os.path.join(run, f"{split}_samples.{ext}")
                require(os.path.isfile(path), f"eval_fit: no {path}")
            with open(os.path.join(run, f"{split}_samples.txt")) as f:
                samples[split] = sum(1 for _ in f)
        require(samples == {"valid": 256, "test": 256},
                f"eval_fit: samples lines {samples}")
        require(os.path.isfile(os.path.join(run, "ckpt_best.pt")),
                "eval_fit: no ckpt_best.pt")

        # the fitted weights' valid captions: kernel step against plain
        valid, params = splits["valid"], out.state["params"]
        rows = []

        def capture(*args, **kw):
            rows.append(real["generate"](*args, **kw))
            return rows[-1]

        evaluate.generate_captions = capture
        t0 = time.perf_counter()
        try:
            parity = {name: evaluate.evaluate_split(
                params, cfg, valid, step_fn=kernel.get_step_fn(use),
                device=dev) for name, use in (("kernels", True),
                                              ("plain", False))}
        finally:
            evaluate.generate_captions = real["generate"]
        parity_s = time.perf_counter() - t0
        same = float(np.mean([a == b for a, b in zip(*rows)]))
        result = {
            "phase": "eval_fit",
            "config": {"preset": NAME,
                       **{k: getattr(cfg.model, k) for k in (
                           "compute_dtype", "dim", "ctx_dim", "n_frames",
                           "n_words", "train_tail_kernel")},
                       "metric": cfg.train.metric,
                       "meteor_profile": cfg.train.meteor_profile,
                       "length_buckets": cfg.train.length_buckets,
                       "batch": cfg.train.batch_size,
                       "beam": cfg.decode.beam_size,
                       "decode_batch": cfg.decode.decode_batch},
            "videos": {s: splits[s].bank.n_videos for s in splits},
            "captions": {s: splits[s].captions.n for s in splits},
            "corpus_write_load_s": corpus_s,
            "metrics_core_build_s": core_s, "fit_s": fit_s,
            "rounds": rounds, "update_lengths": lengths,
            "best": out.best_metric, "best_step": out.best_step,
            "records": {k: kinds.count(k) for k in sorted(set(kinds))},
            "decode_steps": decode_steps, "launches": launches,
            "launches_by_route": by_route, "peak_mem_gib": peak,
            "scores_native_eq_python": True,
            "kernel_vs_plain_share": same, "bar": 0.95,
            "valid_meteor_kernels": parity["kernels"]["METEOR"],
            "valid_meteor_plain": parity["plain"]["METEOR"],
            "kernel_vs_plain_s": parity_s}
        emit(result)
        require(same >= 0.95, f"eval_fit: kernel and plain steps agree on "
                              f"{same:.3f} of the valid captions")
        # the fitted weights, their valid videos and the kernel step's
        # captions of them, for the sharded_serving phase's TP decode
        result["fitted_path"] = os.path.join(base, "fitted_eval.pt")
        torch.save({"params": {k: v.detach().cpu()
                               for k, v in params.items()},
                    "frames": valid.bank.frames,
                    "frame_mask": valid.bank.frame_mask,
                    "rows": rows[0], "config": cfg.to_json()},
                   result["fitted_path"])
    del out, params
    torch.cuda.empty_cache()
    return result


def counted_tails(inner, steps, ks):
    """``counted_step`` that also records the k of every logit tail a
    decode asks for (one per decode call)."""
    fn = counted_step(inner, steps)

    def make_logit_tail(w, b, k_sel):
        ks.append(k_sel)
        return inner.make_logit_tail(w, b, k_sel)

    fn.make_logit_tail = make_logit_tail
    return fn


def quiet(fn, *args):
    """``fn(*args)`` with its standard output kept out of the script's;
    returns its result and its wall seconds (synced)."""
    import contextlib
    import io
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_cli(kernel, dev, seed, cfg, info) -> dict:
    """The port's user entry points in process at full width (preset 3,
    bf16) on a corpus on disk (``write_corpus``), each with every
    kernel's launches counted from zero:

    1. ``cli.train``: 5 updates at batch 64 (T 30) with the train-scan
       tail on, greedy samples and one validation round (valid and test,
       beam 5) at update 5, which writes ``ckpt_best.pt``;
    2. ``cli.sample`` on test with ``--nbest 5 --stochastic 2 --top-k 5
       --dump-attention 8 --nll``, then ``cli.score`` on its samples file,
       whose scores must equal those ``cli.sample`` wrote;
    3. ``cli.convert`` of the bank, as legacy pickles, to an .npz that
       must load equal to the corpus's bank;
    4. ``cli.serve``'s ``build_server`` on the run dir with that bank
       resident, ``--coalesce-wait-ms 2`` and ``--allow-swap``: a
       256-video raw ``/caption`` equal to ``Captioner.from_run_dir``'s
       captions of the same features, ``/nbest`` on 16 videos whose entry
       0 equals ``/caption``'s, ``/caption_ids`` on the 256 videos' ids
       with the same captions, 8 concurrent clients of 32 videos each
       with the same captions, and a ``/swap_params`` after which the
       captions equal a fresh Captioner's on the new weights.

    The attention core and the logit tail launch once a decode step, all
    on their Hopper routes (cluster, wgmma), at the k each decode asks
    for (beam 5, greedy 1, top-k 5); the train-scan tail once a scan
    step (updates and NLL passes), all on wgmma; every other kernel not
    at all.  Then one ``sample_decode`` at top-k 12 launches no logit
    tail (the plain logits path)."""
    import math
    import pickle
    import tempfile
    from stvd_torch.api import Captioner
    from stvd_torch.cli import convert, sample, score, serve, train
    from stvd_torch.data.bank import FeatureBank, to_device
    from stvd_torch.decode.sample import sample_decode
    from stvd_torch.model.step import compute_dtype
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(base, exist_ok=True)
    steps, ks = [0], []
    real_step = kernel.step_kernels
    kernel.step_kernels = counted_tails(real_step, steps, ks)
    result = {"phase": "cli", "card": info["nvidia_smi"], "steps": {}}

    def counted(name, fn, *args):
        """Run one step from zero counts; its record, its output."""
        reset_launches(kernel)
        steps[0] = 0
        ks.clear()
        out, secs = quiet(fn, *args)
        rec = {"seconds": secs, "decode_steps": steps[0], "ks": list(ks),
               "launches": read_launches(kernel),
               "launches_by_route": read_routes(kernel)}
        result["steps"][name] = rec
        return rec, out

    def check(name, rec, train_tail=0):
        want = {k: 0 for k in KERNELS}
        want.update(attention_core=rec["decode_steps"],
                    logit_tail=rec["decode_steps"], train_tail=train_tail)
        require(rec["launches"] == want,
                f"cli {name}: kernel launches {rec['launches']} != {want}")
        for kname, route in (("attention_core", "cluster"),
                             ("logit_tail", "wgmma"),
                             ("train_tail", "wgmma")):
            require(rec["launches_by_route"][kname][route] == want[kname],
                    f"cli {name}: {kname} launches by route "
                    f"{rec['launches_by_route'][kname]}, want all on {route}")

    try:
        with tempfile.TemporaryDirectory(dir=base) as root:
            write_corpus(root, cfg, seed)
            run = os.path.join(root, "run")
            c = cfg.replace(
                train=dataclasses.replace(
                    cfg.train, metric="meteor", length_buckets="",
                    valid_freq=5, sample_freq=5, disp_freq=5,
                    batch_size=64, save_dir=run),
                data=dataclasses.replace(
                    cfg.data, dataset="youtube2text", data_dir=root,
                    feature_file="feats.npz", captions_file="captions.json",
                    vocab_file="vocab.pkl"))
            cfg_path = os.path.join(root, "config.json")
            with open(cfg_path, "w") as f:
                f.write(c.to_json())
            T = c.train.maxlen
            vbs = c.train.valid_batch_size
            bank_all = FeatureBank.load(os.path.join(root, "feats.npz"))
            ids = {}
            for split in ("train", "valid", "test"):
                with open(os.path.join(root, f"{split}_ids.txt")) as f:
                    ids[split] = f.read().split()
            with open(os.path.join(root, "captions.json")) as f:
                refs = json.load(f)

            def nll_steps(split):
                """The train tail's launches of a split's NLL pass."""
                n = sum(len(refs[v]) for v in ids[split])
                return -(-n // min(vbs, n)) * T

            # 1. train
            rec, rc = counted("train", train.main, [
                "--config", cfg_path, "--set", "model.train_tail_kernel=on",
                "--max-updates", "5", "--device", str(dev)])
            require(rc == 0, f"cli train: exit {rc}")
            require(rec["ks"] == [1, 5, 5], f"cli train: tails {rec['ks']}")
            check("train", rec, 5 * T + nll_steps("valid")
                  + nll_steps("test"))
            with open(os.path.join(run, "metrics.jsonl")) as f:
                kinds = [json.loads(ln)["kind"] for ln in f]
            require(kinds[-1] == "done" and "valid" in kinds
                    and "test" in kinds, f"cli train: records {kinds}")
            for name in ("config.json", "vocab.pkl", "ckpt.pt",
                         "ckpt_best.pt"):
                require(os.path.isfile(os.path.join(run, name)),
                        f"cli train: no {name}")

            # 2. sample, then score its samples file
            rec, rc = counted("sample", sample.main, [
                "--run-dir", run, "--split", "test", "--nbest", "5",
                "--stochastic", "2", "--top-k", "5", "--dump-attention",
                "8", "--nll", "--device", str(dev)])
            require(rc == 0, f"cli sample: exit {rc}")
            require(rec["ks"] == [5, 5, 5, 1], f"cli sample: tails "
                                               f"{rec['ks']}")
            check("sample", rec, nll_steps("test"))
            with open(os.path.join(run, "test_scores.json")) as f:
                sampled = json.load(f)["scores"]
            require(all(math.isfinite(v) for v in sampled.values())
                    and sampled["nll"] > 0, f"cli sample: {sampled}")
            with open(os.path.join(run, "test_samples.txt")) as f:
                require(sum(1 for _ in f) == 256, "cli sample: samples")
            with open(os.path.join(run, "test_nbest.json")) as f:
                nb = json.load(f)
            require(len(nb) == 5 and all(
                len(r["beams"]) == 5 and all(
                    math.isfinite(b["logprob"]) for b in r["beams"])
                for r in nb), "cli sample: n-best file")
            with open(os.path.join(run, "test_sampled.json")) as f:
                sm = json.load(f)
            require(len(sm) == 256 and all(
                len(r["samples"]) == 2 and all(
                    s["logprob"] <= 0 for s in r["samples"]) for r in sm),
                "cli sample: sampled file")
            with np.load(os.path.join(run, "test_attention.npz")) as z:
                al, toks = z["alphas"], z["tokens"]
            lens = np.minimum((toks != 0).sum(1) + 1, T)
            live = np.arange(T)[None] < lens[:, None]
            require(al.shape == (8, T, cfg.model.n_frames)
                    and np.allclose(al.sum(-1)[live], 1.0, atol=1e-3),
                    "cli sample: attention maps")
            scored = os.path.join(run, "test_scored.json")
            rec, rc = counted("score", score.main, [
                "--hyp", os.path.join(run, "test_samples.json"),
                "--refs", os.path.join(root, "captions.json"),
                "--ids", os.path.join(root, "test_ids.txt"),
                "--out", scored])
            require(rc == 0 and rec["decode_steps"] == 0, "cli score")
            check("score", rec)
            with open(scored) as f:
                got = json.load(f)["scores"]
            require(got == {k: v for k, v in sampled.items() if k in got},
                    f"cli score: {got} != {sampled}")

            # 3. convert the bank, as legacy pickles, to an npz
            feats = {v: bank_all.frames[i][bank_all.frame_mask[i] > 0]
                     for i, v in enumerate(bank_all.ids)}
            with open(os.path.join(root, "feats.pkl"), "wb") as f:
                pickle.dump(feats, f, protocol=4)
            bank_path = os.path.join(root, "bank.npz")
            rec, rc = counted("convert", convert.main, [
                "--features", os.path.join(root, "feats.pkl"), "--frames",
                str(cfg.model.n_frames), "--out", bank_path])
            require(rc == 0, "cli convert")
            check("convert", rec)
            conv = FeatureBank.load(bank_path)
            rows = [conv.index()[v] for v in bank_all.ids]   # sorted ids
            require(sorted(conv.ids) == sorted(bank_all.ids)
                    and np.array_equal(conv.frames[rows], bank_all.frames)
                    and np.array_equal(conv.frame_mask[rows],
                                       bank_all.frame_mask),
                    "cli convert: bank differs from the corpus's")

            # 4. serve
            result["serve"] = serve_checks(
                serve, Captioner, counted, check, run, bank_path,
                [feats[v] for v in ids["test"]], ids["test"], seed, cfg,
                dev)

            # the plain logits path of sampling: top-k 12, no logit tail
            cap = Captioner.from_run_dir(run, device=dev)
            batch = {k: v[:8] for k, v in to_device(
                conv, dev, compute_dtype(cap.cfg.model)).items()}
            rec, out = counted("sample_top_k_12", lambda: sample_decode(
                cap.params, cap.cfg.model, batch,
                torch.Generator(device=dev).manual_seed(seed),
                temperature=1.0, top_k=12, n_samples=2,
                step_fn=kernel.get_step_fn(True)))
            require(rec["ks"] == [12] and rec["decode_steps"] > 0, "top-k 12")
            want = {k: 0 for k in KERNELS}
            want["attention_core"] = rec["decode_steps"]
            require(rec["launches"] == want,
                    f"cli top-k 12: launches {rec['launches']} != {want}")
            require(bool(torch.isfinite(out.scores).all()), "top-k 12 scores")
            del cap
    finally:
        kernel.step_kernels = real_step
    result["launches"] = {k: sum(r["launches"][k]
                                 for r in result["steps"].values())
                          for k in KERNELS}
    emit(result)
    torch.cuda.empty_cache()
    return result


def serve_checks(serve, Captioner, counted, check, run, bank_path, videos,
                 ids, seed, cfg, dev) -> dict:
    """``cli.serve`` over the run dir with the bank resident (see
    ``phase_cli``, step 4).  The raw wire carries (N, K, D) arrays, so
    the feature requests send the test videos as the bank holds them, K
    frames each with zero frames after a short video's own; the id
    requests name the same videos."""
    import argparse
    import http.client
    import threading
    host = "127.0.0.1"
    args = argparse.Namespace(
        artifact=None, run_dir=run, bank=bank_path, bank_shards=0,
        quant=None, device=str(dev), host=host, port=0,
        no_warmup=False, coalesce_wait_ms=2.0, allow_swap=True,
        allow_shutdown=False, verbose=False)
    k = cfg.model.n_frames
    arr = np.stack([np.pad(f, ((0, k - len(f)), (0, 0))) for f in videos])

    def call(port, method, path, body=None):
        conn = http.client.HTTPConnection(host, port, timeout=300)
        try:
            conn.request(method, path, body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    def timed(res, name, n, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        dt = time.perf_counter() - t0
        res[name] = {"videos": n, "seconds": dt, "captions_per_s": n / dt}
        return out

    def drive():
        server, build_s = quiet(serve.build_server, args)
        warm_s = server.warmup()
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_port
        res = {"build_server_s": build_s, "warmup_s": warm_s}
        try:
            caps = timed(res, "caption_256", 256, serve.request_captions,
                         host, port, arr, None, None, 300.0)
            direct = Captioner.from_run_dir(run, device=dev)
            require(caps == direct.caption(arr),
                    "cli serve: /caption != Captioner.caption")
            nb = timed(res, "nbest_16", 16, serve.request_nbest, host, port,
                       arr[:16], None, None, None, 300.0)
            require([v[0][0] for v in nb] == caps[:16],
                    "cli serve: /nbest entry 0 != /caption")
            by_id = timed(res, "caption_ids_256", 256,
                          serve.request_caption_ids, host, port, ids, 300.0)
            require(by_id == direct.caption(videos),
                    "cli serve: /caption_ids != Captioner.caption")
            got = [None] * 8

            def client(i):
                got[i] = serve.request_captions(
                    host, port, arr[32 * i:32 * (i + 1)], timeout=300.0)

            def clients():
                threads = [threading.Thread(target=client, args=(i,))
                           for i in range(8)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=300)

            timed(res, "concurrent_8x32", 256, clients)
            require(sum(got, []) == caps,
                    "cli serve: concurrent clients != /caption")
            blob = torch.load(os.path.join(run, "ckpt.pt"),
                              weights_only=True)["params"]
            new = {n: v.float().numpy() for n, v in blob.items()}
            new["ff_logit_b"] = new["ff_logit_b"] + 2.0 * (
                np.random.RandomState(seed).randn(
                    *new["ff_logit_b"].shape).astype(np.float32))
            swap_path = os.path.join(os.path.dirname(run), "swap.npz")
            np.savez(swap_path, **new)
            st, body = call(port, "POST", "/swap_params",
                            json.dumps({"path": swap_path}))
            require(st == 200 and body["status"] == "swapped",
                    f"cli serve: /swap_params {st} {body}")
            swapped = serve.request_captions(host, port, arr[:32],
                                             timeout=300.0)
            fresh = Captioner(new, direct.cfg, direct.vocab, device=dev)
            require(swapped == fresh.caption(arr[:32]),
                    "cli serve: after the swap != a fresh Captioner")
            require(swapped != caps[:32],
                    "cli serve: the swap changed no caption")
            _, stats = call(port, "GET", "/stats")
            res["stats"] = {r: {n: v[n] for n in ("count", "videos",
                                                  "p50_ms", "p95_ms")}
                            for r, v in stats.items()
                            if isinstance(v, dict) and "p50_ms" in v}
            res["coalesce"] = stats.get("coalesce")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        return res

    rec, res = counted("serve", drive)
    require(rec["ks"] and set(rec["ks"]) == {5}, f"cli serve: tails "
                                                f"{rec['ks']}")
    check("serve", rec)
    return res


def phase_msrvtt_entry(kernel, dev, seed, cfg, params, vocab,
                       n_videos=128) -> dict:
    """Preset 4's entry points: ``cli.convert --features --motion`` of
    ``n_videos`` random videos (20-36 frames of appearance and motion
    features, 2048 wide) from legacy pickles, whose bank must equal
    ``pack_bank`` of the same arrays; then ``cli.serve``'s
    ``build_server`` on a run dir of ``params`` with that bank resident
    (warm-up with a motion stream): ``/caption`` with a motion array over
    the raw wire and ``/caption_ids`` of the same videos, each equal to
    ``Captioner.from_run_dir``'s captions, with the attention core and
    the logit tail launched once a decode step, all on cluster / wgmma."""
    import argparse
    import pickle
    import tempfile
    import threading
    from stvd_torch.api import Captioner
    from stvd_torch.cli import convert, serve
    from stvd_torch.data.bank import FeatureBank, pack_bank
    from stvd_torch.train.loop import save_checkpoint
    m = cfg.model
    rng = np.random.default_rng(seed + 11)
    lens = rng.integers(20, 37, size=n_videos)
    ids = [f"video{i}" for i in range(n_videos)]
    feats = {v: rng.standard_normal((f, m.ctx_dim), dtype=np.float32)
             for v, f in zip(ids, lens)}
    mots = {v: rng.standard_normal((f, m.motion_dim), dtype=np.float32)
            for v, f in zip(ids, lens)}
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(base, exist_ok=True)
    res = {}
    with tempfile.TemporaryDirectory(dir=base) as root:
        for name, obj in (("feats.pkl", feats), ("motion.pkl", mots)):
            with open(os.path.join(root, name), "wb") as f:
                pickle.dump(obj, f, protocol=4)
        bank_path = os.path.join(root, "bank.npz")
        rc, res["convert_s"] = quiet(convert.main, [
            "--features", os.path.join(root, "feats.pkl"), "--motion",
            os.path.join(root, "motion.pkl"), "--frames", str(m.n_frames),
            "--out", bank_path])
        require(rc == 0, "msrvtt convert")
        conv = FeatureBank.load(bank_path)
        want = pack_bank(feats, m.n_frames, motion=mots)
        require(conv.ids == want.ids and conv.motion is not None
                and all(np.array_equal(getattr(conv, k), getattr(want, k))
                        for k in ("frames", "frame_mask", "motion")),
                "msrvtt convert: bank != pack_bank of the same arrays")
        run = os.path.join(root, "run")
        os.makedirs(run)
        with open(os.path.join(run, "config.json"), "w") as f:
            f.write(cfg.to_json())
        vocab.save_pickle(os.path.join(run, "vocab.pkl"))
        save_checkpoint(os.path.join(run, "ckpt.pt"),
                        {"params": params, "opt_state": (), "step": 0,
                         "generator": torch.Generator(device=dev)}, {})
        order = sorted(ids)                       # the bank's row order
        arr = np.stack([conv.frames[conv.index()[v]] for v in order])
        mot = np.stack([conv.motion[conv.index()[v]] for v in order])
        args = argparse.Namespace(
            artifact=None, run_dir=run, bank=bank_path, bank_shards=0,
            quant=None, device=str(dev), host="127.0.0.1", port=0,
            no_warmup=False, coalesce_wait_ms=0.0, allow_swap=False,
            allow_shutdown=False, verbose=False)
        steps, ks = [0], []
        real_step = kernel.step_kernels
        kernel.step_kernels = counted_tails(real_step, steps, ks)
        try:
            server, res["build_server_s"] = quiet(serve.build_server, args)
            res["warmup_s"] = server.warmup()
            thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
            thread.start()
            try:
                reset_launches(kernel)
                steps[0] = 0
                t0 = time.perf_counter()
                caps = serve.request_captions("127.0.0.1",
                                              server.server_port, arr,
                                              None, mot, timeout=300.0)
                res["caption_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                by_id = serve.request_caption_ids(
                    "127.0.0.1", server.server_port, order, timeout=300.0)
                res["caption_ids_s"] = time.perf_counter() - t0
                launches, by_route = read_launches(kernel), read_routes(kernel)
                served_steps = steps[0]
            finally:
                server.shutdown()
                server.server_close()
                thread.join(timeout=60)
        finally:
            kernel.step_kernels = real_step
        direct = Captioner.from_run_dir(run, device=dev)
        require(caps == direct.caption(arr, None, mot),
                "msrvtt serve: /caption != Captioner.caption")
        require(by_id == direct.caption(
            [feats[v] for v in order], None, [mots[v] for v in order]),
            "msrvtt serve: /caption_ids != Captioner.caption")
        require(len(caps) == n_videos and any(caps),
                "msrvtt serve: captions")
        want = {name: 0 for name in KERNELS}
        want["attention_core"] = want["logit_tail"] = served_steps
        require(served_steps > 0 and launches == want,
                f"msrvtt serve: launches {launches} != {want}")
        for name, route in SERVING_ROUTES.items():
            require(by_route[name][route] == want[name],
                    f"msrvtt serve: {name} by route {by_route[name]}")
        del direct
    res.update(videos=n_videos, decode_steps=served_steps,
               launches=launches, launches_by_route=by_route)
    torch.cuda.empty_cache()
    return res


def phase_msrvtt(api, kernel, step_mod, dev, seed, info, profile) -> dict:
    """Preset 4 (``msrvtt-fused``: appearance and motion streams fused to
    a 2048-wide float32 context; dim 3584, dim_word 512, vocab 20096,
    bf16) at full width, random weights from ``seed``:

    * kernel 1 at its serving shape (256 rows, nb 5, A = Dc = 2048, ctx
      float32, and bf16 beside it) and at the training scan's (64, nb 1)
      on route 'cluster' against its plain version and route 'simple';
      kernel 2 at V 20096; kernel 6 at (64, 2048, 14336);
    * serving (beam 5, 256 videos of 20-36 frames, natural EOS and EOS
      suppressed), every attention-core launch on 'cluster' and every
      logit-tail launch on 'wgmma'; the kernel step against the plain
      step at float32 (share >= 0.95); a second decode with the
      frame-LSTM encoder;
    * one training setup at batch 64, T 30, bf16, tail kernel on, and the
      float32 gradients of the kernel path against the plain path (every
      leaf, W_app, W_mot and b_fuse among them);
    * the entry points (``phase_msrvtt_entry``)."""
    from stvd_torch.model.decoder import init_params
    cfg = api.preset(MSRVTT)
    m = cfg.model
    g = torch.Generator(device=dev).manual_seed(seed + 40)
    rows, nb, tb = (cfg.decode.decode_batch, cfg.decode.beam_size,
                    cfg.train.batch_size)
    f32, bf16 = torch.float32, torch.bfloat16
    attn = phase_attention(
        kernel, step_mod, dev, g, cfg, splits=profile,
        shapes=(("serving", rows, nb, f32), ("serving_bf16_ctx", rows, nb,
                                             bf16),
                ("training", tb, 1, f32), ("training_bf16_ctx", tb, 1,
                                           bf16)),
        phase="msrvtt_kernel_attention_core")
    tail = phase_tail(kernel, dev, g, seed, cfg,
                      phase="msrvtt_kernel_logit_tail")
    train_tail = phase_train_tail(kernel, dev, g, cfg, tb,
                                  phase="msrvtt_kernel_train_tail")
    vocab = api.Vocab({f"w{i}": i for i in range(2, m.n_words)})
    params = init_params(
        m, torch.Generator(device=dev).manual_seed(seed + 4), dev)
    serving = phase_serving(api, kernel, dev, seed, params, vocab, cfg,
                            "msrvtt_serving", ("attention_core",
                                               "logit_tail"),
                            routes=SERVING_ROUTES)
    phase_kernel_vs_plain(api, kernel, step_mod, dev, seed, params, vocab,
                          with_model(cfg, compute_dtype="float32"),
                          "msrvtt_kernel_vs_plain_f32")
    if profile:
        phase_profile(api, dev, params, vocab, seed, cfg, "profile_msrvtt")
    entry = phase_msrvtt_entry(kernel, dev, seed, cfg, params, vocab)
    emit({"phase": "msrvtt_entry", **entry})
    del params
    torch.cuda.empty_cache()
    cfg_l = with_model(cfg, encoder="lstm")
    params = init_params(
        cfg_l.model, torch.Generator(device=dev).manual_seed(seed + 5), dev)
    serving_l = phase_serving(api, kernel, dev, seed, params, vocab, cfg_l,
                              "msrvtt_serving_lstm",
                              ("attention_core", "logit_tail"),
                              modes=("eos_suppressed",),
                              routes=SERVING_ROUTES)
    del params
    torch.cuda.empty_cache()
    train = phase_train(kernel, dev, seed,
                        with_model(cfg, train_tail_kernel="on"),
                        "msrvtt_train", ("train_tail",),
                        routes={"train_tail": "wgmma"})
    phase_train_kernel_vs_plain(kernel, dev, seed, cfg,
                                phase="msrvtt_train_kernel_vs_plain_f32")
    worst = serving["runs"][f"eos_suppressed_{rows}"]
    natural = serving["runs"][f"natural_eos_{rows}"]
    out = {"phase": "msrvtt", "card": info["nvidia_smi"],
           "attention_core": {c: {k: attn["cases"][c][k] for k in (
               "route", "splits", "max_abs_err", "ms", "device_ms",
               "simple_device_ms", "bound_ms", "bound_share")}
               for c in attn["cases"]},
           "logit_tail": {k: tail[k] for k in ("route", "ms", "bound_ms",
                                                "max_abs_err")},
           "train_tail": {k: train_tail[k] for k in (
               "route", "ms", "device_ms", "cold_device_ms", "bound_ms")},
           "worst_case_captions_per_s": worst["captions_per_s"],
           "natural_eos_captions_per_s": natural["captions_per_s"],
           "serving_peak_mem_gib": serving["peak_mem_gib"],
           "lstm_worst_case_captions_per_s": serving_l["runs"][
               f"eos_suppressed_{rows}"]["captions_per_s"],
           "lstm_peak_mem_gib": serving_l["peak_mem_gib"],
           "train_median_step_s": train["median_step_s"],
           "train_peak_mem_gib": train["peak_mem_gib"],
           "serve_caption_s": entry["caption_s"],
           "serve_caption_ids_s": entry["caption_ids_s"]}
    emit(out)
    return {"attention": attn, "tail": tail, "train_tail": train_tail,
            "serving": serving, "train": train}


# the reference-exact recipes: (file, decode batch of the float32 and
# int8 comparisons, the kernels a training update launches and their
# routes).  msvd's comparisons are cut from 256 videos to 64: the plain
# spatial core's e_s is 7.2 GB a step at 256
RECIPES = {
    "msvd": (64, ("spatial_bwd", "dws_gemm"),
             {"dws_gemm": "wgmma", "spatial_bwd": "vector"}),
    "msrvtt": (256, (), {}),
}


def recipe_config(name):
    from stvd_torch.config import Config
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "recipes", f"{name}.json")
    with open(path) as f:
        return Config.from_json(f.read())


def tail_on_route(kernel, step_fn, route):
    """``step_fn`` whose decode loops take kernel 2 on ``route`` (the
    wgmma route's witness in the same run: the old route at the same
    operands)."""
    from stvd_torch.model import step as step_mod

    def make_logit_tail(w, b, k_sel):
        if k_sel > 8:
            return None
        wp, bf = step_mod.pad_cols(w), b.to(torch.float32)

        def forced(act):
            return kernel._logit_tail_cuda(act, wp, bf, k_sel, route=route)
        return forced

    def fn(*args, **kw):
        return step_fn(*args, **kw)
    fn.make_logit_tail = make_logit_tail
    return fn


def phase_recipes(api, kernel, step_mod, dev, seed, info) -> dict:
    """The reference-exact recipes (``recipes/msvd.json``: the spatial
    model, vocab 13010; ``recipes/msrvtt.json``: dual stream, ctx 2048,
    vocab 20000; both dim 3518, dim_word 468, bf16), loaded by
    ``Config.from_json``, random weights from ``seed``, through the
    port's entry points at their published widths:

    * kernel 2 at (1280, 468, V) and kernel 3 at the recipe's Kx (5010,
      6034) and 4 dim 14072 against their plain versions on the padded
      rows the decode stores, timed beside the wmma route on the dense
      operands, the library product and ``torch.lstm_cell``;
    * ``Captioner.caption`` of 1, 37 and 256 videos, beam 5, natural EOS
      and EOS suppressed, every kernel-2 launch on wgmma; the same worst
      case with kernel 2 forced onto wmma (seconds beside it);
    * ``decode_quant='int8'``, ``gates_kernel='on'`` with EOS suppressed,
      every kernel-3 and kernel-2 launch on wgmma;
    * the kernel step against the plain step (float32, share >= 0.95)
      and the int8 kernel step against plain int8 gates (>= 0.95) and
      the all-plain step (>= INT8_PLAIN_SHARE);
    * one ``make_train_step`` update at the recipe's batch and defaults.
    """
    from stvd_torch.model.decoder import init_params
    out = {}
    for i, (name, (cmp_batch, train_kernels, train_routes)) in enumerate(
            RECIPES.items()):
        t0 = time.perf_counter()
        cfg = recipe_config(name)
        m = cfg.model
        cfg_q = with_model(cfg, decode_quant="int8", gates_kernel="on")
        g = torch.Generator(device=dev).manual_seed(seed + 60 + i)
        tail = phase_tail(kernel, dev, g, seed, cfg,
                          phase=f"recipe_{name}_kernel_logit_tail")
        gates = phase_gates(kernel, step_mod, dev, g, cfg_q,
                            phase=f"recipe_{name}_kernel_gates_lstm")
        vocab = api.Vocab({f"w{j}": j for j in range(2, m.n_words)})
        params = init_params(
            m, torch.Generator(device=dev).manual_seed(seed + 70 + i), dev)
        serve_routes = {**SERVING_ROUTES, **(
            {"spatial_core": "tma"} if m.use_spatial else {})}
        engaged = ("attention_core", "logit_tail") + (
            ("spatial_core",) if m.use_spatial else ())
        serving = phase_serving(api, kernel, dev, seed, params, vocab, cfg,
                                f"recipe_{name}_serving", engaged,
                                routes=serve_routes)
        serving_q = phase_serving(
            api, kernel, dev, seed, params, vocab, cfg_q,
            f"recipe_{name}_serving_int8_gates", engaged + ("gates_lstm",),
            modes=("eos_suppressed",),
            routes={**serve_routes, "gates_lstm": "wgmma"})
        # the worst case again with kernel 2 forced onto its old route
        feats = request(np.random.RandomState(seed), cfg.decode.decode_batch,
                        m)
        regs, mots = streams(feats, m, seed + cfg.decode.decode_batch)
        cap = api.Captioner(params, cfg, vocab, device=dev)
        cap.params["ff_logit_b"][0] = -1e9
        ab = {}
        for label, fn in (("wgmma", kernel.step_kernels),
                          ("wmma", tail_on_route(kernel, kernel.step_kernels,
                                                 "wmma"))):
            cap.step_fn = fn
            cap.caption(feats[:1], None if regs is None else regs[:1],
                        None if mots is None else mots[:1])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cap.caption(feats, regs, mots)
            torch.cuda.synchronize()
            ab[label] = time.perf_counter() - t1
        del cap
        cmp_cfg = cfg.replace(decode=dataclasses.replace(
            cfg.decode, decode_batch=cmp_batch))
        phase_kernel_vs_plain(api, kernel, step_mod, dev, seed, params,
                              vocab, with_model(cmp_cfg,
                                                compute_dtype="float32"),
                              f"recipe_{name}_kernel_vs_plain_f32")
        cmp_q = with_model(cmp_cfg, decode_quant="int8", gates_kernel="on")
        phase_kernel_vs_plain(api, kernel, step_mod, dev, seed, params,
                              vocab, cmp_q,
                              f"recipe_{name}_kernel_vs_plain_int8",
                              plain_cfg=with_model(cmp_q,
                                                   gates_kernel="off"))
        del params
        torch.cuda.empty_cache()
        train = phase_train(kernel, dev, seed, cfg, f"recipe_{name}_train",
                            train_kernels, updates=1, routes=train_routes)
        rows = cfg.decode.decode_batch
        res = {"phase": f"recipe_{name}", "card": info["nvidia_smi"],
               "widths": {k: getattr(m, k) for k in (
                   "dim", "dim_word", "n_words", "ctx_dim", "use_spatial",
                   "use_motion", "compute_dtype")},
               "kx": m.dim_word + m.dim + m.ctx_dim,
               "logit_tail": {k: tail[k] for k in (
                   "route", "row_strides", "ms", "wmma_ms", "plain_ms",
                   "product_ms", "bound_ms", "bound_share", "wmma_ratio",
                   "product_ratio", "max_abs_err")},
               "gates_lstm": {md: {k: gates["times"][md][k] for k in (
                   "ms", "wmma_ms", "plain_ms", "product_ms", "library_ms",
                   "bound_ms", "bound_share", "wmma_ratio")}
                   for md in ("bf16", "int8")},
               "gates_routes": {c: gates["cases"][c]["route"]
                                for c in gates["cases"]},
               "worst_case_captions_per_s": serving["runs"][
                   f"eos_suppressed_{rows}"]["captions_per_s"],
               "natural_eos_captions_per_s": serving["runs"][
                   f"natural_eos_{rows}"]["captions_per_s"],
               "int8_worst_case_captions_per_s": serving_q["runs"][
                   f"eos_suppressed_{rows}"]["captions_per_s"],
               "worst_case_s_tail_wgmma": ab["wgmma"],
               "worst_case_s_tail_wmma": ab["wmma"],
               "launches_by_route": serving["launches_by_route"],
               "int8_launches_by_route": serving_q["launches_by_route"],
               "peak_mem_gib": serving["peak_mem_gib"],
               "train_update_s": train["median_step_s"],
               "train_launches": train["launches"],
               "recipe_seconds": time.perf_counter() - t0}
        emit(res)
        out[name] = {"tail": tail, "gates": gates, "serving": serving,
                     "serving_q": serving_q, "train": train}
    return out


def iid_features(b, dev, seed) -> None:
    """Frames, regions and motion of batch ``b`` redrawn i.i.d. normal (in
    place): the synthetic dataset's frames of a video differ by 0.1-scale
    noise, so the attention weights are near uniform and the softmax
    backwards subtract near-equal terms, which magnifies float32
    rounding of any summation order."""
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    for key in ("frames", "regions", "motion"):
        if key in b:
            b[key] = torch.randn(b[key].shape, generator=gen, device=dev)


def loss_grads(params, mcfg, b, step_fn=None, ss_prob=0.0, seed=0):
    """(loss, {name: gradient}, seconds) of one loss at train=False; the
    scheduled-sampling coins come from a generator seeded ``seed``."""
    from stvd_torch.train.loss import loss_fn
    gen = torch.Generator(device=b["tokens"].device).manual_seed(seed)
    t0 = time.perf_counter()
    loss, _ = loss_fn(params, mcfg, b, gen, train=False, ss_prob=ss_prob,
                      step_fn=step_fn)
    grads = [torch.zeros_like(p) if gr is None else gr
             for p, gr in zip(params.values(), torch.autograd.grad(
                 loss, list(params.values()), allow_unused=True))]
    torch.cuda.synchronize()
    return (float(loss.detach()), dict(zip(params, grads)),
            time.perf_counter() - t0)


def leaf_gaps(got, ref) -> dict:
    """Per parameter, max|got - ref| over max|ref| (gradients, weights
    or updates keyed by name); c_att and cs_att shift every score of a
    softmax alike, so their gradient is zero up to rounding: they are
    held to the largest entry of the model."""
    top = max(float(v.abs().max()) for v in ref.values())
    return {k: float((got[k] - ref[k]).abs().max()) / (
        top if k in ("c_att", "cs_att")
        else max(float(ref[k].abs().max()), 1e-30)) for k in ref}


def grad_gap(got, ref) -> dict:
    """``got`` against ``ref`` (each ``loss_grads``'s result): the loss's
    relative difference and ``leaf_gaps`` of the gradients."""
    (lg, gg, _), (lr, gr, _) = got, ref
    worst = leaf_gaps(gg, gr)
    return {"loss_rel_diff": abs(lg - lr) / abs(lr),
            "worst_leaf": max(worst, key=worst.get),
            "worst_rel": max(worst.values()),
            "bad": {k: v for k, v in worst.items() if not v <= GRAD_TOL}}


def phase_train_kernel_vs_plain(kernel, dev, seed, cfg, batch=16,
                                phase="train_kernel_vs_plain_f32") -> None:
    """One train step's loss and gradients at float32, full width, batch
    16: every training kernel on against every one off, on the same
    weights and batch (features i.i.d., ``iid_features``).  Per
    parameter, max|g_kernel - g_plain| must stay within GRAD_TOL of
    max|g_plain| (``grad_gap``), the loss within 1e-5 relative."""
    cfg = with_model(cfg, compute_dtype="float32", use_dropout=False)
    state, b = train_setup(cfg, dev, seed, batch)
    iid_features(b, dev, seed)
    params = state["params"]
    out = {}
    for name, switch in (("kernels", "on"), ("plain", "off")):
        mcfg = dataclasses.replace(cfg.model, spatial_bwd_kernel=switch,
                                   train_tail_kernel=switch,
                                   train_fwd_kernel=switch)
        out[name] = loss_grads(params, mcfg, b)
    gap = grad_gap(out["kernels"], out["plain"])
    emit({"phase": phase, "batch": batch,
          "loss_kernels": out["kernels"][0], "loss_plain": out["plain"][0],
          "loss_rel_diff": gap["loss_rel_diff"],
          "worst_leaf": gap["worst_leaf"], "worst_rel": gap["worst_rel"],
          "bar": GRAD_TOL, "kernels_seconds": out["kernels"][2],
          "plain_seconds": out["plain"][2]})
    require(gap["loss_rel_diff"] <= 1e-5,
            f"train kernel vs plain loss: {out['kernels'][0]} vs "
            f"{out['plain'][0]}")
    require(not gap["bad"], f"train kernel vs plain gradients: {gap['bad']}")
    del state, b, out
    torch.cuda.empty_cache()


def phase_train_autodiff(kernel, step_mod, dev, seed, cfg, cfg_sp) -> dict:
    """The autograd train scans at full width (PR 12): scheduled sampling
    and the autodiff scan, with kernels 1 and 4 carrying gradients
    through their autograd Functions.

    1. preset 3, bf16, ``ss_prob=0.25`` through ``make_train_step(mcfg,
       tcfg, kernel.step_kernels)``: warm-up, 5 updates, kernel 1 30
       launches an update, all on route cluster, the rest 0;
    2. preset 2, bf16, ``fused_seq_grad=False``, ``remat=True``: 2
       updates; kernels 1 and 4 launch twice a step (remat runs each
       step's forward again in the backward), the dWs_att GEMM once an
       update (the region projection's backward), the rest 0;
    3. float32, batch 16, preset 3 autodiff scan: kernel step against
       plain step, and the plain autodiff scan against the hand VJP,
       each leaf within GRAD_TOL of its largest entry, loss within 1e-5;
    4. float32, ``ss_prob=0.25``, the same coins on both sides: the share
       of the (B, T) predicted tokens on which the kernel step and the
       plain step agree (>= 0.95) and the loss difference;
    5. a 3-update ``fit`` on synthetic data with ``ss_prob=0.25``, the
       profiler window on update 2 and ``debug_nans``: a trace file, a
       ``profile`` record, finite losses, kernel 1 at 30 an update."""
    import tempfile
    from stvd_torch.data.batching import synthetic_dataset
    from stvd_torch.model.decoder import forward_train
    from stvd_torch.train.loop import fit
    ks = kernel.step_kernels
    res = {}
    res["ss"] = phase_train(
        kernel, dev, seed,
        cfg.replace(train=dataclasses.replace(cfg.train, ss_prob=0.25)),
        "train_autodiff_ss", ("attention_core",),
        routes={"attention_core": "cluster"}, step_fn=ks)
    res["spatial_remat"] = phase_train(
        kernel, dev, seed, with_model(cfg_sp, fused_seq_grad=False,
                                      remat=True),
        "train_autodiff_spatial_remat",
        ("attention_core", "spatial_core", "dws_gemm"), updates=2,
        routes={"attention_core": "cluster", "spatial_core": "tma",
                "dws_gemm": "wgmma"}, step_fn=ks, per_step=2)

    # 3. float32 gradients
    cfg32 = with_model(cfg, compute_dtype="float32", use_dropout=False)
    state, b = train_setup(cfg32, dev, seed, 16)
    iid_features(b, dev, seed)
    params = state["params"]
    auto = dataclasses.replace(cfg32.model, fused_seq_grad=False)
    reset_launches(kernel)
    kern = loss_grads(params, auto, b, ks)
    grads_launches = read_launches(kernel)
    plain = loss_grads(params, auto, b, step_mod.step)
    hand = loss_grads(params, cfg32.model, b)
    steps = b["tokens"].shape[1]
    require(grads_launches == {**dict.fromkeys(KERNELS, 0),
                               "attention_core": steps},
            f"train_autodiff_grads_f32: launches {grads_launches}")
    gaps = {"kernel_vs_plain": grad_gap(kern, plain),
            "autodiff_vs_hand_vjp": grad_gap(plain, hand)}
    emit({"phase": "train_autodiff_grads_f32", "batch": 16,
          "loss_kernel": kern[0], "loss_plain": plain[0],
          "loss_hand_vjp": hand[0], "bar": GRAD_TOL,
          "kernel_seconds": kern[2], "plain_seconds": plain[2],
          "hand_vjp_seconds": hand[2], "launches": grads_launches,
          **{name: {k: v for k, v in g.items() if k != "bad"}
             for name, g in gaps.items()}})
    for name, g in gaps.items():
        require(g["loss_rel_diff"] <= 1e-5, f"{name}: loss {g}")
        require(not g["bad"], f"{name}: gradients {g['bad']}")
    del state, b, params, kern, plain, hand
    torch.cuda.empty_cache()

    # 4. float32 scheduled sampling, kernel step against plain step
    state, b = train_setup(cfg32, dev, seed, cfg.train.batch_size)
    iid_features(b, dev, seed)
    toks, losses = {}, {}
    with torch.no_grad():
        for name, fn in (("kernel", ks), ("plain", step_mod.step)):
            gen = torch.Generator(device=dev).manual_seed(seed + 5)
            out = forward_train(state["params"], cfg32.model, b, gen,
                                train=False, ss_prob=0.25, step_fn=fn)
            toks[name] = out.logits.argmax(dim=-1)
            w = b["weight"]
            losses[name] = float((out.nll_per_example * w).sum()
                                 / w.sum().clamp_min(1.0))
    agree = float((toks["kernel"] == toks["plain"]).float().mean())
    emit({"phase": "train_autodiff_ss_f32", "batch": cfg.train.batch_size,
          "token_share": agree, "bar": 0.95, "loss_kernel": losses["kernel"],
          "loss_plain": losses["plain"],
          "loss_diff": losses["kernel"] - losses["plain"]})
    require(agree >= 0.95, f"scheduled sampling kernel vs plain: {agree}")
    del state, b, toks
    torch.cuda.empty_cache()

    # 5. fit with scheduled sampling, the profiler window and debug_nans
    m = cfg.model
    ds = synthetic_dataset(n_videos=cfg.train.batch_size,
                           captions_per_video=2, k=m.n_frames, d=m.ctx_dim,
                           maxlen=cfg.train.maxlen, seed=seed)
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(base, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=base) as root:
        trace_dir = os.path.join(root, "trace")
        fcfg = cfg.replace(train=dataclasses.replace(
            cfg.train, ss_prob=0.25, profile_dir=trace_dir,
            profile_start=1, profile_steps=1, debug_nans=True,
            save_dir=root, valid_freq=0, sample_freq=0, save_freq=0,
            disp_freq=1, length_buckets=""))
        reset_launches(kernel)
        t0 = time.perf_counter()
        result = fit(fcfg, ds, max_updates=3, device=dev)
        fit_s = time.perf_counter() - t0
        launches = read_launches(kernel)
        recs = [json.loads(ln) for ln in open(os.path.join(
            root, "metrics.jsonl")).read().splitlines()]
        traces = [f for f in os.listdir(trace_dir)
                  if f.endswith(".pt.trace.json")]
        events = (json.load(open(os.path.join(trace_dir, traces[0])))
                  ["traceEvents"] if traces else [])
        trace_mb = sum(os.path.getsize(os.path.join(trace_dir, f))
                       for f in traces) / 2 ** 20
    prof = [r for r in recs if r["kind"] == "profile"]
    losses = [r["loss"] for r in result.log]
    kernels_traced = sum(1 for e in events if e.get("cat") == "kernel")
    emit({"phase": "train_autodiff_fit", "updates": len(losses),
          "losses": losses, "fit_seconds": fit_s, "launches": launches,
          "profile_records": prof, "trace_files": len(traces),
          "trace_mb": trace_mb, "trace_events": len(events),
          "trace_device_kernels": kernels_traced,
          "anomaly_mode_after": torch.is_anomaly_enabled()})
    require(len(losses) == 3 and all(np.isfinite(losses)),
            f"train_autodiff_fit: losses {losses}")
    require(traces and len(prof) == 1 and prof[0]["first_update"] == 2,
            f"train_autodiff_fit: trace {traces}, records {prof}")
    require(launches == {**dict.fromkeys(KERNELS, 0),
                         "attention_core": 3 * cfg.train.maxlen},
            f"train_autodiff_fit: launches {launches}")
    require(not torch.is_anomaly_enabled(),
            "train_autodiff_fit: fit left the anomaly mode on")
    del result
    torch.cuda.empty_cache()
    out = {"phase": "train_autodiff",
           "ss_median_step_s": res["ss"]["median_step_s"],
           "ss_peak_mem_gib": res["ss"]["peak_mem_gib"],
           "spatial_remat_median_step_s":
               res["spatial_remat"]["median_step_s"],
           "spatial_remat_peak_mem_gib":
               res["spatial_remat"]["peak_mem_gib"],
           "ss_launches_per_update":
               res["ss"]["launches"]["attention_core"]
               / len(res["ss"]["loss_per_update"]),
           "spatial_remat_launches": res["spatial_remat"]["launches"],
           "grads_worst_rel": {k: g["worst_rel"] for k, g in gaps.items()},
           "ss_token_share": agree}
    emit(out)
    return out


def phase_train_profile(dev, seed, cfg, phase, step_fn=None) -> None:
    """Device time by kernel over one train step."""
    from torch.profiler import ProfilerActivity, profile
    from stvd_torch.train.loop import make_train_step
    state, batch = train_setup(cfg, dev, seed, cfg.train.batch_size)
    train_step = make_train_step(cfg.model, cfg.train, step_fn)
    state, m = train_step(state, batch)
    float(m["loss"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = train_step(state, batch)
        float(m["loss"])
        wall = time.perf_counter() - t0
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and not ev.key.startswith("Activity Buffer")),
                  reverse=True)
    total = sum(r[0] for r in rows)
    emit({"phase": phase, "wall_s": wall,
          "device_s": total / 1e6,
          "idle_share": 1.0 - total / 1e6 / wall if wall else None,
          "top": [{"name": k[:80], "ms": us / 1e3, "count": c}
                  for us, k, c in rows[:25]]})
    del state, batch
    torch.cuda.empty_cache()


def wrapper_cost(kernel, dev, g, cfg) -> dict:
    """Kernel 1's wrapper at the preset-3 shape called back to back:
    CUDA-event ms a call, and the host's microseconds a call (its clock
    read before the card has finished)."""
    m = cfg.model
    bc, nb, k, a, dc = (cfg.decode.decode_batch, cfg.decode.beam_size,
                        m.n_frames, m.attn_dim, m.ctx_dim)
    hp = torch.randn(bc * nb, a + 1, generator=g, device=dev)
    args = (hp[:, :a], hp[:, a],
            0.5 * torch.randn(bc, k, a, generator=g, device=dev),
            torch.randn(bc, k, dc, generator=g, device=dev).bfloat16(),
            torch.ones(bc, k, device=dev),
            torch.randn(a, generator=g, device=dev) / a ** 0.5,
            torch.tensor(0.1, device=dev), torch.tensor(-0.2, device=dev),
            True)
    call = lambda: kernel.attention_core(*args)
    return {"attention_core_ms": time_ms(call, 200),
            "attention_core_host_us": host_us(call, 200)}


def serving_only(api, kernel, step_mod, dev, g, args, cfg, cfg_q,
                 cfg_sp) -> int:
    """Worst-case (EOS suppressed) serving of preset 3, path B and path A
    with the tree ``args.root`` (or this one), on the weights of the full
    run: captions/s of the 256-video request of each; the share of
    videos on which path B's kernel step and the all-plain step agree
    (its decode batch, the full run's videos); and kernel 1's wrapper
    cost.  For a parent/change A/B run alternately in one call."""
    from stvd_torch.model.decoder import init_params
    import stvd_torch
    vocab = api.Vocab({f"w{i}": i for i in range(2, cfg.model.n_words)})
    params = init_params(
        cfg.model, torch.Generator(device=dev).manual_seed(args.seed + 1),
        dev)
    params_sp = init_params(
        cfg_sp.model,
        torch.Generator(device=dev).manual_seed(args.seed + 2), dev)
    caps, _ = decode_all(api, dev, args.seed, params, vocab, cfg_q,
                         [("kernels", kernel.step_kernels, cfg_q),
                          ("plain", step_mod.step, cfg_q)])
    out = {"int8_share_vs_plain": share(caps, "kernels", "plain"),
           **wrapper_cost(kernel, dev, g, cfg)}
    for name, c, p, expect in (
            ("preset3", cfg, params, ("attention_core", "logit_tail")),
            ("path_b", cfg_q, params, ("attention_core", "gates_lstm",
                                       "logit_tail")),
            ("path_a", cfg_sp, params_sp, ("attention_core", "spatial_core",
                                           "logit_tail"))):
        res = phase_serving(api, kernel, dev, args.seed, p, vocab, c,
                            f"serving_{name}", expect,
                            modes=("eos_suppressed",))
        n = cfg.decode.decode_batch
        out[name] = res["runs"][f"eos_suppressed_{n}"]["captions_per_s"]
    emit({"serving_ab": out, "tree": os.path.dirname(stvd_torch.__file__)})
    return 0


def kernels_only(kernel, step_mod, dev, args, cfg, cfg_q) -> int:
    """Kernel 6 (on the route the tree picks) and kernel 3 with the tree
    ``args.root`` (or this one), for a parent/change A/B in one call:
    kernel 6 at the training shape (rows 64, 37 and 128): device_ms (L2
    warm and cold), ms by events and the wrapper's host microseconds a
    call; kernel 3 bf16 and int8 at path B's shape (rows 1280) and a
    ragged 185: ms, device_ms and a digest of its outputs (h_t, c_t), to
    show them bit for bit equal between trees."""
    import hashlib
    import stvd_torch
    m = cfg.model
    dc, dim = m.ctx_dim, m.dim
    g = torch.Generator(device=dev).manual_seed(args.seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev)
    wc = (rnd(dc, 4 * dim) / dc ** 0.5).bfloat16()
    out = {"tree": os.path.dirname(stvd_torch.__file__)}
    for rows in (cfg.train.batch_size, 37, 128):
        x_pre = rnd(rows, 3, 4 * dim).transpose(0, 1)[1]
        hp = rnd(rows, 4 * dim + m.attn_dim + 1)
        a = (rnd(rows, dc), x_pre, hp[:, :4 * dim], rnd(rows, dim), wc,
             torch.bfloat16)
        call = lambda: kernel.train_tail(*a)
        out[f"train_tail_rows{rows}"] = {
            "device_ms": device_ms(call),
            "cold_device_ms": cold_device_ms(call),
            "ms": time_ms(call, 200), "host_us": host_us(call, 200)}
    m_q = cfg_q.model
    kx = m_q.dim_word + m_q.dim + m_q.ctx_dim
    g.manual_seed(args.seed + 7)
    for mode in ("bf16", "int8"):
        for n in (cfg_q.decode.decode_batch * cfg_q.decode.beam_size, 185):
            ops = gates_operands(step_mod, n, kx, dim, mode, dev, g)
            h_t, c_t = kernel.gates_lstm(*ops)
            digest = hashlib.sha256(h_t.cpu().numpy().tobytes()
                                    + c_t.cpu().numpy().tobytes())
            res = {"sha256": digest.hexdigest()[:16]}
            if n != 185:
                call = lambda: kernel.gates_lstm(*ops)
                res.update(ms=time_ms(call, 20), device_ms=device_ms(call))
            out[f"gates_{mode}_rows{n}"] = res
            del ops, h_t, c_t
    out["routes"] = read_routes(kernel)
    emit({"kernels_ab": out})
    return 0


SASS_KERNELS = {   # kernel 4's score loops, regions bf16: simple, tma nb 5
    "spatial_core_simple": r"spatial_core_kernelI13__nv_bfloat16",
    "spatial_core_tma_nb5": r"spatial_core_tmaILi5E13__nv_bfloat16"}


def phase_sass(build) -> None:
    """Static counts from ``cuobjdump -sass`` of the built library: for
    each loop (a backward branch) of the kernels of SASS_KERNELS that
    holds MUFU operations (the score passes' tanh), its instructions, its
    MUFU operations and FFMAs.  Both sides of a branch inside a loop
    count."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build.library_path())],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    instr = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)([^;]*);")
    funcs, name, labels, pending = {}, None, {}, []
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            funcs[name], labels[name] = [], {}
        elif name and re.match(r"^\s*\.L_x_\d+:", line):
            pending.append(line.strip()[:-1])
        elif name and instr.search(line):
            addr, op, rest = instr.search(line).groups()
            for label in pending:
                labels[name][label] = int(addr, 16)
            pending = []
            funcs[name].append((int(addr, 16), op.split(".")[0], rest))
    out = {}
    for key, pattern in SASS_KERNELS.items():
        (fname,) = [f for f in funcs if re.search(pattern, f)]
        code, found = funcs[fname], []
        for addr, op, rest in code:
            m = re.search(r"0x([0-9a-f]+)|`\((\.L_x_\d+)\)", rest)
            if op != "BRA" or not m:
                continue
            start = (int(m.group(1), 16) if m.group(1)
                     else labels[fname].get(m.group(2), addr + 1))
            body = [o for a, o, _ in code if start <= a <= addr]
            if start <= addr and "MUFU" in body:
                found.append({"start": hex(start), "instructions": len(body),
                              "mufu": body.count("MUFU"),
                              "ffma": body.count("FFMA")})
        require(found, f"sass: no loop with MUFU operations in {fname}")
        out[key] = sorted(found, key=lambda r: r["instructions"])
    emit({"phase": "sass", "loops": out})


# ---------------------------------------------------------------------------
# Data parallelism: two ranks on the one card over gloo
# ---------------------------------------------------------------------------

DP_RANKS = 2
DP_TIMEOUT = 600.0     # every collective, and the whole launch
DP_UPDATES = 5
DP_F32_BATCH = 16      # global batch of the float32 parity update
SPLIT_TOL = 1e-6       # per leaf: DP vs one process's update of the split


def param_digest(params) -> str:
    import hashlib
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(params[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_counts(kernel, steps, run):
    """``run()`` with this rank's kernel launches and decode steps counted
    from zero; its result, seconds (synced) and the counts."""
    reset_launches(kernel)
    steps[0] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, {"seconds": time.perf_counter() - t0,
                 "decode_steps": steps[0],
                 "launches": read_launches(kernel),
                 "launches_by_route": read_routes(kernel)}


def dp_train(kernel, mesh, dev, seed, cfg) -> dict:
    """Preset 5's update over the mesh, the float32 update against the
    single-process one, the all-reduce alone and the single-rank update
    at the per-rank batch (rank 0 alone; rank 1 waits in the next
    collective)."""
    import torch.distributed as dist
    from stvd_torch.train import parallel
    from stvd_torch.train.loop import make_train_step
    out = {}
    per = cfg.train.per_device_batch
    state, batch = train_setup(cfg, dev, seed, per * DP_RANKS)
    state = parallel.replicate(state, mesh)
    local = parallel.shard_batch(batch, mesh)
    step = make_train_step(cfg.model, cfg.train, None, mesh,
                           cfg.train.use_shard_map)
    state, m = step(state, local)               # warm-up
    first = float(m["loss"])
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernel)
    losses, secs = [], []
    for _ in range(DP_UPDATES):
        t0 = time.perf_counter()
        state, m = step(state, local)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    out["update"] = {
        "loss_warmup": first, "loss_per_update": losses,
        "seconds_per_update": secs,
        "median_update_s": float(np.median(secs)),
        "grad_norm_last": float(m["grad_norm"]),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": read_launches(kernel),
        "launches_by_route": read_routes(kernel),
        "digest": param_digest(state["params"])}
    n_params = sum(p.numel() for p in state["params"].values())
    del state, batch, local, step
    torch.cuda.empty_cache()
    flat = torch.ones(n_params, dtype=torch.float32, device=dev)
    group = mesh.get_group(parallel.DATA_AXIS)
    reduce_s = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(flat, group=group)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t0)
    out["all_reduce"] = {"floats": n_params, "bytes": 4 * n_params,
                         "seconds": reduce_s[1:],
                         "median_s": float(np.median(reduce_s[1:]))}
    del flat
    if parallel.axis_rank(mesh) == 0:
        state, batch = train_setup(cfg, dev, seed, per)
        step = make_train_step(cfg.model, cfg.train)
        state, m = step(state, batch)
        secs = []
        for _ in range(DP_UPDATES):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            float(m["loss"])
            secs.append(time.perf_counter() - t0)
        out["single_rank"] = {"batch": per, "seconds_per_update": secs,
                              "median_update_s": float(np.median(secs))}
        del state, batch, step
        torch.cuda.empty_cache()
    parallel.broadcast_value(0.0, mesh)         # rank 1 waits here
    # float32 at the preset's init: one DP update against one process's.
    # The preset's adadelta, clip and dropout: the weights against the
    # whole-batch update.  sgd at lr 1 without clip or dropout, whose
    # update is the gradient (adadelta's first step is near
    # +-sqrt(eps / 0.1) wherever |g| > 3e-3, which hides the gradient):
    # against the update of the same split in one process (grad_accum 2:
    # each half's gradient, summed, then divided), and, reported, against
    # the whole-batch update, which sums the batch in another order
    c32 = with_model(cfg, compute_dtype="float32")
    sgd = with_model(c32, use_dropout=False)
    sgd = sgd.replace(train=dataclasses.replace(
        sgd.train, optimizer="sgd", lr=1.0, clip_c=0.0))
    accum = sgd.replace(train=dataclasses.replace(sgd.train,
                                                  grad_accum=DP_RANKS))

    def update(c, m_, delta):
        state, batch = train_setup(c, dev, seed, DP_F32_BATCH)
        iid_features(batch, dev, seed)
        init = {k: v.detach().clone() for k, v in state["params"].items()}
        if m_ is not None:
            batch = parallel.shard_batch(batch, mesh)
        state, m = make_train_step(c.model, c.train, None, m_)(state, batch)
        return float(m["loss"]), {k: v.detach() - (init[k] if delta else 0)
                                  for k, v in state["params"].items()}

    def own(got, ref):
        return {k: float((got[k] - v).abs().max())
                / max(float(v.abs().max()), 1e-30) for k, v in ref.items()}

    (loss_dp, w_dp), (loss_one, w_one) = (update(c32, mesh, False),
                                          update(c32, None, False))
    gaps = leaf_gaps(w_dp, w_one)
    parity = {"global_batch": DP_F32_BATCH,
              "adadelta_loss_dp": loss_dp, "adadelta_loss_single": loss_one,
              "adadelta_loss_rel_err": abs(loss_dp - loss_one) / abs(loss_one),
              "weight_rel_err": max(gaps.values()),
              "worst_weight": max(gaps, key=gaps.get)}
    del w_dp, w_one
    (loss_dp, g_dp), (loss_acc, g_acc), (loss_one, g_one) = (
        update(sgd, mesh, True), update(accum, None, True),
        update(sgd, None, True))
    gaps = leaf_gaps(g_dp, g_acc)
    top = max(float(v.abs().max()) for v in g_one.values())
    parity.update({
        "sgd_loss_dp": loss_dp, "sgd_loss_split": loss_acc,
        "sgd_loss_single": loss_one,
        "sgd_loss_rel_err": abs(loss_dp - loss_one) / abs(loss_one),
        "grad_rel_err_vs_split": max(gaps.values()),
        "worst_grad_vs_split": max(gaps, key=gaps.get),
        "grad_bitwise_vs_split": all(torch.equal(g_dp[k], g_acc[k])
                                     for k in g_acc),
        "grad_share_of_top": {k: float(v.abs().max()) / top
                              for k, v in g_one.items()},
        "grad_rel_err_vs_whole": own(g_dp, g_one),
        "split_grad_rel_err_vs_whole": own(g_acc, g_one)})
    del g_dp, g_acc, g_one
    out["f32_parity"] = parity
    torch.cuda.empty_cache()
    return out


def dp_eval(kernel, mesh, dev, seed, cfg, params, vocab) -> dict:
    """``evaluate_split(..., mesh)`` over a 256-video split against the
    single-process ``evaluate_split``, and its tokens
    (``generate_captions(..., mesh)``) against the single-process
    decode."""
    from stvd_torch.data.bank import to_device
    from stvd_torch.data.batching import synthetic_dataset
    from stvd_torch.model.step import compute_dtype
    from stvd_torch.train.evaluate import evaluate_split, generate_captions
    m = cfg.model
    ds = dataclasses.replace(
        synthetic_dataset(n_videos=cfg.decode.decode_batch, k=m.n_frames,
                          d=m.ctx_dim, maxlen=cfg.decode.maxlen,
                          seed=seed + 3), vocab=vocab)
    steps = [0]
    step_fn = counted_step(kernel.step_kernels, steps)
    scores, rec = dp_counts(kernel, steps, lambda: evaluate_split(
        params, cfg, ds, step_fn=step_fn, mesh=mesh, device=dev))
    dev_bank = to_device(ds.bank, dev, compute_dtype(m))
    n = ds.bank.n_videos
    toks = generate_captions(params, m, dev_bank, n, cfg.decode,
                             kernel.step_kernels, mesh)
    single = generate_captions(params, m, dev_bank, n, cfg.decode,
                               kernel.step_kernels)
    scores_single = evaluate_split(params, cfg, ds,
                                   step_fn=kernel.step_kernels, device=dev)
    return {"videos": n, "scores": scores, "scores_single": scores_single,
            "equal_single_device": sum(a == b for a, b in zip(toks, single)),
            **rec}


def dp_bank(kernel, api, mesh, dev, seed, cfg, params, vocab) -> dict:
    """A 256-video bank sharded over the ranks: ``caption_ids`` of 256
    ids (decode batch 256: gathered by ``reduce_scatter_tensor``, 128
    rows decoded a rank), of 255 ids at decode batch 255 (gathered by
    ``all_reduce``, decoded whole on each rank) and ``nbest_ids``,
    against single-device Captioners at the same decode batch."""
    import dataclasses as dc
    from stvd_torch.data.bank import synthetic_bank
    m = cfg.model
    bank = synthetic_bank(cfg.decode.decode_batch, k=m.n_frames,
                          d=m.ctx_dim, seed=seed + 5)
    steps, rows = [0], set()

    def captioner(bsz, mesh_=None, counted=False):
        c = cfg.replace(decode=dc.replace(cfg.decode, decode_batch=bsz))
        inner = kernel.step_kernels
        if counted:
            def step_fn(params_, cfg_, state, *a):
                steps[0] += 1
                rows.add(int(state.h.shape[0]))
                return inner(params_, cfg_, state, *a)
            step_fn.make_logit_tail = inner.make_logit_tail
        else:
            step_fn = inner
        cap = api.Captioner(params, c, vocab, step_fn, device=dev)
        cap.attach_bank(bank, mesh=mesh_)
        return cap

    n = bank.n_videos
    ids = list(bank.ids)
    out = {"videos": n, "shard_rows": None, "routes": {}}
    beam = cfg.decode.beam_size
    for name, bsz, count in (("scatter", n, n), ("replicated", n - 1, n - 1),
                             ("nbest", n, n)):
        cap = captioner(bsz, mesh, counted=True)
        out["shard_rows"] = int(cap._bank_dev["frames"].shape[0])
        rows.clear()
        run = ((lambda: cap.nbest_ids(ids, n=beam)) if name == "nbest"
               else (lambda: cap.caption_ids(ids[:count])))
        got, rec = dp_counts(kernel, steps, run)
        ref = captioner(bsz)
        want = (ref.nbest_ids(ids, n=beam) if name == "nbest"
                else ref.caption_ids(ids[:count]))
        if name == "nbest":
            got, want = ([[t for t, _ in r] for r in x] for x in (got, want))
        out["routes"][name] = {
            "ids": count, "decode_batch": bsz,
            "rows_a_step": sorted(r // beam for r in rows),
            "equal_single_device": sum(a == b for a, b in zip(got, want)),
            "results": len(got), **rec}
    return out


def dp_cli(kernel, mesh, dev, corpus) -> dict:
    """``cli.train --config <msvd-dp on the corpus> --data-parallel`` in
    this rank (the launch's RANK / WORLD_SIZE are set), 3 updates and a
    validation round of valid and test."""
    from stvd_torch.cli import train
    from stvd_torch.config import Config
    steps = [0]
    real = kernel.step_kernels
    kernel.step_kernels = counted_step(real, steps)
    try:
        rc, rec = dp_counts(kernel, steps, lambda: train.main(
            ["--config", os.path.join(corpus, "config_dp.json"),
             "--data-parallel", "--max-updates", "3"]))
    finally:
        kernel.step_kernels = real
    with open(os.path.join(corpus, "config_dp.json")) as f:
        cfg = Config.from_json(f.read())
    return {"rc": rc, "save_dir": cfg.train.save_dir, **rec}


def dp_rank(mesh, seed, corpus) -> dict:
    """Everything one rank of the ``data_parallel`` phase runs."""
    import contextlib
    import io
    import torch.distributed as dist
    from stvd_torch import _build, api
    from stvd_torch.model import kernel
    from stvd_torch.model.decoder import init_params
    from stvd_torch.train import parallel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.lib()                   # the parent built it: this loads it
    cfg = with_model(api.preset("msvd-dp"), train_tail_kernel="on")
    vocab = api.Vocab({f"w{i}": i for i in range(2, cfg.model.n_words)})
    out = {"rank": parallel.axis_rank(mesh),
           "backend": dist.get_backend(), "device": str(dev)}
    with contextlib.redirect_stdout(io.StringIO()):
        out["train"] = dp_train(kernel, mesh, dev, seed, cfg)
        params = init_params(
            cfg.model, torch.Generator(device=dev).manual_seed(seed + 1),
            dev)
        out["eval"] = dp_eval(kernel, mesh, dev, seed, cfg, params, vocab)
        out["bank"] = dp_bank(kernel, api, mesh, dev, seed, cfg, params,
                              vocab)
        del params
        torch.cuda.empty_cache()
        out["cli"] = dp_cli(kernel, mesh, dev, corpus)
    out["modules"] = sorted(m for m in sys.modules if m in ("jax", "stvd")
                            or m.startswith(("jax.", "stvd.")))
    return out


def phase_data_parallel(kernel, dev, seed, cfg, info) -> dict:
    """Preset 5 (``msvd-dp``) at full width on 2 ranks that share the one
    card over gloo (``parallel.spawn``: spawned processes, a file store;
    NCCL refuses two ranks on one card), the kernels built by this
    process before the launch:

    a. ``make_train_step(..., mesh, use_shard_map)``, 64 captions a rank
       (128 a global batch), T 30, adadelta, clip 10, the train-scan tail
       on: a warm-up and 5 updates; the ranks' weights must agree bit for
       bit, kernel 6 launch 30 times an update on a rank, all on wgmma,
       and the loss fall; the float32 update of a global batch of 16
       (i.i.d. features, ``iid_features``, the preset's init) must equal
       the single-process update: the preset's, loss within 1e-5
       relative and each weight within GRAD_TOL of its leaf's largest
       entry (``leaf_gaps``); through sgd at lr 1 without dropout, each
       gradient within SPLIT_TOL of the single-process update of the
       same split (``grad_accum`` 2), its gaps to the whole-batch
       gradient reported;
       ``cli.train --data-parallel`` on a corpus on disk for 3 updates
       and one validation round;
    b. ``evaluate_split(..., mesh)`` of 256 videos;
    c. a 256-video bank sharded over the ranks: ``caption_ids`` of 256
       ids (scattered) and 255 (replicated), ``nbest_ids``.

    Every caption and n-best list, and the metrics, must equal the
    single-device decode at the same decode batch (256 rows, 255 on the
    replicated route); kernels 1 and 2 launch once a decode step on a rank,
    on cluster / wgmma, the others not at all.  The times are of two
    ranks sharing one card over gloo: no scaling figure."""
    from stvd_torch.train import parallel
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(base, exist_ok=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=base) as corpus:
        c = with_model(cfg, train_tail_kernel="on")
        write_corpus(corpus, c, seed)
        c = c.replace(
            train=dataclasses.replace(
                c.train, metric="meteor", valid_freq=3, sample_freq=0,
                disp_freq=1, save_dir=os.path.join(corpus, "run")),
            data=dataclasses.replace(
                c.data, dataset="youtube2text", data_dir=corpus,
                feature_file="feats.npz", captions_file="captions.json",
                vocab_file="vocab.pkl"))
        with open(os.path.join(corpus, "config_dp.json"), "w") as f:
            f.write(c.to_json())
        t0 = time.perf_counter()
        ranks = parallel.spawn(dp_rank, DP_RANKS, (seed, corpus),
                               device="cuda:0", backend="gloo",
                               timeout=DP_TIMEOUT)
        wall = time.perf_counter() - t0
        files = sorted(os.listdir(os.path.join(corpus, "run")))
        records = [json.loads(ln)["kind"] for ln in open(
            os.path.join(corpus, "run", "metrics.jsonl"))]
    T = cfg.train.maxlen
    for r in ranks:
        require(r["backend"] == "gloo", f"rank backend {r['backend']}")
        require(r["modules"] == [], f"a rank imported {r['modules']}")
        tr = r["train"]
        s = tr["update"]
        want = {k: 0 for k in KERNELS}
        want["train_tail"] = DP_UPDATES * T
        require(s["launches"] == want,
                f"dp update: launches {s['launches']} != {want}")
        require(s["launches_by_route"]["train_tail"]["wgmma"]
                == want["train_tail"], "dp update: train tail routes "
                f"{s['launches_by_route']['train_tail']}")
        losses = [s["loss_warmup"]] + s["loss_per_update"]
        require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                f"dp update: loss {losses}")
        require(s["digest"] == ranks[0]["train"]["update"]["digest"],
                "dp update: the ranks' weights differ")
        p = tr["f32_parity"]
        require(p["adadelta_loss_rel_err"] <= 1e-5
                and p["sgd_loss_rel_err"] <= 1e-5
                and p["weight_rel_err"] <= GRAD_TOL
                and p["grad_rel_err_vs_split"] <= SPLIT_TOL,
                f"dp float32 update vs single-process: {p}")
        for name, sub in (("eval", r["eval"]),
                          *(("bank " + k, v) for k, v in
                            r["bank"]["routes"].items()),
                          ("cli", r["cli"])):
            want = {k: 0 for k in KERNELS}
            want.update(attention_core=sub["decode_steps"],
                        logit_tail=sub["decode_steps"])
            if name == "cli":
                want["train_tail"] = sub["launches"]["train_tail"]
                require(sub["launches"]["train_tail"] > 0
                        and sub["launches_by_route"]["train_tail"]["wgmma"]
                        == want["train_tail"], f"dp cli: train tail "
                        f"{sub['launches_by_route']['train_tail']}")
            require(sub["decode_steps"] > 0 and sub["launches"] == want,
                    f"dp {name}: launches {sub['launches']} != {want}")
            for k, route in SERVING_ROUTES.items():
                require(sub["launches_by_route"][k][route] == want[k],
                        f"dp {name}: {k} routes "
                        f"{sub['launches_by_route'][k]}")
        ev = r["eval"]
        require(ev["equal_single_device"] == ev["videos"],
                f"dp eval: {ev['equal_single_device']} of {ev['videos']} "
                "captions equal the single-process decode")
        require(ev["scores"] == ev["scores_single"],
                f"dp eval scores {ev['scores']} != {ev['scores_single']}")
        for name, sub in r["bank"]["routes"].items():
            require(sub["equal_single_device"] == sub["results"]
                    == sub["ids"], f"dp bank {name}: "
                    f"{sub['equal_single_device']} of {sub['ids']} equal "
                    "single-device")
        require(r["bank"]["shard_rows"] == 256 // DP_RANKS,
                f"dp bank: a rank holds {r['bank']['shard_rows']} rows")
        require(r["cli"]["rc"] == 0, "dp cli.train failed")
    require({"config.json", "vocab.pkl", "ckpt.pt", "ckpt_best.pt",
             "metrics.jsonl", "valid_samples.json"} <= set(files),
            f"dp cli run dir {files}")
    require(records.count("train") == 3 and records.count("valid") == 1,
            f"dp cli records {records}")
    r0 = ranks[0]
    routes = r0["bank"]["routes"]
    require(routes["scatter"]["rows_a_step"] == [256 // DP_RANKS]
            and routes["replicated"]["rows_a_step"] == [255],
            f"dp bank: rows a decode step {routes}")
    out = {"phase": "data_parallel", "card": info["nvidia_smi"],
           "setting": f"{DP_RANKS} ranks sharing one card over gloo "
                      "(no scaling figure)",
           "launch_seconds": wall, "ranks": ranks}
    emit(out)
    return out


TP_MODEL = 2           # the model axis of the one-card TP phase
TP_TIMEOUT = 600.0     # every collective, and the whole launch
TP_UPDATES = 5
TP_F32_BATCH = 16      # float32 parity: preset 3 (preset 2 at 8)
TP_SHARE = 0.95        # the path-parity bar: the CLI run's valid captions
TP_NUDGE = 1e-7        # float32 noise on the gates bias: the decode's floor
TP_SHARE_SLACK = 0.05  # bf16 TP share vs the nudged share (~2.5 std, n 256)
TP_VS_DP = 2.0         # bf16 weights: TP's worst leaf gap vs the DP order's


def tp_param_bytes(cfg, mesh, params) -> dict:
    """The parameter bytes a rank holds, reckoned from ``TP_RULES`` on the
    full shapes (a sharded leaf's 1/M, a replicated leaf whole), beside
    the bytes of the rank's own leaves: the two must agree."""
    from stvd_torch.model.decoder import init_params
    from stvd_torch.train import parallel
    m = parallel.model_axis_size(mesh)
    layout = parallel.param_shardings(cfg.model, mesh)
    full = {k: tuple(v.shape) for k, v in init_params(
        cfg.model, torch.Generator(), "meta").items()}
    reckoned = sum(int(np.prod(s)) * 4 // (m if layout[k] is not None else 1)
                   for k, s in full.items())
    held = sum(p.numel() * p.element_size() for p in params.values())
    whole = sum(int(np.prod(s)) * 4 for s in full.values())
    return {"reckoned": reckoned, "held": held, "whole": whole,
            "share": held / whole}


def replicated_digest(params, layout) -> str:
    return param_digest({k: v for k, v in params.items()
                         if layout[k] is None})


def tp_updates(kernel, mesh, dev, seed, cfg, batch, updates) -> tuple:
    """``updates`` TP updates after a warm-up on one batch of ``batch``
    captions (split over the data axis) from the preset's init: the
    sharded state, its layout, losses, seconds and launches."""
    from stvd_torch.train import parallel
    from stvd_torch.train.loop import make_train_step
    full, b = train_setup(cfg, dev, seed, batch)
    layout = parallel.state_shardings(full, mesh)
    state = parallel.shard_state(full, mesh)
    del full
    local = parallel.shard_batch(b, mesh)
    step = make_train_step(cfg.model, cfg.train, None, mesh)
    state, m = step(state, local)                # warm-up
    first = float(m["loss"])
    torch.cuda.reset_peak_memory_stats()
    reset_launches(kernel)
    losses, secs = [], []
    for _ in range(updates):
        t0 = time.perf_counter()
        state, m = step(state, local)
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    rec = {"batch": batch, "steps_T": int(b["tokens"].shape[1]),
           "loss_warmup": first, "loss_per_update": losses,
           "seconds_per_update": secs,
           "median_update_s": float(np.median(secs)),
           "grad_norm_last": float(m["grad_norm"]),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": read_launches(kernel),
           "launches_by_route": read_routes(kernel)}
    return state, layout, rec


def single_updates(dev, seed, cfg, batch, updates, f32=False) -> tuple:
    """The same updates (warm-up included) in one process; their
    seconds after the warm-up."""
    from stvd_torch.train.loop import make_train_step
    state, b = train_setup(cfg, dev, seed, batch)
    if f32:
        iid_features(b, dev, seed)
    step = make_train_step(cfg.model, cfg.train)
    secs, loss = [], None
    for i in range(updates + 1):
        t0 = time.perf_counter()
        state, m = step(state, b)
        loss = float(m["loss"])
        if i:
            secs.append(time.perf_counter() - t0)
    return state, loss, secs


def tp_f32_parity(mesh, dev, seed, cfg, batch, updates=1) -> dict:
    """``updates`` float32 TP updates from the preset's init (i.i.d.
    features) against the single-process ones: the last loss's relative
    gap and ``leaf_gaps`` of the weights (rank 0 alone runs the single
    process; every other rank waits in the next collective)."""
    from stvd_torch.train import parallel
    from stvd_torch.train.loop import make_train_step
    full, b = train_setup(cfg, dev, seed, batch)
    iid_features(b, dev, seed)
    layout = parallel.state_shardings(full, mesh)
    state = parallel.shard_state(full, mesh)
    del full
    step = make_train_step(cfg.model, cfg.train, None, mesh)
    local = parallel.shard_batch(b, mesh)
    for _ in range(updates):
        state, m = step(state, local)
    loss_tp = float(m["loss"])
    whole = parallel.gather_state(state, mesh, layout)["params"]
    del state, local
    out = {"batch": batch, "updates": updates, "loss_tp": loss_tp}
    if parallel.is_first_rank(mesh):
        one, loss_one, _ = single_updates(dev, seed, cfg, batch,
                                          updates - 1, True)
        gaps = leaf_gaps({k: v.detach() for k, v in whole.items()},
                         {k: v.detach() for k, v in one["params"].items()})
        out.update(loss_single=loss_one,
                   loss_rel_err=abs(loss_tp - loss_one) / abs(loss_one),
                   weight_rel_err=max(gaps.values()),
                   worst_weight=max(gaps, key=gaps.get), gaps=gaps)
        del one
    parallel.broadcast_value(0.0, mesh)          # the others wait here
    torch.cuda.empty_cache()
    return out


def tp_train(kernel, mesh, dev, seed, cfg, updates, f32_batch,
             data_mesh=None) -> dict:
    """The preset's TP update at batch 64 (``updates`` after a warm-up),
    its gathered weights against the single-process run of the same
    updates (``leaf_gaps``), its replicated leaves' digest, its parameter
    bytes, and the float32 parity update."""
    from stvd_torch.train import parallel
    state, layout, rec = tp_updates(kernel, mesh, dev, seed, cfg,
                                    cfg.train.batch_size, updates)
    rec["param_bytes"] = tp_param_bytes(cfg, mesh, state["params"])
    rec["replicated_digest"] = replicated_digest(state["params"],
                                                 layout["params"])
    rec["local_shapes"] = {k: list(v.shape) for k, v in
                           state["params"].items()
                           if layout["params"][k] is not None}
    whole = parallel.gather_state(state, mesh, layout)["params"]
    del state
    torch.cuda.empty_cache()
    one = None
    if parallel.is_first_rank(mesh):
        one, _, secs = single_updates(dev, seed, cfg, cfg.train.batch_size,
                                      updates)
        gaps = leaf_gaps({k: v.detach() for k, v in whole.items()},
                         {k: v.detach() for k, v in one["params"].items()})
        rec["single_process"] = {
            "seconds_per_update": secs,
            "median_update_s": float(np.median(secs)),
            "weight_rel_err": max(gaps.values()),
            "worst_weight": max(gaps, key=gaps.get), "gaps": gaps}
    del whole
    parallel.broadcast_value(0.0, mesh)
    torch.cuda.empty_cache()
    if data_mesh is not None:
        # the same updates data-parallel over the same ranks (the batch
        # halved, the gradients summed, the same dropout masks): another
        # order of the same float32 sums, whose distance from one process
        # is the yardstick of the TP weights' after the bf16 updates
        from stvd_torch.train.loop import make_train_step
        state, b = train_setup(cfg, dev, seed, cfg.train.batch_size)
        step = make_train_step(cfg.model, cfg.train, None, data_mesh)
        local = parallel.shard_batch(b, data_mesh)
        for _ in range(updates + 1):
            state, m = step(state, local)
        float(m["loss"])
        if one is not None:
            dgaps = leaf_gaps({k: v.detach() for k, v in
                               state["params"].items()},
                              {k: v.detach() for k, v in
                               one["params"].items()})
            rec["single_process"].update(
                dp_weight_rel_err=max(dgaps.values()),
                dp_worst_weight=max(dgaps, key=dgaps.get), dp_gaps=dgaps)
        del state, b, local, step
    del one
    torch.cuda.empty_cache()
    c32 = with_model(cfg, compute_dtype="float32")
    rec["f32_parity"] = tp_f32_parity(mesh, dev, seed, c32, f32_batch)
    return rec


def tp_decode(kernel, mesh, dev, seed, runs) -> dict:
    """For each (name, config, videos) of ``runs``: the TP beam decode of
    the videos (EOS suppressed, every caption runs all maxlen steps)
    through ``make_tp_beam_decode(tail='auto')`` and through
    ``generate_captions(..., mesh)``, each with its launches counted from
    zero, against the single-device kernel decode (share of equal
    captions, on rank 0)."""
    from stvd_torch.data.bank import synthetic_bank, to_device
    from stvd_torch.decode import parallel as dparallel
    from stvd_torch.decode.beam import beam_decode
    from stvd_torch.model.decoder import init_params
    from stvd_torch.model.step import compute_dtype
    from stvd_torch.train import parallel
    from stvd_torch.train.evaluate import generate_captions
    out = {}
    for name, c, n in runs:
        m = c.model
        full = eos_weights(init_params(
            m, torch.Generator(device=dev).manual_seed(seed + 1), dev),
            "eos_suppressed")
        bank = to_device(synthetic_bank(n, k=m.n_frames, d=m.ctx_dim,
                                        seed=seed + 9), dev,
                         compute_dtype(m))
        p = dparallel.shard_decode_params(full, mesh)
        mine = parallel.shard_batch(bank, mesh)
        d = c.decode
        steps = [0]
        step_fn = counted_step(kernel.step_kernels, steps)
        run = dparallel.make_tp_beam_decode(
            m, mesh, d.beam_size, d.maxlen, d.length_norm, tail="auto",
            step_fn=step_fn)
        with torch.no_grad():
            res, rec = dp_counts(kernel, steps, lambda: run(p, mine))
            dcfg = dataclasses.replace(d, decode_batch=n)
            gen, gen_rec = dp_counts(kernel, steps, lambda: generate_captions(
                p, m, bank, n, dcfg, step_fn, mesh))
            toks = parallel.all_gather_rows(res.tokens, mesh)
            single = nudged = None
            if parallel.is_first_rank(mesh):
                single = beam_decode(full, m, bank, d.beam_size, d.maxlen,
                                     d.length_norm,
                                     step_fn=kernel.step_kernels).tokens
                # the floor: the same decode with the gates bias moved by
                # float32 noise of the size of a reorder's rounding
                gen_b = torch.Generator(device=dev).manual_seed(seed + 5)
                nudged = beam_decode(
                    dict(full, b=full["b"] + TP_NUDGE * torch.randn(
                        full["b"].shape, generator=gen_b, device=dev)),
                    m, bank, d.beam_size, d.maxlen, d.length_norm,
                    step_fn=kernel.step_kernels).tokens
        rows = toks.cpu().numpy().tolist()
        rec.update(videos=n, rows=int(mine["frames"].shape[0]) * d.beam_size,
                   tail_shape=[int(mine["frames"].shape[0]) * d.beam_size,
                               int(p["ff_logit_W"].shape[0]),
                               int(p["ff_logit_W"].shape[1])],
                   tokens_digest=param_digest({"t": toks}),
                   generate_captions_equal=rows == gen,
                   generate_captions=gen_rec)
        if single is not None:
            want = single.cpu().numpy().tolist()
            rec["share_vs_single_device"] = float(np.mean(
                [a == b for a, b in zip(rows, want)]))
            rec["nudged_share"] = float(np.mean(
                [a == b for a, b in zip(nudged.cpu().numpy().tolist(),
                                        want)]))
        parallel.broadcast_value(0.0, mesh)
        out[name] = rec
        del full, p, bank, mine, res, toks, single, nudged
        torch.cuda.empty_cache()
    return out


def tp_cli(kernel, mesh, dev, corpus) -> dict:
    """``cli.train --config <preset 3 float32 on the corpus>
    --model-parallel 2`` on this rank: 3 updates and a validation round;
    on rank 0 its ``ckpt.pt`` loaded in one process decodes the valid
    split to the run's valid samples."""
    from stvd_torch.cli import train
    from stvd_torch.config import Config
    from stvd_torch.data.corpus import load_splits
    from stvd_torch.model.convert import params_from_numpy
    from stvd_torch.train import parallel
    from stvd_torch.train.evaluate import evaluate_split
    steps = [0]
    real = kernel.step_kernels
    kernel.step_kernels = counted_step(real, steps)
    try:
        rc, rec = dp_counts(kernel, steps, lambda: train.main(
            ["--config", os.path.join(corpus, "config_tp.json"),
             "--model-parallel", str(TP_MODEL), "--max-updates", "3"]))
    finally:
        kernel.step_kernels = real
    with open(os.path.join(corpus, "config_tp.json")) as f:
        cfg = Config.from_json(f.read())
    rec.update(rc=rc, save_dir=cfg.train.save_dir)
    if parallel.is_first_rank(mesh):
        run = cfg.train.save_dir
        blob = torch.load(os.path.join(run, "ckpt.pt"), weights_only=True)
        params = params_from_numpy({k: v.numpy() for k, v in
                                    blob["params"].items()}, dev)
        rec["ckpt_full_width"] = (
            tuple(blob["params"]["U"].shape) == (cfg.model.dim,
                                                 4 * cfg.model.dim)
            and tuple(blob["params"]["ff_logit_W"].shape)
            == (cfg.model.dim_word, cfg.model.n_words))
        with open(os.path.join(run, "valid_samples.json")) as f:
            tp_caps = {d["image_id"]: d["caption"] for d in json.load(f)}
        one = os.path.join(corpus, "one_process")
        evaluate_split(params, cfg, load_splits(cfg)["valid"], "valid",
                       one, step_fn=real, device=dev)
        with open(os.path.join(one, "valid_samples.json")) as f:
            one_caps = {d["image_id"]: d["caption"] for d in json.load(f)}
        rec["valid_captions"] = len(tp_caps)
        rec["valid_equal_one_process"] = sum(
            tp_caps[k] == one_caps.get(k) for k in tp_caps)
    parallel.broadcast_value(0.0, mesh)
    return rec


def tp_rank(mesh1, seed, corpus) -> dict:
    """Everything one rank of the 1 x 2 mesh of ``tensor_parallel`` runs."""
    import contextlib
    import io
    import torch.distributed as dist
    from stvd_torch import _build, api
    from stvd_torch.model import kernel
    from stvd_torch.train import parallel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.lib()                   # the parent built it: this loads it
    mesh = parallel.make_mesh_2d("cuda", model_parallel=TP_MODEL)
    cfg = with_model(api.preset(NAME), train_tail_kernel="off")
    cfg_sp = api.preset(SPATIAL)
    out = {"rank": dist.get_rank(), "model_rank": parallel.model_rank(mesh),
           "backend": dist.get_backend(), "device": str(dev)}
    with contextlib.redirect_stdout(io.StringIO()):
        out["train"] = tp_train(kernel, mesh, dev, seed, cfg, TP_UPDATES,
                                TP_F32_BATCH, data_mesh=mesh1)
        out["train_spatial"] = tp_train(kernel, mesh, dev, seed, cfg_sp, 2,
                                        TP_F32_BATCH // 2)
        out["decode"] = tp_decode(kernel, mesh, dev, seed, (
            ("bf16", cfg, cfg.decode.decode_batch),
            ("f32", with_model(cfg, compute_dtype="float32"), 64)))
        out["cli"] = tp_cli(kernel, mesh, dev, corpus)
    out["modules"] = sorted(m for m in sys.modules if m in ("jax", "stvd")
                            or m.startswith(("jax.", "stvd.")))
    return out


def tp_rank_2x2(mesh1, seed) -> dict:
    """A rank of the 2 x 2 mesh: 2 float32 updates at batch 16 against
    one process's, and a 64-video float32 decode against the
    single-device decode."""
    import contextlib
    import io
    from stvd_torch import _build, api
    from stvd_torch.model import kernel
    from stvd_torch.train import parallel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.lib()
    mesh = parallel.make_mesh_2d("cuda", model_parallel=TP_MODEL)
    c32 = with_model(api.preset(NAME), compute_dtype="float32")
    out = {"data_rank": parallel.axis_rank(mesh),
           "model_rank": parallel.model_rank(mesh)}
    with contextlib.redirect_stdout(io.StringIO()):
        out["train_f32"] = tp_f32_parity(mesh, dev, seed, c32,
                                         TP_F32_BATCH, 2)
        out["decode_f32"] = tp_decode(kernel, mesh, dev, seed,
                                      (("f32", c32, 64),))["f32"]
    return out


def phase_tensor_parallel(kernel, dev, seed, info) -> dict:
    """Tensor parallelism at full width (preset 3: dim 3584, dim_word 512,
    ctx = attn 1024, K 28, vocab 13056, bf16) on ranks that share the one
    card over gloo (``parallel.spawn``: NCCL refuses two ranks on one
    card), the kernels built by this process before the launch.  On a
    1 x 2 (data x model) mesh:

    a. preset 3's TP update, batch 64, T 30, adadelta, clip 10, the hand
       VJP (the train-scan tail off, as a model axis requires): a
       warm-up and 5 updates, the replicated leaves bitwise equal on the
       ranks, the rank's parameter bytes as ``TP_RULES`` reckon them;
       the gathered bf16 weights against the single-process run of the
       same updates, held to TP_VS_DP times the gap of the same updates
       data-parallel over the same ranks (another order of the same
       float32 sums, which bf16 casts and adadelta's first steps amplify
       to ~2e-2 of a zero-init bias: GRAD_TOL cannot hold there); one
       float32 update at batch 16 against one process's (loss within
       1e-5 relative, ``leaf_gaps`` of the weights within GRAD_TOL);
    b. preset 2's (2 updates): kernel 5 30 times an update on each rank,
       kernel 7 once on the rank's Dr / 2 = 512 rows of Ws_att, the
       float32 update at batch 8 against one process's;
    c. preset 3's TP beam decode of 256 videos (beam 5, EOS suppressed)
       through ``make_tp_beam_decode(tail='auto')`` and
       ``generate_captions(..., mesh)``: kernel 2 once a step on each rank
       on the (1280, 512) x (512, 6528) vocab shard, route wgmma, kernel
       1 once a step on cluster, the ranks' tokens bitwise equal; the
       share of captions equal to the single-device kernel decode at
       least the share of that decode with its gates bias moved by
       TP_NUDGE of float32 noise (the floor any reorder of a sum meets on
       random weights, ~0.88 at bf16), less TP_SHARE_SLACK; every caption
       at float32 on 64 videos;
    e. ``cli.train --model-parallel 2`` (preset 3 float32 on a corpus on
       disk): 3 updates and a validation round; its ``ckpt.pt`` holds the
       full-width weights and, loaded in one process, decodes at least
       TP_SHARE of the valid split to the run's captions.

    Then (d) a 2 x 2 mesh of 4 ranks: 2 float32 updates at batch 16 and a
    64-video float32 decode against one process's.  The times are of
    ranks sharing one card over gloo: no scaling figure."""
    from stvd_torch import api
    from stvd_torch.train import parallel
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(base, exist_ok=True)
    torch.cuda.empty_cache()
    cfg = api.preset(NAME)
    with tempfile.TemporaryDirectory(dir=base) as corpus:
        c = with_model(cfg, compute_dtype="float32")
        write_corpus(corpus, c, seed)
        c = c.replace(
            train=dataclasses.replace(
                c.train, metric="meteor", valid_freq=3, sample_freq=0,
                disp_freq=1, save_dir=os.path.join(corpus, "run")),
            data=dataclasses.replace(
                c.data, dataset="youtube2text", data_dir=corpus,
                feature_file="feats.npz", captions_file="captions.json",
                vocab_file="vocab.pkl"))
        with open(os.path.join(corpus, "config_tp.json"), "w") as f:
            f.write(c.to_json())
        t0 = time.perf_counter()
        ranks = parallel.spawn(tp_rank, TP_MODEL, (seed, corpus),
                               device="cuda:0", backend="gloo",
                               timeout=TP_TIMEOUT)
        wall = time.perf_counter() - t0
        files = sorted(os.listdir(os.path.join(corpus, "run")))
        records = [json.loads(ln)["kind"] for ln in open(
            os.path.join(corpus, "run", "metrics.jsonl"))]
    t0 = time.perf_counter()
    ranks_2x2 = parallel.spawn(tp_rank_2x2, 2 * TP_MODEL, (seed,),
                               device="cuda:0", backend="gloo",
                               timeout=TP_TIMEOUT)
    wall_2x2 = time.perf_counter() - t0
    out = {"phase": "tensor_parallel", "card": info["nvidia_smi"],
           "setting": f"ranks sharing one card over gloo, meshes 1 x "
                      f"{TP_MODEL} and 2 x {TP_MODEL} (no scaling figure)",
           "launch_seconds": wall, "launch_seconds_2x2": wall_2x2,
           "ranks": ranks, "ranks_2x2": ranks_2x2}
    # the record first: a failed check below still leaves its numbers
    emit(out)
    none = {k: 0 for k in KERNELS}
    r0 = ranks[0]
    for r in ranks:
        require(r["backend"] == "gloo", f"rank backend {r['backend']}")
        require(r["modules"] == [], f"a rank imported {r['modules']}")
        for name in ("train", "train_spatial"):
            s = r[name]
            want = dict(none)
            if name == "train_spatial":
                n_up = len(s["loss_per_update"])
                want.update(spatial_bwd=n_up * s["steps_T"], dws_gemm=n_up)
                require(s["launches_by_route"]["dws_gemm"]["wgmma"] == n_up
                        and s["local_shapes"]["Ws_att"] == [512, 1024],
                        f"tp {name}: kernel 7 on {s['local_shapes']['Ws_att']}"
                        f" by route {s['launches_by_route']['dws_gemm']}")
            require(s["launches"] == want,
                    f"tp {name}: launches {s['launches']} != {want}")
            losses = [s["loss_warmup"]] + s["loss_per_update"]
            require(all(np.isfinite(losses)) and losses[-1] < losses[0],
                    f"tp {name}: loss {losses}")
            require(s["replicated_digest"] == r0[name]["replicated_digest"],
                    f"tp {name}: the ranks' replicated leaves differ")
            pb = s["param_bytes"]
            require(pb["reckoned"] == pb["held"],
                    f"tp {name}: parameter bytes {pb}")
        dec = r["decode"]
        for name, sub in dec.items():
            steps = sub["decode_steps"]
            want = dict(none, attention_core=steps, logit_tail=steps)
            require(steps == cfg.decode.maxlen and sub["launches"] == want,
                    f"tp decode {name}: launches {sub['launches']} != {want}")
            gen = sub["generate_captions"]
            require(gen["launches"] == dict(none, attention_core=steps,
                                            logit_tail=steps)
                    and gen["decode_steps"] == steps,
                    f"tp decode {name} generate_captions: {gen}")
            route = {"bf16": "wgmma", "f32": "f32"}[name]
            require(sub["launches_by_route"]["logit_tail"][route] == steps
                    and sub["launches_by_route"]["attention_core"]["cluster"]
                    == steps, f"tp decode {name}: routes "
                    f"{sub['launches_by_route']}")
            require(sub["tokens_digest"] == r0["decode"][name]["tokens_digest"]
                    and sub["generate_captions_equal"],
                    f"tp decode {name}: the ranks' tokens differ")
        require(dec["bf16"]["tail_shape"] == [1280, 512, 6528],
                f"tp decode: kernel 2 on {dec['bf16']['tail_shape']}")
        cli = r["cli"]
        require(cli["rc"] == 0, "tp cli.train failed")
        want = dict(none, attention_core=cli["decode_steps"],
                    logit_tail=cli["decode_steps"])
        require(cli["decode_steps"] > 0 and cli["launches"] == want,
                f"tp cli: launches {cli['launches']} != {want}")
    s = r0["train"]["single_process"]
    require(s["weight_rel_err"] <= TP_VS_DP * s["dp_weight_rel_err"],
            f"tp update vs single-process, beside the DP order's: {s}")
    for name in ("train", "train_spatial"):
        p = r0[name]["f32_parity"]
        require(p["loss_rel_err"] <= 1e-5 and p["weight_rel_err"] <= GRAD_TOL,
                f"tp {name} float32 update vs single-process: {p}")
    dec = r0["decode"]
    require(dec["bf16"]["share_vs_single_device"]
            >= dec["bf16"]["nudged_share"] - TP_SHARE_SLACK
            and dec["f32"]["share_vs_single_device"] == 1.0,
            "tp decode vs single-device: "
            + str({k: (v["share_vs_single_device"], v["nudged_share"])
                   for k, v in dec.items()}))
    cli = r0["cli"]
    require(cli["ckpt_full_width"] and cli["valid_captions"] > 0
            and cli["valid_equal_one_process"]
            >= TP_SHARE * cli["valid_captions"],
            f"tp cli checkpoint in one process: {cli}")
    require({"config.json", "vocab.pkl", "ckpt.pt", "ckpt_best.pt",
             "metrics.jsonl", "valid_samples.json"} <= set(files),
            f"tp cli run dir {files}")
    require(records.count("train") == 3 and records.count("valid") == 1,
            f"tp cli records {records}")
    q0 = ranks_2x2[0]
    require(q0["train_f32"]["loss_rel_err"] <= 1e-5
            and q0["train_f32"]["weight_rel_err"] <= GRAD_TOL,
            "tp 2x2 float32 updates vs single-process: "
            + str({k: v for k, v in q0["train_f32"].items() if k != "gaps"}))
    require(q0["decode_f32"]["share_vs_single_device"] == 1.0,
            f"tp 2x2 decode: {q0['decode_f32']}")
    for q in ranks_2x2:
        mate = ranks_2x2[q["data_rank"] * TP_MODEL]["decode_f32"]
        require(q["decode_f32"]["tokens_digest"] == mate["tokens_digest"],
                "tp 2x2 decode: a model group's tokens differ")
    return out


# ---------------------------------------------------------------------------
# Sharded serving: sharded artifacts, the multi-rank daemon, int8 on a mesh
# ---------------------------------------------------------------------------

SS_RANKS = 2           # the data or model axis of the one-card phase
SS_TIMEOUT = 900.0     # every collective, and the whole launch
SS_NBEST = 16          # ids of the n-best requests
SS_2X4 = (2, 4)        # MULTICHIP_r05.json's TP mesh (data x model)


def ss_files(root, cfg, params, swap, vocab, seed) -> dict:
    """What the entry points read: a run directory (config.json,
    ckpt.pt, vocab.pkl) of preset 3; a 256-video bank file; the swap
    weights; and a request's 16 videos, K frames each (zeros after a
    short video's own)."""
    from stvd_torch.data.bank import synthetic_bank
    m = cfg.model
    paths = {"run": os.path.join(root, "run")}
    os.makedirs(paths["run"])
    with open(os.path.join(paths["run"], "config.json"), "w") as f:
        f.write(cfg.to_json())
    torch.save({"params": {k: v.detach().cpu() for k, v in params.items()}},
               os.path.join(paths["run"], "ckpt.pt"))
    vocab.save_pickle(os.path.join(paths["run"], "vocab.pkl"))
    bank = synthetic_bank(cfg.decode.decode_batch, k=m.n_frames,
                          d=m.ctx_dim, seed=seed + 9)
    paths["bank"] = os.path.join(root, "bank.npz")
    bank.save(paths["bank"])
    paths["swap"] = os.path.join(root, "swap.npz")
    np.savez(paths["swap"], **{k: v.detach().float().cpu().numpy()
                               for k, v in swap.items()})
    feats = request(np.random.RandomState(seed + 4), SS_NBEST, m)
    paths["arr"] = np.stack([np.pad(f[:m.n_frames],
                                    ((0, m.n_frames - len(f[:m.n_frames])),
                                     (0, 0))) for f in feats])
    return paths


def ss_http(port, method, path, body=None, timeout=600.0):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def ss_client(ports, ids, files, box) -> None:
    """The requests of both daemons (a thread of this process while the
    ranks run): each waits for /healthz, then its requests are timed by
    this client's clock."""
    from stvd_torch.cli import serve

    def up(port):
        deadline = time.monotonic() + SS_TIMEOUT
        while time.monotonic() < deadline:
            try:
                if ss_http(port, "GET", "/healthz", timeout=5)[0] == 200:
                    return
            except OSError:
                pass
            time.sleep(0.5)
        raise TimeoutError(f"no daemon on port {port}")

    def timed(res, name, fn):
        t0 = time.perf_counter()
        out = fn()
        res[name] = {"seconds": time.perf_counter() - t0, "reply": out}

    try:
        live, dp = {}, {}
        up(ports[0])
        timed(live, "caption_ids_256", lambda: ss_http(
            ports[0], "POST", "/caption_ids", {"ids": ids}))
        timed(live, "caption_ids_255", lambda: ss_http(
            ports[0], "POST", "/caption_ids", {"ids": ids[:255]}))
        timed(live, "nbest_ids_16", lambda: ss_http(
            ports[0], "POST", "/nbest_ids?n=5", {"ids": ids[:SS_NBEST]}))
        timed(live, "unknown_id", lambda: ss_http(
            ports[0], "POST", "/caption_ids", {"ids": [ids[0], "nope"]}))
        timed(live, "swap_params", lambda: ss_http(
            ports[0], "POST", "/swap_params", {"path": files["swap"]}))
        timed(live, "swapped_ids_256", lambda: ss_http(
            ports[0], "POST", "/caption_ids", {"ids": ids}))
        timed(live, "shutdown", lambda: ss_http(ports[0], "POST",
                                                "/shutdown"))
        up(ports[1])
        timed(dp, "caption_ids_256", lambda: ss_http(
            ports[1], "POST", "/caption_ids", {"ids": ids}))
        timed(dp, "nbest_ids_16", lambda: ss_http(
            ports[1], "POST", "/nbest_ids?n=5", {"ids": ids[:SS_NBEST]}))
        timed(dp, "caption_16", lambda: serve.request_captions(
            "127.0.0.1", ports[1], files["arr"], timeout=600.0))
        timed(dp, "manifest", lambda: ss_http(ports[1], "GET", "/manifest"))
        timed(dp, "shutdown", lambda: ss_http(ports[1], "POST", "/shutdown"))
        box["live"], box["dp"] = live, dp
    except BaseException as e:          # raised again by the phase
        box["error"] = e


def ss_captions(vocab, toks) -> list:
    return [" ".join(vocab.decode(r)) for r in toks.cpu().numpy()]


def ss_int8_gates_exact(mesh, dev, seed, m, full, part) -> dict:
    """The W8A8 preactivation of 1280 rows at full width under the model
    axis (``step._int8_gates_sharded``: this rank's int8 rows of [W; U;
    Wc] on the whole stack's grid, the int32 partial sums reduced as
    int32) against one device's: bit for bit; and the int32 reduce's
    seconds (gloo, host clock, median of 5)."""
    import types
    from stvd_torch.model import step as step_mod
    from stvd_torch.model import tp
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    rows, cd = 1280, step_mod.compute_dtype(m)
    emb, h, ctx = (torch.randn(rows, w, generator=g, device=dev)
                   for w in (m.dim_word, m.dim, m.ctx_dim))
    whole = step_mod.cast_params(full, m)
    mine = step_mod.cast_params(part, m)
    w_q, scale = step_mod.quantize_weights(step_mod._gates_weights(whole))
    x_q, s_r = step_mod.quantize_rows(torch.cat(
        [emb.to(cd), h.to(cd), ctx.to(cd)], dim=1))
    one = (step_mod._int8_mm(x_q, w_q).to(torch.float32)
           * (s_r * scale[None, :]) + whole["b"])
    with tp.model_axis(mesh, m) as axis:
        wq_l, sc_l = step_mod.quantize_weights(
            step_mod._gates_weights(mine),
            lambda a: tp.all_reduce(a.contiguous(), axis, "max"))
        two = step_mod._int8_gates_sharded(
            mine, types.SimpleNamespace(gates_w_q=wq_l, gates_scale=sc_l),
            emb, h, ctx, cd)
        acc = torch.zeros(rows, 4 * m.dim, dtype=torch.int32, device=dev)
        secs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tp.all_reduce(acc, axis)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    return {"rows": rows, "local_rows": int(wq_l.shape[0]),
            "scale_equal": bool(torch.equal(scale, sc_l)),
            "preact_equal": bool(torch.equal(one, two)),
            "max_abs_err": float((one - two).abs().max()),
            "int32_reduce_s": float(np.median(secs)),
            "int32_reduce_bytes": acc.numel() * 4}


def ss_tp_artifact(kernel, dev, root, files, vocab) -> dict:
    """(c): ``cli.export --model-parallel 2`` of the bf16 run, loaded and
    decoding the bank's 256 videos (kernel 2 on the (1280, 512) x (512,
    6528) shard from inside the graph), against ``make_tp_beam_decode``
    at 1 x 2 bit for bit (the graph's launches of kernels 1 and 2
    counted from zero).  A float32 artifact against one device's and the
    plain graph's captions is the card test
    ``tests/test_torch_cuda.py::test_tp_kernel_graph_gives_the_plain_graph_s_tokens``:
    the exports hold this phase, so it exports one graph a model rank."""
    import hashlib
    from stvd_torch import export_aot
    from stvd_torch.cli import export as cexport
    from stvd_torch.data.bank import FeatureBank, to_device
    from stvd_torch.decode import parallel as dparallel
    from stvd_torch.model.step import compute_dtype
    art, n = os.path.join(root, "tp"), 256
    t0 = time.perf_counter()
    rc = cexport.main(["--run-dir", files["run"], "--out", art, "--batch",
                       str(n), "--model-parallel", str(SS_RANKS)])
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cap = export_aot.load_artifact(art, device=dev)
    load_s = time.perf_counter() - t0
    m, d = cap.cfg.model, cap.cfg.decode
    batch = {k: v[:n] for k, v in to_device(FeatureBank.load(files["bank"]),
                                            dev, compute_dtype(m)).items()}
    got, rec = dp_counts(kernel, [0], lambda: cap.caption_batch(batch))
    with open(os.path.join(art, "manifest.json")) as f:
        manifest = json.load(f)
    full = {k: v.to(dev) for k, v in torch.load(
        os.path.join(files["run"], "ckpt.pt"), weights_only=True)[
            "params"].items()}
    part = dparallel.shard_decode_params(full, cap._mesh)
    with torch.no_grad():
        live = ss_captions(vocab, dparallel.make_tp_beam_decode(
            m, cap._mesh, d.beam_size, d.maxlen, d.length_norm, tail="auto",
            step_fn=kernel.step_kernels)(part, batch).tokens)
    rec.update(rc=rc, videos=n, export_s=export_s, load_s=load_s,
               graph_export_s=manifest["export_seconds"],
               custom_ops=manifest["custom_ops"],
               use_kernel=manifest["use_kernel"],
               tail_shape=[n * d.beam_size, int(part["ff_logit_W"].shape[0]),
                           int(part["ff_logit_W"].shape[1])],
               equal_live_tp=sum(a == b for a, b in zip(got, live)),
               captions_digest=hashlib.sha256(
                   "\n".join(got).encode()).hexdigest())
    del cap, full, part, batch
    torch.cuda.empty_cache()
    return rec


def ss_int8(kernel, mesh, dev, seed, cfg, files, vocab) -> dict:
    """(d): int8 decode of the 256 bank videos under DP (a bank sharded
    over the ranks, ``gates_kernel='on'``: kernel 3 on each rank's 128
    videos) against the single-device int8 kernel decode, every caption;
    and under TP 1 x 2 (plain int8 products, the int32 reduce) against
    the single-device plain-int8 decode, beside that decode with its
    gates bias nudged (the floor of any reorder of a float32 sum); the
    preactivation bit for bit (``ss_int8_gates_exact``)."""
    from stvd_torch import api
    from stvd_torch.data.bank import FeatureBank, to_device
    from stvd_torch.decode import parallel as dparallel
    from stvd_torch.decode.beam import beam_decode
    from stvd_torch.model.step import compute_dtype
    from stvd_torch.train import parallel
    full = {k: v.to(dev) for k, v in torch.load(
        os.path.join(files["run"], "ckpt.pt"), weights_only=True)[
            "params"].items()}
    bank = FeatureBank.load(files["bank"])
    out = {}
    steps = [0]
    cfg_q = with_model(cfg, decode_quant="int8", gates_kernel="on")
    cap = api.Captioner(full, cfg_q, vocab,
                        counted_step(kernel.step_kernels, steps), device=dev)
    cap.attach_bank(bank, mesh=parallel.make_mesh("cuda"))
    got, rec = dp_counts(kernel, steps, lambda: cap.caption_ids(bank.ids))
    if parallel.is_first_rank(mesh):
        one = api.Captioner(full, cfg_q, vocab, device=dev)
        one.attach_bank(bank)
        want = one.caption_ids(bank.ids)
        rec["equal_single_device"] = sum(a == b for a, b in zip(got, want))
        del one
    out["dp"] = dict(rec, videos=bank.n_videos)
    del cap
    cfg_t = with_model(cfg, decode_quant="int8", gates_kernel="auto")
    m, d = cfg_t.model, cfg_t.decode
    part = dparallel.shard_decode_params(full, mesh)
    batch = to_device(bank, dev, compute_dtype(m))
    run = dparallel.make_tp_beam_decode(
        m, mesh, d.beam_size, d.maxlen, d.length_norm, tail="auto",
        step_fn=counted_step(kernel.step_kernels, steps))
    with torch.no_grad():
        res, rec = dp_counts(kernel, steps, lambda: run(part, batch))
    got = ss_captions(vocab, res.tokens)
    rec["exact"] = ss_int8_gates_exact(mesh, dev, seed, m, full, part)
    rec["int32_reduce_share_of_step"] = (
        rec["exact"]["int32_reduce_s"]
        / (rec["seconds"] / max(rec["decode_steps"], 1)))
    if parallel.is_first_rank(mesh):
        m_off = dataclasses.replace(m, gates_kernel="off")
        gen = torch.Generator(device=dev).manual_seed(seed + 5)
        nudged_p = dict(full, b=full["b"] + TP_NUDGE * torch.randn(
            full["b"].shape, generator=gen, device=dev))
        with torch.no_grad():
            want, nudged = (ss_captions(vocab, beam_decode(
                p, m_off, batch, d.beam_size, d.maxlen, d.length_norm,
                step_fn=kernel.step_kernels).tokens)
                for p in (full, nudged_p))
        rec["share_vs_single_device"] = float(np.mean(
            [a == b for a, b in zip(got, want)]))
        rec["nudged_share"] = float(np.mean(
            [a == b for a, b in zip(nudged, want)]))
    out["tp"] = rec
    parallel.broadcast_value(0.0, mesh)
    del full, part, batch
    torch.cuda.empty_cache()
    return out


def ss_step_gap(kernel, mesh, dev, m, full, part, bank, rows=64) -> dict:
    """One decode step from the initial state (zero embedding) of
    ``rows`` videos under the model axis against one device's: the
    largest gaps of h, c and the log-probabilities, beside the same gaps
    of the plain step against the kernel step on one device (rank 0)."""
    from stvd_torch.model import step as step_mod
    from stvd_torch.model import tp
    from stvd_torch.model.decoder import encode_context
    from stvd_torch.train import parallel

    def one(params, mesh_, step_fn):
        p = step_mod.cast_params(params, m)
        frames, mask = bank["frames"][:rows], bank["frame_mask"][:rows]
        with torch.no_grad(), tp.model_axis(mesh_, m):
            sc = step_mod.precompute(p, m, encode_context(p, m, frames),
                                     mask)
            emb = torch.zeros(rows, m.dim_word, dtype=p["Wemb"].dtype,
                              device=dev)
            out = step_fn(p, m, step_mod.init_state(p, m, sc), sc, emb)
            logp = torch.log_softmax(step_mod.logits_from_states(
                p, m, out.h, out.ctx_t, emb), dim=-1)
        return out.h, out.c, logp

    tp_out = one(part, mesh, kernel.step_kernels)
    res = {}
    if parallel.is_first_rank(mesh):
        ref = one(full, None, kernel.step_kernels)
        plain = one(full, None, step_mod.step)
        for name, i in (("h", 0), ("c", 1), ("logp", 2)):
            res[f"tp_{name}"] = float((tp_out[i] - ref[i]).abs().max())
            res[f"plain_{name}"] = float((plain[i] - ref[i]).abs().max())
    return res


def ss_fitted_tp(kernel, mesh, dev, fitted) -> dict:
    """The open check of ROADMAP.md Queue 3: the weights ``eval_fit``
    fitted, their 256 valid videos decoded at 1 x 2 in bf16 through
    ``generate_captions(..., mesh)`` (kernel 2 per vocab shard), against
    the kernel step's single-device captions ``eval_fit`` kept; beside
    them the share the single-device decode keeps with its gates bias
    nudged by TP_NUDGE of float32 noise (the floor of any reorder of a
    float32 sum), the same TP decode at float32 against one device's,
    and one step's gaps (``ss_step_gap``)."""
    from stvd_torch.config import Config
    from stvd_torch.decode import parallel as dparallel
    from stvd_torch.model.step import compute_dtype
    from stvd_torch.train import parallel
    from stvd_torch.train.evaluate import generate_captions
    blob = torch.load(fitted, weights_only=False)
    cfg = Config.from_json(blob["config"])
    m = dataclasses.replace(cfg.model, train_tail_kernel="off")
    full = {k: v.to(dev) for k, v in blob["params"].items()}
    part = dparallel.shard_decode_params(full, mesh)

    def bank_in(mc):
        return {"frames": torch.from_numpy(blob["frames"]).to(
            dev, compute_dtype(mc)),
            "frame_mask": torch.from_numpy(blob["frame_mask"]).to(dev)}

    bank = bank_in(m)
    n = int(bank["frames"].shape[0])
    steps = [0]
    rows, rec = dp_counts(kernel, steps, lambda: generate_captions(
        part, m, bank, n, cfg.decode,
        counted_step(kernel.step_kernels, steps), mesh))
    rec.update(videos=n, share_vs_single_device=float(np.mean(
        [a == b for a, b in zip(rows, blob["rows"])])), bar=TP_SHARE)
    m32 = dataclasses.replace(m, compute_dtype="float32")
    bank32 = bank_in(m32)
    rows32 = generate_captions(part, m32, bank32, n, cfg.decode,
                               kernel.step_kernels, mesh)
    rec["step_gap"] = ss_step_gap(kernel, mesh, dev, m, full, part, bank)
    if parallel.is_first_rank(mesh):
        gen = torch.Generator(device=dev).manual_seed(5)
        nudged = dict(full, b=full["b"] + TP_NUDGE * torch.randn(
            full["b"].shape, generator=gen, device=dev))
        again = generate_captions(full, m, bank, n, cfg.decode,
                                  kernel.step_kernels)
        rows_n = generate_captions(nudged, m, bank, n, cfg.decode,
                                   kernel.step_kernels)
        one32 = generate_captions(full, m32, bank32, n, cfg.decode,
                                  kernel.step_kernels)
        rec["repeat_share"] = float(np.mean(
            [a == b for a, b in zip(again, blob["rows"])]))
        rec["nudged_share"] = float(np.mean(
            [a == b for a, b in zip(rows_n, blob["rows"])]))
        rec["f32_share_vs_single_device"] = float(np.mean(
            [a == b for a, b in zip(rows32, one32)]))
    parallel.broadcast_value(0.0, mesh)
    del part, full, bank, bank32
    torch.cuda.empty_cache()
    return rec


def ss_rank(mesh1, seed, root, ports, fitted) -> dict:
    """Everything one rank of ``sharded_serving``'s 2-rank launch runs:
    (a) the live daemon, (b) the data-parallel artifact's export and
    daemon, (c) the tensor-parallel artifacts, (d) int8 on a mesh and the
    fitted weights' TP decode."""
    import contextlib
    import io
    import torch.distributed as dist
    from stvd_torch import _build, api, export_aot
    from stvd_torch.cli import export as cexport
    from stvd_torch.cli import serve
    from stvd_torch.model import kernel
    from stvd_torch.train import parallel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.lib()                   # the parent built it: this loads it
    files = {k: os.path.join(root, v) for k, v in (
        ("run", "run"), ("bank", "bank.npz"), ("swap", "swap.npz"))}
    cfg = api.preset(NAME)
    vocab = api.Vocab.load_pickle(os.path.join(files["run"], "vocab.pkl"))
    out = {"rank": dist.get_rank(), "backend": dist.get_backend(),
           "device": str(dev)}
    steps = [0]
    real_step, real_load = kernel.step_kernels, export_aot.load_artifact
    loads = []

    def timed_load(*a, **kw):
        t0 = time.perf_counter()
        served = real_load(*a, **kw)
        loads.append(time.perf_counter() - t0)
        return served

    with contextlib.redirect_stdout(io.StringIO()):
        # (a) the live daemon: the daemon's Captioner takes the counted
        # kernel step (get_step_fn reads kernel.step_kernels)
        kernel.step_kernels = counted_step(real_step, steps)
        torch.cuda.reset_peak_memory_stats()
        try:
            rc, rec = dp_counts(kernel, steps, lambda: serve.main([
                "--run-dir", files["run"], "--bank", files["bank"],
                "--bank-shards", str(SS_RANKS), "--port", str(ports[0]),
                "--allow-swap", "--allow-shutdown"]))
        finally:
            kernel.step_kernels = real_step
        out["live_daemon"] = dict(
            rec, rc=rc, peak_mem_gib=torch.cuda.max_memory_allocated()
            / 2 ** 30)
        # (b) the data-parallel artifact, then its daemon
        art = os.path.join(root, "dp")
        t0 = time.perf_counter()
        rc = cexport.main(["--run-dir", files["run"], "--out", art,
                           "--data-parallel", str(SS_RANKS),
                           "--batch", "2,256", "--nbest"])
        export_s = time.perf_counter() - t0
        with open(os.path.join(art, "manifest.json")) as f:
            manifest = json.load(f)
        export_aot.load_artifact = timed_load
        torch.cuda.reset_peak_memory_stats()
        try:
            rc_d, rec = dp_counts(kernel, steps, lambda: serve.main([
                "--artifact", art, "--bank", files["bank"],
                "--bank-shards", str(SS_RANKS), "--port", str(ports[1]),
                "--allow-shutdown"]))
        finally:
            export_aot.load_artifact = real_load
        out["dp_artifact"] = dict(
            rec, rc=rc_d, export_rc=rc, export_s=export_s,
            graph_export_s=manifest["export_seconds"], load_s=loads,
            custom_ops=manifest["custom_ops"],
            peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.empty_cache()
        # (c) the tensor-parallel artifacts; (d) int8 and the fitted
        # weights on the 1 x 2 mesh
        mesh = parallel.make_mesh_2d("cuda", model_parallel=SS_RANKS)
        torch.cuda.reset_peak_memory_stats()
        out["tp_artifact"] = ss_tp_artifact(kernel, dev, root, files, vocab)
        out["int8"] = ss_int8(kernel, mesh, dev, seed, cfg, files, vocab)
        out["fitted_tp"] = ss_fitted_tp(kernel, mesh, dev, fitted)
        out["peak_mem_gib_tp"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["modules"] = sorted(m for m in sys.modules if m in ("jax", "stvd")
                            or m.startswith(("jax.", "stvd.")))
    return out


def ss_rank_2x4(mesh1, seed) -> dict:
    """A rank of the 2 x 4 mesh: one float32 TP update at batch 8 against
    one process's, and a 64-video float32 TP decode against the
    single-device decode."""
    import contextlib
    import io
    from stvd_torch import _build, api
    from stvd_torch.model import kernel
    from stvd_torch.train import parallel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.lib()
    mesh = parallel.make_mesh_2d("cuda", model_parallel=SS_2X4[1])
    c32 = with_model(api.preset(NAME), compute_dtype="float32")
    out = {"data_rank": parallel.axis_rank(mesh),
           "model_rank": parallel.model_rank(mesh)}
    with contextlib.redirect_stdout(io.StringIO()):
        out["train_f32"] = tp_f32_parity(mesh, dev, seed, c32, 8, 1)
        out["decode_f32"] = tp_decode(kernel, mesh, dev, seed,
                                      (("f32", c32, 64),))["f32"]
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def ss_free_ports(n) -> list:
    import socket
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def phase_sharded_serving(kernel, api, dev, seed, info, fitted) -> dict:
    """Sharded serving at full width (preset 3: dim 3584, dim_word 512,
    ctx = attn 1024, K 28, vocab 13056, bf16, beam 5; random weights from
    ``seed``, EOS suppressed so every caption runs all 30 steps) on ranks
    that share the one card over gloo, the kernels built by this process
    before the launch.  Two ranks, each through the entry points a user
    calls:

    a. ``cli.serve --run-dir R --bank B --bank-shards 2`` as a two-rank
       daemon (rank 0 answers HTTP, rank 1 follows), driven from this
       process: /caption_ids of 256 ids (each rank decodes 128) and of
       255 (the chunk is padded to the decode batch, so it also
       scatters), /nbest_ids, an unknown id (400), /swap_params,
       /caption_ids again, /shutdown; every caption equal to a
       single-device ``Captioner``'s; kernels 1 and 2 once a decode step
       on each rank;
    b. ``cli.export --data-parallel 2 --batch 2,256 --nbest`` (size 1 is
       refused at a data degree of 2, as in the JAX package: per-rank
       graphs of 1 and 128 rows), served by ``cli.serve --artifact A
       --bank B --bank-shards 2``: /caption_ids, /nbest_ids and a
       raw-feature /caption (the packed batch broadcast), equal to the
       live single-device ``Captioner``; kernels 1 and 2 30 times a graph
       call from inside the loaded graphs; export and load seconds;
    c. ``cli.export --model-parallel 2`` of the bf16 run (256 videos:
       kernel 2 on the (1280, 512) x (512, 6528) shard from inside the
       graph, route wgmma): captions equal to ``make_tp_beam_decode`` at
       1 x 2 bit for bit;
    d. int8: under DP with ``gates_kernel='on'`` (kernel 3 on each rank)
       against the single-device int8 kernel decode, every caption; under
       TP 1 x 2 (plain int8 products, the int32 reduce) the preactivation
       bit for bit, and the captions against the single-device plain-int8
       decode at INT8_PLAIN_SHARE and at the nudged floor (as
       ``tensor_parallel``'s bf16 decode); the int32 reduce's share of a
       step;
    f. ``eval_fit``'s fitted weights decoded at 1 x 2 in bf16, against
       its single-device captions, beside the share that decode keeps
       with its gates bias nudged by TP_NUDGE (those weights, 10 updates
       from random, read 0.871 there: the 0.95 path-parity bar does not
       hold for any reorder of a float32 sum on them), held to that floor
       less TP_SHARE_SLACK; at float32 every caption equal.

    Then (e) the 2 x 4 layout on 8 ranks: a float32 TP update at batch 8
    and a 64-video float32 TP decode against one process's.  The times
    are of ranks sharing one card over gloo: no scaling figure."""
    import threading
    from stvd_torch.data.bank import FeatureBank
    from stvd_torch.model.decoder import init_params
    from stvd_torch.train import parallel
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(base, exist_ok=True)
    torch.cuda.empty_cache()
    cfg = api.preset(NAME)
    vocab = api.Vocab({f"w{i}": i for i in range(2, cfg.model.n_words)})
    params = eos_weights(init_params(
        cfg.model, torch.Generator(device=dev).manual_seed(seed + 1), dev),
        "eos_suppressed")
    swap = eos_weights(init_params(
        cfg.model, torch.Generator(device=dev).manual_seed(seed + 7), dev),
        "eos_suppressed")
    with tempfile.TemporaryDirectory(dir=base) as root:
        files = ss_files(root, cfg, params, swap, vocab, seed)
        bank = FeatureBank.load(files["bank"])
        ids = list(bank.ids)
        ports = ss_free_ports(2)
        box = {}
        client = threading.Thread(target=ss_client,
                                  args=(ports, ids, files, box), daemon=True)
        client.start()
        t0 = time.perf_counter()
        ranks = parallel.spawn(ss_rank, SS_RANKS, (seed, root, ports, fitted),
                               device="cuda:0", backend="gloo",
                               timeout=SS_TIMEOUT)
        wall = time.perf_counter() - t0
        client.join(timeout=60)
        if "error" in box:
            raise box["error"]
        require("live" in box and "dp" in box, "sharded_serving: the "
                "client got no replies")
        # the single-device references, after the ranks are gone
        live = api.Captioner(params, cfg, vocab, device=dev)
        live.attach_bank(bank)
        want = {"caption_ids_256": live.caption_ids(ids),
                "caption_ids_255": live.caption_ids(ids[:255]),
                "nbest_ids_16": live.nbest_ids(ids[:SS_NBEST], n=5),
                "caption_16": live.caption(files["arr"])}
        fresh = api.Captioner(swap, cfg, vocab, device=dev)
        fresh.attach_bank(bank)
        want["swapped_ids_256"] = fresh.caption_ids(ids)
        del live, fresh
    del params, swap
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks_2x4 = parallel.spawn(ss_rank_2x4, SS_2X4[0] * SS_2X4[1], (seed,),
                               device="cuda:0", backend="gloo",
                               timeout=SS_TIMEOUT)
    wall_2x4 = time.perf_counter() - t0
    if fitted and os.path.exists(fitted):
        os.remove(fitted)

    def seconds(res):
        return {k: v["seconds"] for k, v in res.items()}

    def nbest_gap(reply, ref):
        texts = [[t for t, _ in v] for v in reply]
        gap = max(abs(s - w) for v, r in zip(reply, ref)
                  for (_, s), (_, w) in zip(v, r))
        return texts == [[t for t, _ in v] for v in ref], gap

    live_c, dp_c = box["live"], box["dp"]
    out = {"phase": "sharded_serving", "card": info["nvidia_smi"],
           "setting": f"ranks sharing one card over gloo: {SS_RANKS} ranks "
                      f"(1-D data mesh and 1 x {SS_RANKS}), then "
                      f"{SS_2X4[0]} x {SS_2X4[1]} (no scaling figure)",
           "launch_seconds": wall, "launch_seconds_2x4": wall_2x4,
           "live_daemon_request_s": seconds(live_c),
           "dp_daemon_request_s": seconds(dp_c),
           "ranks": ranks, "ranks_2x4": ranks_2x4}
    checks = {}
    for name in ("caption_ids_256", "caption_ids_255", "swapped_ids_256"):
        st, body = live_c[name]["reply"]
        checks[f"live_{name}"] = st == 200 and body["captions"] == want[name]
    st, body = live_c["nbest_ids_16"]["reply"]
    same, gap = nbest_gap(body["nbest"], want["nbest_ids_16"])
    checks["live_nbest_ids"] = st == 200 and same
    out["live_nbest_score_gap"] = gap
    st, body = live_c["unknown_id"]["reply"]
    checks["live_unknown_id_400"] = st == 400 and "nope" in body["error"]
    st, body = dp_c["caption_ids_256"]["reply"]
    checks["dp_caption_ids"] = st == 200 and body["captions"] == want[
        "caption_ids_256"]
    st, body = dp_c["nbest_ids_16"]["reply"]
    same, gap = nbest_gap(body["nbest"], want["nbest_ids_16"])
    checks["dp_nbest_ids"] = st == 200 and same
    out["dp_nbest_score_gap"] = gap
    checks["dp_caption"] = dp_c["caption_16"]["reply"] == want["caption_16"]
    checks["dp_manifest"] = dp_c["manifest"]["reply"][1].get(
        "data_parallel") == SS_RANKS
    out["checks"] = checks
    # the record first: a failed check below still leaves its numbers
    emit(out)
    require(all(checks.values()), f"sharded_serving: failed {checks}")
    none = {k: 0 for k in KERNELS}
    maxlen = cfg.decode.maxlen
    r0 = ranks[0]
    for r in ranks:
        require(r["backend"] == "gloo" and r["modules"] == [],
                f"sharded_serving rank {r['rank']}: {r['backend']} "
                f"{r['modules']}")
        a = r["live_daemon"]
        # warm-up, 256 ids, 255 ids, n-best, 256 ids after the swap
        want_steps = 5 * maxlen
        require(a["rc"] == 0 and a["decode_steps"] == want_steps
                and a["launches"] == dict(none, attention_core=want_steps,
                                          logit_tail=want_steps),
                f"sharded_serving (a) rank {r['rank']}: {a}")
        for k, route in SERVING_ROUTES.items():
            require(a["launches_by_route"][k][route] == want_steps,
                    f"sharded_serving (a): {k} routes "
                    f"{a['launches_by_route'][k]}")
        b = r["dp_artifact"]
        # warm-up at sizes 2 and 256, /caption_ids, /nbest_ids, /caption
        calls = 5
        require(b["rc"] == 0 and b["export_rc"] == 0
                and b["launches"] == dict(none,
                                          attention_core=calls * maxlen,
                                          logit_tail=calls * maxlen)
                and b["custom_ops"] == ["stvd_torch::attention_core",
                                        "stvd_torch::logit_tail"],
                f"sharded_serving (b) rank {r['rank']}: {b}")
        c = r["tp_artifact"]
        require(c["rc"] == 0 and c["use_kernel"]
                and c["launches"] == dict(none, attention_core=maxlen,
                                          logit_tail=maxlen)
                and c["launches_by_route"]["attention_core"]["cluster"]
                == maxlen
                and c["launches_by_route"]["logit_tail"]["wgmma"] == maxlen
                and c["tail_shape"] == [1280, 512, 6528]
                and c["equal_live_tp"] == c["videos"],
                f"sharded_serving (c) rank {r['rank']}: {c}")
        require(c["captions_digest"]
                == r0["tp_artifact"]["captions_digest"],
                "sharded_serving (c): the ranks' captions differ")
        d = r["int8"]
        steps = d["dp"]["decode_steps"]
        require(steps == maxlen and d["dp"]["launches"] == dict(
            none, attention_core=steps, logit_tail=steps, gates_lstm=steps)
                and d["dp"]["launches_by_route"]["gates_lstm"]["wgmma"]
                == steps, f"sharded_serving (d) DP int8: {d['dp']}")
        t = d["tp"]
        require(t["decode_steps"] == maxlen and t["launches"] == dict(
            none, attention_core=maxlen, logit_tail=maxlen)
                and t["exact"]["preact_equal"] and t["exact"]["scale_equal"],
                f"sharded_serving (d) TP int8: {t}")
        f = r["fitted_tp"]
        require(f["decode_steps"] > 0 and f["launches"] == dict(
            none, attention_core=f["decode_steps"],
            logit_tail=f["decode_steps"]),
            f"sharded_serving (f): launches {f}")
    require(r0["int8"]["dp"]["equal_single_device"] == 256,
            f"sharded_serving (d): DP int8 vs single device "
            f"{r0['int8']['dp']['equal_single_device']}")
    t = r0["int8"]["tp"]
    require(t["share_vs_single_device"] >= INT8_PLAIN_SHARE
            and t["share_vs_single_device"]
            >= t["nudged_share"] - TP_SHARE_SLACK,
            f"sharded_serving (d): TP int8 share {t['share_vs_single_device']}"
            f" vs nudged {t['nudged_share']}")
    # the fitted weights (10 updates) keep near-ties that a 1e-7 nudge of
    # the gates bias flips as a TP reorder does: TP is held to that floor,
    # float32 TP to every caption, and the single-device decode to itself
    f = r0["fitted_tp"]
    require(f["repeat_share"] == 1.0
            and f["f32_share_vs_single_device"] == 1.0
            and f["share_vs_single_device"]
            >= f["nudged_share"] - TP_SHARE_SLACK,
            "sharded_serving (f): fitted weights' TP captions "
            + str({k: f[k] for k in ("share_vs_single_device",
                                     "nudged_share", "repeat_share",
                                     "f32_share_vs_single_device")}))
    q0 = ranks_2x4[0]
    require(q0["train_f32"]["loss_rel_err"] <= 1e-5
            and q0["train_f32"]["weight_rel_err"] <= GRAD_TOL,
            "sharded_serving (e) 2x4 float32 update vs single-process: "
            + str({k: v for k, v in q0["train_f32"].items() if k != "gaps"}))
    require(q0["decode_f32"]["share_vs_single_device"] == 1.0,
            f"sharded_serving (e) 2x4 decode: {q0['decode_f32']}")
    for q in ranks_2x4:
        mate = ranks_2x4[q["data_rank"] * SS_2X4[1]]["decode_f32"]
        require(q["decode_f32"]["tokens_digest"] == mate["tokens_digest"]
                and q["decode_f32"]["launches"]["logit_tail"]
                == q["decode_f32"]["decode_steps"],
                "sharded_serving (e) 2x4 decode: a model group's tokens "
                "differ")
    return out


def with_model(cfg, **kw):
    return cfg.replace(model=dataclasses.replace(cfg.model, **kw))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also print device time by kernel for one decode "
                         "on each serving path, one preset-2 train update "
                         "and one preset-3 update with the tail kernel")
    ap.add_argument("--serving-only", action="store_true",
                    help="only the worst-case serving runs of preset 3, "
                         "path B (int8 gates kernel) and path A (preset 2), "
                         "for an A/B of two trees in one call; prints no ok "
                         "line")
    ap.add_argument("--kernels-only", action="store_true",
                    help="only kernel 6 and kernel 3 timed, and kernel 3's "
                         "outputs digested, for an A/B of two trees in one "
                         "call; prints no ok line")
    ap.add_argument("--root", default=None,
                    help="import stvd_torch from this tree (e.g. an "
                         "unpacked parent commit) instead of the "
                         "script's own")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.root is not None:
        sys.path.insert(0, os.path.abspath(args.root))
    from stvd_torch import _build, api
    from stvd_torch.model import kernel
    from stvd_torch.model import step as step_mod
    from stvd_torch.model.decoder import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(args.seed)

    info = phase_device()
    phase_build(_build)
    cfg = api.preset(NAME)
    cfg_sp = api.preset(SPATIAL)
    cfg_q = with_model(cfg, decode_quant="int8", gates_kernel="on")
    if args.kernels_only:
        return kernels_only(kernel, step_mod, dev, args, cfg, cfg_q)
    if args.serving_only:
        return serving_only(api, kernel, step_mod, dev, g, args, cfg, cfg_q,
                            cfg_sp)
    if args.profile:
        phase_sass(_build)
    phase_tanh(_build, dev, args.seed)
    attn = phase_attention(kernel, step_mod, dev, g, cfg, splits=args.profile)
    tail = phase_tail(kernel, dev, g, args.seed, cfg)
    spatial = phase_spatial(kernel, step_mod, dev, g, cfg_sp)
    gates = phase_gates(kernel, step_mod, dev, g, cfg_q)

    vocab = api.Vocab({f"w{i}": i for i in range(2, cfg.model.n_words)})
    # weights of their own generator, so no phase added above moves them
    params = init_params(
        cfg.model, torch.Generator(device=dev).manual_seed(args.seed + 1),
        dev)
    serving = phase_serving(api, kernel, dev, args.seed, params, vocab, cfg,
                            "serving", ("attention_core", "logit_tail"),
                            routes=SERVING_ROUTES)
    serving_q = phase_serving(api, kernel, dev, args.seed, params, vocab,
                              cfg_q, "serving_int8_gates",
                              ("attention_core", "gates_lstm", "logit_tail"),
                              modes=("eos_suppressed",),
                              routes={**SERVING_ROUTES,
                                      "gates_lstm": "wgmma"})
    phase_kernel_vs_plain(api, kernel, step_mod, dev, args.seed, params,
                          vocab, with_model(cfg, compute_dtype="float32"),
                          "kernel_vs_plain_f32")
    # kernel int8 gates against plain int8 gates (torch._int_mm), the
    # other kernels on both sides; and the whole int8 kernel step against
    # the all-plain step (INT8_PLAIN_SHARE)
    phase_kernel_vs_plain(api, kernel, step_mod, dev, args.seed, params,
                          vocab, cfg_q, "kernel_vs_plain_int8",
                          plain_cfg=with_model(cfg_q, gates_kernel="off"))
    if args.profile:
        phase_profile(api, dev, params, vocab, args.seed, cfg, "profile")
        phase_profile(api, dev, params, vocab, args.seed, cfg_q,
                      "profile_int8_gates")
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(base, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=base) as root:
        aot = phase_aot(api, kernel, dev, args.seed, params, vocab, cfg,
                        cfg_q, root)
    del params
    torch.cuda.empty_cache()

    params_sp = init_params(
        cfg_sp.model,
        torch.Generator(device=dev).manual_seed(args.seed + 2), dev)
    serving_sp = phase_serving(api, kernel, dev, args.seed, params_sp, vocab,
                               cfg_sp, "serving_spatial",
                               ("attention_core", "spatial_core",
                                "logit_tail"),
                               routes={**SERVING_ROUTES,
                                       "spatial_core": "tma"})
    # float32 at decode batch 64: the plain spatial core's float32 e_s is
    # then 1.8 GB a step instead of 7.2 GB
    cfg_sp32 = with_model(cfg_sp, compute_dtype="float32").replace(
        decode=dataclasses.replace(cfg_sp.decode, decode_batch=64))
    phase_kernel_vs_plain(api, kernel, step_mod, dev, args.seed, params_sp,
                          vocab, cfg_sp32, "kernel_vs_plain_spatial_f32")
    # preset 2's artifact at decode batch 64 (cut for time)
    with tempfile.TemporaryDirectory(dir=base) as root:
        aot["spatial"] = aot_export_check(
            api, kernel, dev, args.seed, params_sp, vocab,
            cfg_sp.replace(decode=dataclasses.replace(cfg_sp.decode,
                                                      decode_batch=64)),
            root, "aot_spatial",
            ("attention_core", "spatial_core", "logit_tail"))
    if args.profile:
        phase_profile(api, dev, params_sp, vocab, args.seed, cfg_sp,
                      "profile_spatial")
    del params_sp
    torch.cuda.empty_cache()

    # training: preset 2 at full width, and preset 3 with the tail kernel
    batch = cfg_sp.train.batch_size
    spatial_bwd = phase_spatial_bwd(kernel, dev, g, cfg_sp, batch)
    train_tail = phase_train_tail(kernel, dev, g, cfg, batch)
    dws = phase_dws(kernel, dev, g, cfg_sp, batch)
    train = phase_train(kernel, dev, args.seed, cfg_sp, "train_spatial",
                        ("spatial_bwd", "dws_gemm"),
                        routes={"dws_gemm": "wgmma",
                                "spatial_bwd": "vector"})
    train_t = phase_train(kernel, dev, args.seed,
                          with_model(cfg, train_tail_kernel="on"),
                          "train_temporal_tail", ("train_tail",),
                          routes={"train_tail": "wgmma"})
    phase_train_kernel_vs_plain(kernel, dev, args.seed, cfg_sp)
    phase_train_autodiff(kernel, step_mod, dev, args.seed, cfg, cfg_sp)
    fit_res = phase_eval_fit(kernel, step_mod, dev, args.seed, cfg)
    phase_cli(kernel, dev, args.seed, cfg, info)
    msrvtt = phase_msrvtt(api, kernel, step_mod, dev, args.seed, info,
                          args.profile)
    recipes = phase_recipes(api, kernel, step_mod, dev, args.seed, info)
    # kernels 1 and 2 at a rank's decode shape (128 of preset 5's
    # 256-video batches; kernel 1 also with 1-4 CTAs a row, split_ms),
    # then preset 5 on two ranks sharing the card
    cfg_dp = api.preset(DP)
    cfg_dp_rank = cfg_dp.replace(decode=dataclasses.replace(
        cfg_dp.decode, decode_batch=cfg_dp.decode.decode_batch // DP_RANKS))
    attn_dp = phase_attention(
        kernel, step_mod, dev, g, cfg_dp_rank, splits=True,
        shapes=(("serving", cfg_dp_rank.decode.decode_batch,
                 cfg_dp.decode.beam_size, torch.bfloat16),),
        phase="kernel_attention_core_dp")
    tail_dp = phase_tail(kernel, dev, g, args.seed, cfg_dp_rank,
                         phase="kernel_logit_tail_dp")
    dp = phase_data_parallel(kernel, dev, args.seed, cfg_dp, info)
    # kernels 2 and 7 at a rank's shard of a model axis of 2 (the vocab
    # columns 6528, the Dr rows 512), then tensor parallelism on ranks
    # sharing the card
    tail_tp = phase_tail(kernel, dev, g, args.seed,
                         with_model(cfg, n_words=cfg.model.n_words // TP_MODEL),
                         phase="kernel_logit_tail_tp")
    dws_tp = phase_dws(kernel, dev, g, cfg_sp, batch,
                       dr=cfg_sp.model.region_dim // TP_MODEL,
                       phase="kernel_dws_tp")
    tp = phase_tensor_parallel(kernel, dev, args.seed, info)
    ss = phase_sharded_serving(kernel, api, dev, args.seed, info,
                               fit_res["fitted_path"])
    if args.profile:
        phase_train_profile(dev, args.seed, cfg_sp, "profile_train_spatial")
        phase_train_profile(dev, args.seed,
                            with_model(cfg, train_tail_kernel="on"),
                            "profile_train_temporal_tail")
        phase_train_profile(
            dev, args.seed, cfg.replace(train=dataclasses.replace(
                cfg.train, ss_prob=0.25)), "profile_train_autodiff_ss",
            step_fn=kernel.step_kernels)
    require("jax" not in sys.modules, "the port imported jax")
    require(not any(m == "stvd" or m.startswith("stvd.")
                    for m in sys.modules),
            "the port imported the JAX package")
    require(not any(m == "nltk" or m.startswith("nltk.")
                    for m in sys.modules), "the port imported nltk")

    src = "stvd_torch/csrc/"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")

    def row(name, source, replaces, launches, measured):
        # kernels 1 and 6 also give their device time: their wrappers'
        # host work bounds ms, the event time of back-to-back calls
        extra = ("device_ms",) if "device_ms" in measured else ()
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "launches": launches,
                **{k: measured[k] for k in keys + extra}}

    emit({"kernels": [
        row("attention_core", "attn_core.cu", "stvd/model/kernel.py:45",
            serving["launches"]["attention_core"], attn),
        row("logit_tail", "logit_tail.cu", "stvd/model/kernel.py:593",
            serving["launches"]["logit_tail"], tail),
        row("spatial_core", "spatial_core.cu", "stvd/model/kernel.py:204",
            serving_sp["launches"]["spatial_core"], spatial),
        row("gates_lstm", "gates_lstm.cu", "stvd/model/kernel.py:854",
            serving_q["launches"]["gates_lstm"], gates),
        row("spatial_bwd", "spatial_bwd.cu", "stvd/model/kernel.py:385",
            train["launches"]["spatial_bwd"], spatial_bwd),
        row("train_tail", "train_tail.cu", "stvd/model/kernel.py:1032",
            train_t["launches"]["train_tail"], train_tail),
        row("dws_gemm", "dws_gemm.cu", "tools/probe_dws_gemm.py:87",
            train["launches"]["dws_gemm"], dws),
        # the same kernels at preset 4's shapes, launches of its paths
        row("attention_core_msrvtt", "attn_core.cu",
            "stvd/model/kernel.py:45",
            msrvtt["serving"]["launches"]["attention_core"],
            msrvtt["attention"]),
        row("logit_tail_msrvtt", "logit_tail.cu", "stvd/model/kernel.py:593",
            msrvtt["serving"]["launches"]["logit_tail"], msrvtt["tail"]),
        row("train_tail_msrvtt", "train_tail.cu",
            "stvd/model/kernel.py:1032",
            msrvtt["train"]["launches"]["train_tail"],
            msrvtt["train_tail"]),
        # kernels 2 and 3 at the reference recipes' widths (dim 3518,
        # dim_word 468, vocab 13010 / 20000, Kx 5010 / 6034) on padded
        # rows, launches of the recipe's worst-case-and-natural serving
        # (kernel 2) and of its int8 decode (kernel 3, int8 times)
        *[row(f"logit_tail_recipe_{n}", "logit_tail.cu",
              "stvd/model/kernel.py:593",
              recipes[n]["serving"]["launches"]["logit_tail"],
              recipes[n]["tail"]) for n in RECIPES],
        *[row(f"gates_lstm_recipe_{n}", "gates_lstm.cu",
              "stvd/model/kernel.py:854",
              recipes[n]["serving_q"]["launches"]["gates_lstm"],
              recipes[n]["gates"]) for n in RECIPES],
        # kernels 1-4 as custom ops inside the loaded AOT graphs: 257
        # videos at preset 3 (two chunks), path B and preset 2 (one each)
        row("attention_core_aot", "attn_core.cu", "stvd/model/kernel.py:45",
            aot["launches"]["attention_core"], attn),
        row("logit_tail_aot", "logit_tail.cu", "stvd/model/kernel.py:593",
            aot["launches"]["logit_tail"], tail),
        row("gates_lstm_aot", "gates_lstm.cu", "stvd/model/kernel.py:854",
            aot["path_b"]["launches"]["gates_lstm"], gates),
        row("spatial_core_aot", "spatial_core.cu", "stvd/model/kernel.py:204",
            aot["spatial"]["launches"]["spatial_core"], spatial),
        # kernels 1, 2 and 6 on rank 0 of preset 5's data-parallel paths
        # (two ranks sharing the card over gloo): the validation decode
        # (128 videos a rank) and 5 updates (64 captions a rank,
        # train_tail's shape)
        row("attention_core_dp", "attn_core.cu", "stvd/model/kernel.py:45",
            dp["ranks"][0]["eval"]["launches"]["attention_core"], attn_dp),
        row("logit_tail_dp", "logit_tail.cu", "stvd/model/kernel.py:593",
            dp["ranks"][0]["eval"]["launches"]["logit_tail"], tail_dp),
        row("train_tail_dp", "train_tail.cu", "stvd/model/kernel.py:1032",
            dp["ranks"][0]["train"]["update"]["launches"]["train_tail"],
            train_tail),
        # rank 0 of the tensor_parallel phase's 1 x 2 mesh: kernels 1 and
        # 2 in the 256-video TP decode (kernel 2 on its vocab shard),
        # kernels 5 and 7 in preset 2's TP updates (kernel 7 on the
        # rank's 512 rows of Dr)
        row("attention_core_tp", "attn_core.cu", "stvd/model/kernel.py:45",
            tp["ranks"][0]["decode"]["bf16"]["launches"]["attention_core"],
            attn),
        row("logit_tail_tp", "logit_tail.cu", "stvd/model/kernel.py:593",
            tp["ranks"][0]["decode"]["bf16"]["launches"]["logit_tail"],
            tail_tp),
        row("spatial_bwd_tp", "spatial_bwd.cu", "stvd/model/kernel.py:385",
            tp["ranks"][0]["train_spatial"]["launches"]["spatial_bwd"],
            spatial_bwd),
        row("dws_gemm_tp", "dws_gemm.cu", "tools/probe_dws_gemm.py:87",
            tp["ranks"][0]["train_spatial"]["launches"]["dws_gemm"],
            dws_tp),
        # rank 0 of the sharded_serving phase: kernels 1 and 2 inside the
        # data-parallel artifact's graphs behind the daemon (128 videos a
        # rank), kernel 3 int8 in the DP decode of a sharded bank (128
        # videos a rank)
        row("attention_core_sharded", "attn_core.cu",
            "stvd/model/kernel.py:45",
            ss["ranks"][0]["dp_artifact"]["launches"]["attention_core"],
            attn_dp),
        row("logit_tail_sharded", "logit_tail.cu", "stvd/model/kernel.py:593",
            ss["ranks"][0]["dp_artifact"]["launches"]["logit_tail"],
            tail_dp),
        row("gates_lstm_sharded", "gates_lstm.cu", "stvd/model/kernel.py:854",
            ss["ranks"][0]["int8"]["dp"]["launches"]["gates_lstm"], gates),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
