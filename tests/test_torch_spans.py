"""The port's spans (``stvd_torch.utils.profiling.span``) in a
``torch.profiler`` trace: the request, decode loop, kernel-wrapper and
train-step spans nest as the layers do and come once a call, a step or
an update; with no profiler running a span is one shared no-op and
enters no profiler range; an exported graph holds no profiler op; and
the train log's steps/sec is read only at its records, after their loss
read."""

from __future__ import annotations

import bisect
import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from stvd_torch import export_aot
from stvd_torch.api import Captioner
from stvd_torch.config import Config, DecodeConfig, TrainConfig
from stvd_torch.data.bank import FeatureBank, to_device
from stvd_torch.data.batching import gather_batch, synthetic_dataset
from stvd_torch.data.text import Vocab
from stvd_torch.model import kernel
from stvd_torch.model.decoder import init_params
from stvd_torch.train import loop
from stvd_torch.utils import profiling

from conftest import small_cfg

MCFG = small_cfg()
VOCAB = Vocab({f"w{i}": i for i in range(2, MCFG.n_words)})
MAXLEN = 10


def eos_weights(seed=1):
    """Unit-scale weights that keep EOS off at the first step and favour
    it after any word (the zero embedding of step 0 leaves activation 0
    near -1; a word's embedding lifts it to near 0; only EOS reads it),
    so every decode exits early."""
    g = torch.Generator().manual_seed(seed)
    p = {k: (torch.randn(v.shape, generator=g) / math.sqrt(v.shape[0])
             if v.dim() >= 2 else 0.5 * torch.randn(v.shape, generator=g))
         for k, v in init_params(MCFG, g, "cpu").items()}
    p["Wemb"][:, 0] = 3.0
    p["ff_logit_lstm_b"][0] = -3.0
    p["ff_logit_W"][0, :] = 0.0
    p["ff_logit_W"][0, 0] = 10.0
    p["ff_logit_b"][0] = 2.5
    return p


def bank(n=5, seed=3):
    rng = np.random.RandomState(seed)
    mask = np.ones((n, MCFG.n_frames), np.float32)
    mask[:, -2:] = rng.rand(n, 2) > 0.5
    return FeatureBank(
        ids=[f"v{i}" for i in range(n)],
        frames=rng.randn(n, MCFG.n_frames, MCFG.ctx_dim).astype(np.float32),
        frame_mask=mask)


def captioner(beam, step_fn=None):
    cfg = Config(model=MCFG, decode=DecodeConfig(beam_size=beam,
                                                 maxlen=MAXLEN,
                                                 decode_batch=2))
    cap = Captioner(eos_weights(), cfg, VOCAB, step_fn, device="cpu")
    cap.attach_bank(bank())
    return cap


def spans(prof):
    """name -> sorted (start_us, end_us) of the trace's ``stvd.*`` host
    ranges."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("stvd."):
            out.setdefault(ev.name(), []).append(
                (ev.start_ns() / 1e3, ev.end_ns() / 1e3))
    return {k: sorted(v) for k, v in out.items()}


def within(inner, outer):
    """Each of ``inner`` lies inside one of ``outer`` (sorted)."""
    starts = [s for s, _ in outer]
    for s, e in inner:
        i = bisect.bisect_right(starts, s) - 1
        if i < 0 or e > outer[i][1]:
            return False
    return True


def counted(step_fn, steps):
    def step(*args):
        steps[0] += 1
        return step_fn(*args)
    if hasattr(step_fn, "make_logit_tail"):
        step.make_logit_tail = step_fn.make_logit_tail
    return step


@pytest.mark.parametrize("beam,step_fn", [
    (1, None), (3, None), (3, kernel.step_kernels)],
    ids=["greedy", "beam", "beam-kernel-wrappers"])
def test_request_decode_and_kernel_spans_nest(beam, step_fn):
    """One ``caption_ids`` of 5 ids in chunks of 2: one ``stvd.request``
    holding the id lookup and each chunk's upload, copy and strings, and
    a ``stvd.decode`` a chunk, each holding a step, a select and a sync
    per step run (the early exit included) and, in a beam decode, its
    best-beam choice; with the kernel step, each step holds one call of
    each wrapper it takes."""
    cap = captioner(beam, step_fn)
    steps = [0]
    cap.step_fn = counted(cap.step_fn, steps)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = cap.caption_ids(cap.bank_ids)
    got = spans(prof)
    chunks = 3
    assert len(out) == 5
    assert chunks < steps[0] < chunks * MAXLEN        # every chunk exits
    request = got["stvd.request"]
    assert len(request) == 1
    assert len(got["stvd.request.rows"]) == 1 + chunks
    for part in ("rows", "copy", "detok"):
        assert within(got[f"stvd.request.{part}"], request)
    assert len(got["stvd.request.copy"]) == len(
        got["stvd.request.detok"]) == chunks
    decode = got["stvd.decode"]
    assert len(decode) == chunks and within(decode, request)
    for part in ("step", "select", "sync"):
        assert len(got[f"stvd.decode.{part}"]) == steps[0], part
        assert within(got[f"stvd.decode.{part}"], decode)
    best = got.get("stvd.decode.best", [])
    assert len(best) == (chunks if beam > 1 else 0)
    assert within(best, decode)
    wrappers = {k for k in got if k.startswith("stvd.kernel.")}
    if step_fn is None:
        assert not wrappers
    else:
        assert wrappers == {"stvd.kernel.attention_core",
                            "stvd.kernel.logit_tail"}
        for name in wrappers:
            assert len(got[name]) == steps[0]
            assert within(got[name], got["stvd.decode.step"])


def test_caption_holds_its_packing_and_batch():
    """``caption`` of raw features: its ``stvd.request`` holds the one
    of ``caption_batch``, and the decodes lie in both."""
    cap = captioner(3)
    feats = bank(3).frames
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        cap.caption(feats)
    request = spans(prof)["stvd.request"]
    assert len(request) == 2
    outer, inner = request
    assert outer[0] <= inner[0] and inner[1] <= outer[1]
    assert within(spans(prof)["stvd.decode"], [inner])


def train_setup(tmp_path, **train):
    tcfg = TrainConfig(**{**dict(batch_size=4, save_freq=0,
                                 save_dir=str(tmp_path)), **train})
    ds = synthetic_dataset(n_videos=6, k=MCFG.n_frames, d=MCFG.ctx_dim,
                           maxlen=MAXLEN, seed=0)
    state = loop.init_train_state(0, MCFG, tcfg, "cpu")
    dev = to_device(ds.bank, "cpu", torch.float32)
    return tcfg, ds, state, dev


def test_train_step_spans_once_an_update(tmp_path):
    """Two updates, each fed by ``gather_batch``: a feed and a step
    each, and in each step one forward, one backward and one optimizer
    span, in that order; no all-reduce on one device."""
    tcfg, ds, state, dev = train_setup(tmp_path)
    step = loop.make_train_step(MCFG, tcfg)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for idx in (np.arange(4), np.arange(4, 8)):
            batch = gather_batch(dev, ds.captions, idx)
            batch["weight"] = torch.ones(4)
            state, m = step(state, batch)
    got = spans(prof)
    assert "stvd.train.allreduce" not in got
    assert len(got["stvd.train.feed"]) == len(got["stvd.train.step"]) == 2
    assert not within(got["stvd.train.feed"], got["stvd.train.step"])
    for part in ("forward", "backward", "optimizer"):
        assert len(got[f"stvd.train.{part}"]) == 2, part
        assert within(got[f"stvd.train.{part}"], got["stvd.train.step"])
    for i in range(2):
        f, b, o = (got[f"stvd.train.{p}"][i]
                   for p in ("forward", "backward", "optimizer"))
        assert f[1] <= b[0] and b[1] <= o[0]
    assert np.isfinite(float(m["loss"]))


def no_ranges(monkeypatch, boom):
    """Make every way into a profiler range raise."""
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)


def test_without_a_profiler_a_span_is_the_shared_no_op(tmp_path,
                                                        monkeypatch):
    """No profiler: every span is one shared object, and a request and
    an update run with every profiler range made to raise."""
    def boom(*a, **k):
        raise AssertionError("a profiler range with no profiler")

    no_ranges(monkeypatch, boom)
    assert profiling.span("stvd.request") is profiling.span("stvd.decode")
    cap = captioner(3, kernel.step_kernels)
    assert len(cap.caption_ids(["v0", "v3"])) == 2
    tcfg, ds, state, dev = train_setup(tmp_path)
    batch = gather_batch(dev, ds.captions, np.arange(4))
    batch["weight"] = torch.ones(4)
    _, m = loop.make_train_step(MCFG, tcfg)(state, batch)
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("platform", ["cpu", "cuda"])
def test_export_under_a_profiler_records_no_span(platform, monkeypatch):
    """``export_decoder`` while a profiler runs: no span enters a
    profiler range while the graph is traced (the CUDA platform's
    graph is traced on fake tensors through the kernel wrappers), and
    the graph holds no profiler op."""
    def boom(*a, **k):
        raise AssertionError("a span inside an exported graph")

    m = dataclasses.replace(MCFG, compute_dtype="bfloat16")
    cfg = Config(model=m, decode=DecodeConfig(beam_size=3, maxlen=MAXLEN,
                                              decode_batch=2))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        no_ranges(monkeypatch, boom)
        eps = export_aot.export_decoder(eos_weights(), cfg,
                                        platforms=(platform,))
    for n in eps[platform].graph.nodes:
        assert "profiler" not in str(n.target), n.target
        assert "record_function" not in str(n.target), n.target


def test_step_timer_counts_the_updates_between_two_reads(monkeypatch):
    """The rate is the updates between two reads of the clock over the
    seconds between them; a read before ``window`` updates have passed
    since the last rate gives none."""
    now = [0.0]
    monkeypatch.setattr(profiling, "time",
                        types.SimpleNamespace(perf_counter=lambda: now[0]))
    timer = profiling.StepTimer(window=10)
    got = []
    for count, t in [(5, 0.0), (10, 1.0), (15, 4.0), (20, 5.0), (25, 6.5),
                     (40, 8.0)]:
        now[0] = t
        got.append(timer.tick(count))
    assert got == [None, None, 10 / 4.0, None, 10 / 2.5, 15 / 1.5]


def test_fit_reads_the_timer_at_its_records_after_the_loss(tmp_path,
                                                           monkeypatch):
    """``fit`` reads the step timer only at its train records, after the
    record's loss has been read (so the card has finished the update),
    with the count of updates done."""
    order = []

    class Timer(profiling.StepTimer):
        def tick(self, count):
            order.append(("tick", count))
            return super().tick(count)

    real_float = float
    real_step = loop.make_train_step

    def make(*a, **k):
        step = real_step(*a, **k)

        def traced(state, batch):
            state, m = step(state, batch)
            m = dict(m)
            loss = m["loss"]

            class Read:
                def __float__(self):
                    order.append(("loss", state["step"]))
                    return real_float(loss)
            m["loss"] = Read()
            return state, m
        return traced

    monkeypatch.setattr(loop, "StepTimer", Timer)
    monkeypatch.setattr(loop, "make_train_step", make)
    cfg = Config(model=MCFG, train=TrainConfig(
        batch_size=4, disp_freq=5, valid_freq=0, sample_freq=0,
        save_freq=0, metric="nll", save_dir=str(tmp_path)))
    ds = synthetic_dataset(n_videos=6, k=MCFG.n_frames, d=MCFG.ctx_dim,
                           maxlen=MAXLEN, seed=0)
    res = loop.fit(cfg, ds, max_updates=25, device="cpu")
    assert order == [x for u in (5, 10, 15, 20, 25)
                     for x in (("loss", u), ("tick", u))]
    rates = ["steps_per_sec" in r for r in res.log]
    assert rates == [False, False, True, False, True]
