"""The ``Captioner``'s beam decodes as CUDA graphs (``decode/graphs.py``).

On the card, a graphed ``Captioner`` is held to ``beam_decode`` without a
graph set on the same weights and the same chunks, at the reference
recipes' widths (``recipes/*.json``) with small chunks: tokens and
length-normalized scores bit for bit, with natural EOS (the early exit)
and with EOS suppressed, with several chunks in flight, after a
``swap_params``, under ``decode_quant='int8'``, from two threads, and
with a ``step_fn`` that synchronizes, whose capture fails and whose
decodes stay eager.  Replays keep the kernels' launch counts and the
decode spans.  On the CPU: the rule that decides where graphs engage,
and the callers that never pass a set.

This file imports no jax, so its card tests run where only torch is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_decode_graphs.py
"""

from __future__ import annotations

import dataclasses
import math
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from stvd_torch import api
from stvd_torch.config import Config, DecodeConfig, ModelConfig
from stvd_torch.data.bank import FeatureBank
from stvd_torch.data.text import EOS_ID, Vocab
from stvd_torch.decode import beam, graphs, parallel
from stvd_torch.model import kernel, tp
from stvd_torch.model.decoder import init_params
from stvd_torch.train import evaluate

RECIPES = Path(__file__).resolve().parents[1] / "recipes"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def recipe(name: str, bsz: int = 4, **model) -> Config:
    cfg = Config.from_json((RECIPES / f"{name}.json").read_text())
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **model),
        decode=dataclasses.replace(cfg.decode, decode_batch=bsz))


def weights(m: ModelConfig, device, seed: int, eos: str) -> dict:
    """Unit-scale weights (logits of a few units, as a trained model's).
    ``eos='natural'``: EOS is held off at step 0 and favoured after any
    word, through the previous word's embedding, so decodes end early;
    ``'suppressed'``: its bias is -1e9 and every caption runs maxlen."""
    g = torch.Generator(device=device).manual_seed(seed)
    p = {k: (torch.randn(v.shape, generator=g, device=device)
             / math.sqrt(v.shape[0]) if v.dim() >= 2
             else 0.5 * torch.randn(v.shape, generator=g, device=device))
         for k, v in init_params(m, g, device).items()}
    if eos == "natural":
        p["Wemb"][:, 0] = 3.0
        p["ff_logit_lstm_W"][:, 0] = 0.0
        p["ff_logit_ctx_W"][:, 0] = 0.0
        p["ff_logit_lstm_b"][0] = -3.0
        p["ff_logit_W"][0, :] = 0.0
        p["ff_logit_W"][0, EOS_ID] = 10.0
        p["ff_logit_b"][EOS_ID] = 5.0
    else:
        p["ff_logit_b"][EOS_ID] = -1e9
    return p


def feature_bank(m: ModelConfig, n: int, seed: int) -> FeatureBank:
    rng = np.random.RandomState(seed)
    k = m.n_frames
    mask = np.ones((n, k), np.float32)
    mask[:, k // 2:] = rng.rand(n, k - k // 2) > 0.4
    return FeatureBank(
        ids=[f"v{i}" for i in range(n)],
        frames=rng.randn(n, k, m.ctx_dim).astype(np.float32),
        frame_mask=mask,
        regions=(rng.randn(n, k, m.n_regions, m.region_dim)
                 .astype(np.float32) if m.use_spatial else None),
        motion=(rng.randn(n, k, m.motion_dim).astype(np.float32)
                if m.use_motion else None))


def captioner(cfg: Config, device, seed: int = 0, eos: str = "natural",
              n: int = 18, step_fn=None) -> api.Captioner:
    vocab = Vocab({f"w{i}": i for i in range(2, cfg.model.n_words)})
    cap = api.Captioner(weights(cfg.model, device, seed, eos), cfg, vocab,
                        step_fn, device=device)
    cap.attach_bank(feature_bank(cfg.model, n, seed + 1))
    return cap


def served(cap: api.Captioner, ids):
    """``caption_ids(ids)`` and every chunk's (tokens, scores) as the
    timed path returned them, all kept until the request is done."""
    got = []
    run = cap._run

    def keep(params, batch):
        out = run(params, batch)
        got.append(out)
        return out

    cap._run = keep
    try:
        texts = cap.caption_ids(ids)
    finally:
        del cap._run
    return texts, got


def eager(cap: api.Captioner, ids):
    """The same chunks through ``beam_decode`` without a graph set."""
    d = cap.cfg.decode
    rows = cap._rows_for(ids)
    outs = []
    for s in range(0, len(rows), d.decode_batch):
        chunk = np.zeros(d.decode_batch, np.int64)
        part = rows[s:s + d.decode_batch]
        chunk[:len(part)] = part
        idx = torch.from_numpy(chunk).to(cap.device)
        batch = {k: v.index_select(0, idx)
                 for k, v in cap._resident().items()}
        with torch.inference_mode():
            out = beam.beam_decode(cap.params, cap.cfg.model, batch,
                                   beam_size=d.beam_size, maxlen=d.maxlen,
                                   length_norm=d.length_norm,
                                   step_fn=cap.step_fn)
        outs.append((out.tokens, out.norm_scores))
    return outs


def texts_of(cap: api.Captioner, outs, n: int):
    """The first ``n`` captions of chunk results, as strings."""
    toks = torch.cat([t for t, _ in outs]).cpu().numpy()
    return [" ".join(cap.vocab.decode(toks[i])) for i in range(n)]


def assert_same(got, want):
    assert len(got) == len(want)
    for (tg, sg), (tw, sw) in zip(got, want):
        assert torch.equal(tg, tw)
        assert torch.equal(sg, sw)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("eos", ["natural", "suppressed"])
@pytest.mark.parametrize("name", ["msvd", "msrvtt"])
def test_graphed_equals_eager_at_recipe_widths(cuda, name, eos):
    """Five chunks of 4 videos a request (up to four in flight): every
    chunk's tokens and scores equal the eager decode's, in the request
    whose first chunk decodes eagerly and captures, and in a second one
    of the videos in another order; every later chunk replays, all
    maxlen steps with EOS suppressed, fewer with natural EOS (the early
    exit)."""
    cfg = recipe(name)
    cap = captioner(cfg, cuda, eos=eos)
    maxlen = cfg.decode.maxlen
    for chunks, ids in ((4, cap.bank_ids), (5, cap.bank_ids[::-1])):
        replayed = cap.decode_graphs.replayed if cap.decode_graphs else 0
        texts, got = served(cap, ids)
        assert len(texts) == len(ids)
        assert_same(got, eager(cap, ids))
        steps = cap.decode_graphs.replayed - replayed
        if eos == "suppressed":
            assert steps == chunks * maxlen
        else:
            assert chunks <= steps < chunks * maxlen
    assert [c is not None for c in cap.decode_graphs.chains.values()] == [
        True]


@pytest.mark.cuda
def test_swap_captures_again(cuda):
    """``swap_params`` drops the set; the next request captures a new
    one, whose captions are the new weights' eager ones."""
    cfg = recipe("msrvtt")
    cap = captioner(cfg, cuda)
    served(cap, cap.bank_ids)
    old = cap.decode_graphs
    new = captioner(cfg, cuda, seed=7).params
    cap.swap_params({k: v.cpu().numpy() for k, v in new.items()})
    assert cap.decode_graphs is None
    _, got = served(cap, cap.bank_ids)
    assert cap.decode_graphs is not old
    assert cap.decode_graphs.replayed > 0
    assert_same(got, eager(cap, cap.bank_ids))


@pytest.mark.cuda
@pytest.mark.parametrize("gates", ["off", "on"])
def test_int8_gates(cuda, gates):
    """W8A8 gates, on cuBLAS's int8 product or on kernel 3, replayed."""
    cfg = recipe("msvd", decode_quant="int8", gates_kernel=gates)
    cap = captioner(cfg, cuda, eos="suppressed", n=8)
    for _ in range(2):
        _, got = served(cap, cap.bank_ids)
        assert_same(got, eager(cap, cap.bank_ids))
    assert cap.decode_graphs.replayed > 0


@pytest.mark.cuda
def test_nbest_and_raw_features(cuda):
    """``nbest`` (every beam, cloned out of the graphs' memory, on the
    second call) and ``caption`` of raw features (copied into the static
    inputs) equal the eager decode of the same packed chunk."""
    cfg = recipe("msrvtt")
    cap = captioner(cfg, cuda, eos="suppressed", n=4)
    bank = feature_bank(cfg.model, 4, 1)
    feats = [bank.frames[i] for i in range(4)]
    mots = [bank.motion[i] for i in range(4)]
    first = cap.nbest(feats, motion=mots)
    again = cap.nbest(feats, motion=mots)
    assert cap.decode_graphs.replayed > 0
    batch = api.pack_request(cfg.model, feats, None, mots, device=cuda)
    d = cfg.decode
    with torch.inference_mode():
        out = beam.beam_decode(cap.params, cfg.model, batch,
                               beam_size=d.beam_size, maxlen=d.maxlen,
                               length_norm=d.length_norm,
                               step_fn=cap.step_fn)
    want = cap._nbest_lists(out.all_tokens, out.all_norm_scores, None)
    assert first == again == want
    assert cap.caption(feats, motion=mots) == texts_of(
        cap, [(out.tokens, None)], 4)


@pytest.mark.cuda
def test_two_threads(cuda):
    """Two threads send requests to one Captioner at once: the one that
    holds the set replays, the other decodes eagerly, and both get the
    eager captions."""
    cfg = recipe("msrvtt")
    cap = captioner(cfg, cuda, eos="suppressed", n=8)
    served(cap, cap.bank_ids)
    ids = [cap.bank_ids[:4], cap.bank_ids[4:]]
    want = [texts_of(cap, eager(cap, part), 4) for part in ids]
    got = [[], []]

    def client(i):
        for _ in range(3):
            got[i].append(cap.caption_ids(ids[i]))

    threads = [threading.Thread(target=client, args=(i,)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert got == [[want[0]] * 3, [want[1]] * 3]


@pytest.mark.cuda
def test_syncing_step_stays_eager(cuda):
    """A ``step_fn`` that synchronizes cannot be captured: the shape
    stays eager for the set's life, with the eager captions (the first
    chunk's from the eager decode that preceded the capture)."""
    def syncing(*args):
        out = kernel.step_kernels(*args)
        torch.cuda.synchronize()
        return out

    syncing.make_logit_tail = kernel.make_logit_tail
    cap = captioner(recipe("msrvtt"), cuda, n=8, step_fn=syncing)
    for _ in range(2):
        _, got = served(cap, cap.bank_ids)
        assert_same(got, eager(cap, cap.bank_ids))
    gs = cap.decode_graphs
    assert gs.replayed == 0
    assert list(gs.chains.values()) == [None]


@pytest.mark.cuda
def test_replays_count_launches_and_keep_the_spans(cuda):
    """The first request captures once (one ``stvd.decode.capture``)
    after its first chunk's eager decode.  Each replayed step counts one
    attention-core and one logit-tail launch on the route the capture
    took (a capture counts none), and holds one ``stvd.decode.replay``
    in its ``stvd.decode.step``, no select and no kernel-wrapper span;
    the profiler sees the graph's kernels under their own names."""
    cfg = recipe("msrvtt")
    cap = captioner(cfg, cuda, eos="suppressed", n=8)
    fns = (kernel.attention_core, kernel.logit_tail)
    before = [fn.launches for fn in fns]
    routes = [dict(fn.launches_by_route) for fn in fns]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        served(cap, cap.bank_ids)                   # capture: 2 chunks
    assert [ev.name() for ev in prof.profiler.kineto_results.events()
            ].count("stvd.decode.capture") == 1
    replayed = cap.decode_graphs.replayed
    assert replayed == cfg.decode.maxlen            # the second chunk
    eager_steps = cfg.decode.maxlen                 # the first chunk
    for fn, n, r, route in zip(fns, before, routes, ("cluster", "wgmma")):
        assert fn.launches - n == eager_steps + replayed
        assert fn.launches_by_route[route] - r[route] == (
            eager_steps + replayed)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        served(cap, cap.bank_ids)
        torch.cuda.synchronize()
    names = {}
    kernels = set()
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            kernels.add(ev.name())
        elif ev.name().startswith("stvd."):
            names.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.end_ns()))
    steps = sorted(names["stvd.decode.step"])
    replays = sorted(names["stvd.decode.replay"])
    assert len(steps) == len(replays) == len(
        names["stvd.decode.sync"]) == 2 * cfg.decode.maxlen
    assert all(s0 <= r0 and r1 <= s1
               for (s0, s1), (r0, r1) in zip(steps, replays))
    assert "stvd.decode.select" not in names
    assert not any(n.startswith("stvd.kernel.") for n in names)
    assert any("tail_wgmma_kernel" in n for n in kernels)
    assert any("attn_core" in n for n in kernels)


# ---------------------------------------------------------------------------
# On the CPU: where graphs engage
# ---------------------------------------------------------------------------

TINY = ModelConfig(n_words=48, dim_word=16, dim=24, ctx_dim=32, n_frames=6,
                   compute_dtype="float32")


def tiny_captioner(beam_size: int = 3) -> api.Captioner:
    cfg = Config(model=TINY, decode=DecodeConfig(beam_size=beam_size,
                                                 maxlen=6, decode_batch=2))
    cap = api.Captioner(weights(TINY, "cpu", 0, "natural"), cfg,
                        Vocab({f"w{i}": i for i in range(2, 48)}),
                        device="cpu")
    cap.attach_bank(feature_bank(TINY, 5, 1))
    return cap


def test_cpu_captioner_makes_no_graph_set():
    """On the CPU the Captioner decodes eagerly and makes no set; its
    decode records no replay span."""
    cap = tiny_captioner()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        texts = cap.caption_ids(cap.bank_ids)
        cap.nbest_ids(cap.bank_ids[:2])
    assert len(texts) == 5 and cap.decode_graphs is None
    names = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert "stvd.decode.step" in names and "stvd.decode.select" in names
    assert "stvd.decode.replay" not in names


def fake_cuda_batch():
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return {"frames": torch.empty(2, 6, 32, device="cuda")}


@pytest.mark.parametrize("case", [
    "engages", "other_weights", "other_step", "cpu_tensors", "exporting",
    "compiling", "model_axis"])
def test_engagement_rule(monkeypatch, case):
    """A set engages for its own weights and step, on CUDA tensors,
    outside an export, a compile and a model axis (fake CUDA tensors
    stand in for the card's)."""
    params, step = {"w": torch.zeros(1)}, kernel.step_kernels
    gs = graphs.DecodeGraphs(params, step)
    batch = fake_cuda_batch()
    if case == "other_weights":
        params = dict(params)
    elif case == "other_step":
        step = kernel.get_step_fn(False)
    elif case == "cpu_tensors":
        batch = {"frames": torch.zeros(2, 6, 32)}
    elif case == "exporting":
        monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    elif case == "compiling":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    elif case == "model_axis":
        monkeypatch.setattr(tp, "current", lambda: object())
    assert gs.engages(params, step, batch) == (case == "engages")
    assert graphs.available() == (case not in (
        "exporting", "compiling", "model_axis"))


def test_captioner_offers_no_set_where_the_rule_refuses(monkeypatch):
    """The Captioner's context yields no set on the CPU, for greedy
    decoding, for weights a swap replaced, or under an export."""
    cap = tiny_captioner()
    with cap._graphs_for(cap.params) as gs:
        assert gs is None                       # CPU
    monkeypatch.setattr(cap, "device", torch.device("cuda"))
    with cap._graphs_for(cap.params) as gs:
        assert gs is not None and gs.serves(cap.params, cap.step_fn)
        with cap._graphs_for(cap.params) as again:
            assert again is gs                  # the thread holds it
    assert cap.decode_graphs is gs
    monkeypatch.undo()
    old = cap.params
    cap.swap_params({k: v.numpy() for k, v in old.items()})
    assert cap.decode_graphs is None
    monkeypatch.setattr(cap, "device", torch.device("cuda"))
    with cap._graphs_for(old) as gs:
        assert gs is None                       # replaced weights
    with cap._graphs_for(cap.params) as gs:
        assert gs is not None and gs.serves(cap.params, cap.step_fn)
    monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    with cap._graphs_for(cap.params) as gs:
        assert gs is None
    monkeypatch.undo()
    greedy = tiny_captioner(beam_size=1)
    monkeypatch.setattr(greedy, "device", torch.device("cuda"))
    with greedy._graphs_for(greedy.params) as gs:
        assert gs is None


def test_a_claimed_set_is_not_handed_to_another_thread():
    gs = graphs.DecodeGraphs({}, None)
    seen = []
    with gs.claim() as mine:
        th = threading.Thread(
            target=lambda: seen.append(gs.claim().__enter__()))
        th.start()
        th.join(timeout=10)
        assert mine is gs
    assert not th.is_alive() and seen == [None]


def _record(monkeypatch, module):
    calls = []
    real = beam.beam_decode

    def recording(*args, **kwargs):
        calls.append(kwargs.get("graphs"))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, "beam_decode", recording)
    return calls


@pytest.mark.parametrize("caller", ["evaluate", "tp_decode"])
def test_callers_without_a_set_stay_eager(monkeypatch, caller):
    """Validation (``generate_captions``) and the TP decode call
    ``beam_decode`` with no graph set."""
    cap = tiny_captioner()
    bank = cap._resident()
    d = cap.cfg.decode
    if caller == "evaluate":
        calls = _record(monkeypatch, evaluate)
        evaluate.generate_captions(cap.params, TINY, bank, 5, d)
    else:
        calls = _record(monkeypatch, parallel)
        run = parallel.make_tp_beam_decode(TINY, None, beam_size=3,
                                           maxlen=d.maxlen)
        run(cap.params, {k: v[:2] for k, v in bank.items()})
    assert calls and all(g is None for g in calls)
