"""The check that decides ``correct``, run on the CPU at a tiny float32
size: the reference agrees with the port's plain path; the controls and
the planted faults come out not correct; the result line keeps the
contract's keys."""

from __future__ import annotations

import pytest
import torch

from conftest import measure
from gpubench import harness
from gpubench.drivers import serve_bank, train
from gpubench.reference import model as ref

SERVE = ("msvd.serve.bank", "msrvtt.serve.bank")


@pytest.mark.parametrize("cell", SERVE)
def test_reference_agrees_with_plain_serving(tiny, cell):
    r, _, correct = measure(tiny, cell)
    assert correct
    assert r.compared and all(c["value"] < 1e-4
                              for c in r.compared.values())


def test_reference_agrees_with_plain_training(tiny):
    r, _, correct = measure(tiny, "msvd.train")
    assert correct
    got = {k: v["value"] for k, v in r.compared.items()}
    assert got["loss_gap"] < 1e-5 and got["change_gap"] < 1e-4
    # the first gradient is read back from bf16 adadelta slots
    assert got["grad_gap"] < 5e-3


def _alter_token(monkeypatch):
    """Every decode's best caption gets its third token replaced."""
    from stvd_torch.api import Captioner
    run = Captioner._run

    def altered(self, params, batch):
        toks, scores = run(self, params, batch)
        toks = toks.clone()
        toks[:, 2] = (toks[:, 2] + 7) % (self.cfg.model.n_words - 2) + 2
        return toks, scores

    monkeypatch.setattr(Captioner, "_run", altered)


def _stale_state(monkeypatch):
    """A decode step that returns its state unchanged."""
    from stvd_torch.model import step as step_mod
    real = step_mod.step_with_core

    def stale(params, cfg, state, sc, emb_t, *a, **kw):
        out = real(params, cfg, state, sc, emb_t, *a, **kw)
        return out._replace(h=state.h, c=state.c)

    monkeypatch.setattr(step_mod, "step_with_core", stale)


@pytest.mark.parametrize("fault", [_alter_token, _stale_state])
@pytest.mark.parametrize("cell", SERVE)
def test_serving_faults_are_not_correct(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    r, _, correct = measure(tiny, cell)
    assert not correct, r.compared


def _half_batch(monkeypatch):
    """The train step sees half of each batch, its mean over those rows."""
    real = train.Job.batch

    def half(self, idx, t):
        b = real(self, idx, t)
        n = b["tokens"].shape[0] // 2
        return {k: v[:n] for k, v in b.items()}

    monkeypatch.setattr(train.Job, "batch", half)


def _unchanged_state(monkeypatch):
    """A train step that returns its state unchanged."""
    real = train.Job.update

    def frozen(self, idx, t):
        saved = {k: v.detach().clone()
                 for k, v in self.state["params"].items()}
        metrics = real(self, idx, t)
        with torch.no_grad():
            for k, v in self.state["params"].items():
                v.copy_(saved[k])
        return metrics

    monkeypatch.setattr(train.Job, "update", frozen)


@pytest.mark.parametrize("fault", [_half_batch, _unchanged_state])
def test_training_faults_are_not_correct(tiny, monkeypatch, fault):
    fault(monkeypatch)
    r, _, correct = measure(tiny, "msvd.train")
    assert not correct, r.compared


@pytest.mark.parametrize("side", ["float8", "shift_k"])
@pytest.mark.parametrize("cell", SERVE)
def test_serving_control_and_selection_fault_fail(tiny, cell, side):
    """Put in the program's place (its own beam search over the sampled
    videos), the control of the serving cells, the reference rounded to
    float8, and a selection fault, a top-k that leaves out each beam's k
    best candidates, come out not correct against the cell's limits. The
    fault scores its own tokens consistently, so only ``token_gap`` can
    catch it."""
    import time
    from gpubench.run import Context
    bench = harness.benchmark()
    ctx = Context(harness.cell(bench, cell), 5, 0.0, False, device="cpu",
                  start=time.perf_counter(), here=tiny)
    s = serve_bank.Served(ctx)
    rq = s.request()
    pick = serve_bank.sample(s.rng, [s.served(rq, s.call(rq))],
                             ctx.traffic["check_videos"])
    s.close()
    videos = [r for r, _, _ in pick]
    if side == "float8":
        got = serve_bank.compare(s, serve_bank.reference_served(
            s, videos, ref.Precision("float8")))
        assert any(got[k] > v for k, v in ctx.limits.items()), got
    else:
        got = serve_bank.compare(s, serve_bank.reference_served(
            s, videos, ref.Precision(),
            skip=ctx.config["decode"]["beam_size"]))
        assert got["score_gap"] < 1e-4, got
        assert got["token_gap"] > ctx.limits["token_gap"], got


def test_training_control_float8_fails(tiny):
    """The control of the training cell, the reference rounded to float8,
    in the program's place: not correct against the limits."""
    import time
    from gpubench.run import Context
    bench = harness.benchmark()
    ctx = Context(harness.cell(bench, "msvd.train"), 3, 0.0, False,
                  device="cpu", start=time.perf_counter(), here=tiny)
    job = train.Job(ctx)
    _, _, _, done = job.setup_updates()
    base = train.reference_side(job, done)
    f8 = train.reference_side(job, done, ref.Precision("float8"))
    got = train.gaps(job.params0, f8, base)
    assert any(v > ctx.limits[k] for k, v in got.items()), got


def test_result_line_keys(tiny):
    r, metrics, correct = measure(tiny, "msvd.serve.bank", trace=True)
    line = harness.result_line(correct, r, metrics, {"platform": "gpu"},
                               True)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "compared"]
    assert {"busy_s", "window_s", "memory_peak_bytes"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"}
    r, metrics, correct = measure(tiny, "msvd.train")
    line = harness.result_line(correct, r, metrics, {"platform": "gpu"},
                               False)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert set(line["metrics"]) == {"update_ms", "setup_s"}
