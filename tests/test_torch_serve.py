"""The port's HTTP serving daemon in live mode, against the JAX package.

The port's server runs over the port's run directory and its captions
are held against the JAX ``Captioner.from_run_dir`` of the sibling run
directory made from the same weights (``test_torch_cli.make_run_dirs``).
The HTTP layer's cases mirror tests/test_serve.py.  Every server listens
on port 0 in a daemon thread and is shut down in ``finally``; every
client request has a 30 s timeout.
"""

import argparse
import dataclasses
import http.client
import json
import threading

import numpy as np
import pytest

from stvd.api import Captioner as JCaptioner
from stvd_torch.api import Captioner
from stvd_torch.cli import serve
from stvd_torch.cli.serve import (CaptionServer, ThreadedCaptionServer,
                                  build_server, encode_npz_request,
                                  encode_raw_request, request_caption_ids,
                                  request_captions, request_nbest)
from stvd_torch.data.bank import synthetic_bank

from test_torch_cli import MCFG, make_run_dirs
from test_torch_step import numpy_params

TIMEOUT = 30.0


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_runs")
    jdir, tdir = make_run_dirs(root)
    bank = synthetic_bank(7, k=MCFG.n_frames, d=MCFG.ctx_dim, seed=4)
    bank = dataclasses.replace(bank, ids=[f"vid{i}" for i in range(7)])
    path = str(root / "bank.npz")
    bank.save(path)
    np.savez(str(root / "swap.npz"), **numpy_params(MCFG, seed=6))
    return jdir, tdir, path, str(root / "swap.npz")


@pytest.fixture(scope="module")
def jax_cap(run_dirs):
    return JCaptioner.from_run_dir(run_dirs[0])


def features(n, seed=0):
    return np.random.RandomState(seed).randn(
        n, MCFG.n_frames, MCFG.ctx_dim).astype(np.float32)


def server_args(run_dir, **kw):
    base = dict(artifact=None, run_dir=run_dir, bank=None, bank_shards=0,
                quant=None, device="cpu", host="127.0.0.1",
                port=0, no_warmup=True, coalesce_wait_ms=0.0,
                allow_swap=False, allow_shutdown=False, verbose=False)
    base.update(kw)
    return argparse.Namespace(**base)


class Srv:
    """Run a server on an ephemeral port in a daemon thread."""

    def __init__(self, server: CaptionServer):
        self.server = server
        self.port = server.server_port
        self.thread = threading.Thread(target=server.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        try:
            self.server.shutdown()
        finally:
            self.server.server_close()
            self.thread.join(timeout=10)


def get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


def post(port, path, body, content_type="application/json"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": content_type})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


def test_caption_over_every_wire_matches_jax(run_dirs, jax_cap):
    """raw, npz and JSON bodies of 5 videos (decode batch 3: a padded
    chunk through the HTTP layer) give the JAX Captioner's captions."""
    feats = features(5, seed=1)
    want = jax_cap.caption(feats)
    with Srv(build_server(server_args(run_dirs[1]))) as s:
        raw = request_captions("127.0.0.1", s.port, feats, timeout=TIMEOUT)
        npz = request_captions("127.0.0.1", s.port, feats, wire="npz",
                               timeout=TIMEOUT)
        st, obj = post(s.port, "/caption",
                       json.dumps({"features": feats.tolist()}))
    assert raw == npz == obj["captions"] == want
    assert st == 200 and obj["n"] == 5 and obj["ms"] >= 0


def test_nbest_matches_jax(run_dirs, jax_cap):
    feats = features(3, seed=2)
    want = jax_cap.nbest(feats, n=2)
    with Srv(build_server(server_args(run_dirs[1]))) as s:
        got = request_nbest("127.0.0.1", s.port, feats, n=2,
                            timeout=TIMEOUT)
        full = request_nbest("127.0.0.1", s.port, feats, timeout=TIMEOUT)
        caps = request_captions("127.0.0.1", s.port, feats, timeout=TIMEOUT)
    assert [[t for t, _ in v] for v in got] == [[t for t, _ in v]
                                                for v in want]
    np.testing.assert_allclose([[p for _, p in v] for v in got],
                               [[p for _, p in v] for v in want],
                               rtol=0, atol=1e-5)
    assert all(len(v) == 3 for v in full)
    assert [v[0][0] for v in full] == caps


def test_caption_ids_and_nbest_ids_with_a_bank(run_dirs, jax_cap):
    from stvd_torch.data.bank import FeatureBank
    _, tdir, bank_path, _ = run_dirs
    bank = FeatureBank.load(bank_path)
    ids = ["vid5", "vid0", "vid3", "vid6", "vid1"]
    rows = [int(v[3:]) for v in ids]
    with Srv(build_server(server_args(tdir, bank=bank_path))) as s:
        got = request_caption_ids("127.0.0.1", s.port, ids, timeout=TIMEOUT)
        st, nb = post(s.port, "/nbest_ids?n=2", json.dumps({"ids": ids[:2]}))
        st_bad, err = post(s.port, "/caption_ids",
                           json.dumps({"ids": ["vid99"]}))
        st_empty, _ = post(s.port, "/caption_ids", json.dumps({"ids": []}))
        st_man, man = get(s.port, "/manifest")
    # the bank's rows (already at K frames) through the feature path
    feats = [bank.frames[r][bank.frame_mask[r] > 0] for r in rows]
    assert got == jax_cap.caption(feats)
    assert st == 200 and nb["n"] == 2 and len(nb["nbest"][0]) == 2
    assert st_bad == 400 and "unknown video ids" in err["error"]
    assert st_empty == 400
    assert st_man == 200 and man["bank_videos"] == 7
    assert man["bank_ids"] == bank.ids and man["bank_shards"] == 0


def test_caption_ids_without_a_bank_is_400(run_dirs):
    with Srv(build_server(server_args(run_dirs[1]))) as s:
        st, err = post(s.port, "/caption_ids", json.dumps({"ids": ["vid0"]}))
    assert st == 400 and "no feature bank" in err["error"]


def test_swap_params_is_refused_without_the_flag_and_applied_with(
        run_dirs):
    _, tdir, _, swap = run_dirs
    feats = features(4, seed=3)
    fresh = Captioner(dict(np.load(swap)), Captioner.from_run_dir(
        tdir, device="cpu").cfg, Captioner.from_run_dir(
        tdir, device="cpu").vocab, device="cpu").caption(feats)
    with Srv(build_server(server_args(tdir))) as s:
        st, err = post(s.port, "/swap_params", json.dumps({"path": swap}))
        assert st == 403 and "--allow-swap" in err["error"]
    for wait in (0.0, 20.0):
        with Srv(build_server(server_args(tdir, allow_swap=True,
                                          coalesce_wait_ms=wait))) as s:
            before = request_captions("127.0.0.1", s.port, feats,
                                      timeout=TIMEOUT)
            st, obj = post(s.port, "/swap_params", json.dumps({"path": swap}))
            after = request_captions("127.0.0.1", s.port, feats,
                                     timeout=TIMEOUT)
            st_missing, _ = post(s.port, "/swap_params",
                                 json.dumps({"path": swap + ".none"}))
        assert st == 200 and obj == {"status": "swapped",
                                     "n_params": len(np.load(swap).files)}
        assert after == fresh and before != after
        assert st_missing == 400


def test_swap_params_rejects_another_architecture(run_dirs, tmp_path):
    _, tdir, _, swap = run_dirs
    bad = dict(np.load(swap))
    bad["ff_logit_b"] = np.zeros(3, np.float32)
    path = str(tmp_path / "bad.npz")
    np.savez(path, **bad)
    with Srv(build_server(server_args(tdir, allow_swap=True))) as s:
        st, err = post(s.port, "/swap_params", json.dumps({"path": path}))
    assert st == 400 and "shape mismatch" in err["error"]


def test_health_manifest_stats_and_errors(run_dirs):
    feats = features(2, seed=4)
    with Srv(build_server(server_args(run_dirs[1]))) as s:
        st, h = get(s.port, "/healthz")
        assert (st, h) == (200, {"status": "ok", "mode": "live",
                                 "requests_served": 0})
        st, man = get(s.port, "/manifest")
        assert st == 200 and man["mode"] == "live"
        assert (man["beam_size"], man["decode_batch"], man["maxlen"]) == \
            (3, 3, 8)
        st, err = post(s.port, "/caption", b"x", "text/plain")
        assert st == 400 and "Content-Type" in err["error"]
        st, err = post(s.port, "/caption", json.dumps({"regions": [[1.0]]}))
        assert st == 400 and "features" in err["error"]
        st, err = post(s.port, "/caption",
                       json.dumps({"features": [[1.0, 2.0]]}))
        assert st == 400 and "(N, F, D)" in err["error"]
        st, err = post(s.port, "/caption", json.dumps({
            "features": feats.tolist(),
            "regions": np.zeros((1, 2, 3, 4)).tolist()}))
        assert st == 400 and "regions" in err["error"]
        assert get(s.port, "/nope")[0] == 404
        assert post(s.port, "/nope", b"")[0] == 404
        request_captions("127.0.0.1", s.port, feats, timeout=TIMEOUT)
        request_nbest("127.0.0.1", s.port, feats, timeout=TIMEOUT)
        assert get(s.port, "/healthz")[1]["requests_served"] == 2
        st, stats = get(s.port, "/stats")
    assert st == 200 and stats["requests_served"] == 2
    for route in ("caption", "nbest"):
        assert set(stats[route]) == {"count", "videos", "min_ms", "p50_ms",
                                     "p95_ms"}
        assert stats[route]["count"] == 1 and stats[route]["videos"] == 2
    assert "coalesce" not in stats


def test_raw_wire_fuzz_is_400_never_500(run_dirs):
    feats = features(1)
    valid = b"".join(bytes(c) for c in encode_raw_request(feats))
    header = json.dumps({"features": [[-1, 6, 32], "float32"]}).encode()
    rng = np.random.RandomState(0)
    bodies = [b"", b"\0", b"\xff" * 8, rng.bytes(64), valid[:3],
              valid[:20], valid[:-1],
              (len(valid) * 2).to_bytes(4, "big") + valid[4:],
              len(header).to_bytes(4, "big") + header + b"\0" * 768,
              len(b'{"x": [[1], "float32"]}').to_bytes(4, "big")
              + b'{"x": [[1], "float32"]}' + b"\0" * 4]
    with Srv(build_server(server_args(run_dirs[1]))) as s:
        for body in bodies:
            st, obj = post(s.port, "/caption", body, "application/x-stvd-raw")
            assert st == 400, (st, obj, body[:16])
        assert request_captions("127.0.0.1", s.port, feats, timeout=TIMEOUT)
        # a truncated zip is no ValueError: 500, as the JAX server says
        st, obj = post(s.port, "/caption", encode_npz_request(feats)[:-9],
                       "application/x-npz")
        assert st == 500 and "BadZipFile" in obj["error"]


def test_concurrent_clients_get_the_serial_captions(run_dirs):
    """6 clients at once under --coalesce-wait-ms 20: each gets the
    captions the Captioner gives its videos alone."""
    _, tdir, _, _ = run_dirs
    payloads = [features(1 + i % 3, seed=10 + i) for i in range(6)]
    cap = Captioner.from_run_dir(tdir, device="cpu")
    want = [cap.caption(p) for p in payloads]
    srv = build_server(server_args(tdir, coalesce_wait_ms=20.0))
    assert isinstance(srv, ThreadedCaptionServer) and srv.coalescer
    with Srv(srv) as s:
        got = concurrent(s.port, payloads)
        _, stats = get(s.port, "/stats")
    assert got == want
    assert stats["coalesce"]["requests"] == 6
    assert stats["coalesce"]["videos"] == sum(len(p) for p in payloads)


def test_warmup_and_quant(run_dirs):
    srv = build_server(server_args(run_dirs[1], quant="int8"))
    try:
        assert srv.captioner.cfg.model.decode_quant == "int8"
        assert srv.warmup() > 0
        with Srv(srv) as s:
            assert len(request_captions("127.0.0.1", s.port, features(2),
                                        timeout=TIMEOUT)) == 2
    finally:
        srv.server_close()


def test_shutdown_endpoint(run_dirs):
    srv = build_server(server_args(run_dirs[1]))
    with Srv(srv) as s:
        st, err = post(s.port, "/shutdown", b"")
        assert st == 403 and "--allow-shutdown" in err["error"]
    srv = build_server(server_args(run_dirs[1], allow_shutdown=True))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        st, obj = post(srv.server_port, "/shutdown", b"")
        assert st == 200 and obj["status"] == "shutting down"
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    finally:
        srv.server_close()


@pytest.mark.parametrize("kw,what", [
    ({"artifact": "a", "run_dir": None}, "item 7"),
    ({"bank_shards": 2}, "item 8")])
def test_unported_modes_raise(run_dirs, kw, what):
    _, tdir, bank, _ = run_dirs
    with pytest.raises(NotImplementedError, match=what):
        build_server(server_args(**{"run_dir": tdir, "bank": bank, **kw}))


def test_build_server_requires_exactly_one_source(run_dirs):
    for kw in ({"run_dir": None}, {"artifact": "a"}):
        with pytest.raises(ValueError, match="exactly one"):
            build_server(server_args(**{"run_dir": run_dirs[1], **kw}))


def test_main_parses_the_jax_flags(run_dirs, monkeypatch):
    seen = {}

    def fake_build(args):
        seen.update(vars(args))
        raise SystemExit(0)

    monkeypatch.setattr(serve, "build_server", fake_build)
    with pytest.raises(SystemExit):
        serve.main(["--run-dir", run_dirs[1], "--bank", "b.npz",
                    "--coalesce-wait-ms", "5", "--allow-swap", "--device",
                    "cpu", "--quant", "int8", "--port", "0"])
    assert seen["device"] == "cpu" and seen["coalesce_wait_ms"] == 5.0
    assert seen["allow_swap"] and seen["bank"] == "b.npz"


# ---- the coalescer on a stub captioner (mirrors tests/test_serve.py) --------

class StubCaptioner:
    """Counts device calls; captions encode (F, sum) so per-request
    routing is checkable.  Raises for F == ``poison_f``."""

    def __init__(self, poison_f=None):
        self.calls = []
        self.poison_f = poison_f
        self._lock = threading.Lock()

    def caption(self, features, regions=None, motion=None):
        with self._lock:
            self.calls.append((len(features), features.shape[1]))
        if self.poison_f is not None and features.shape[1] == self.poison_f:
            raise ValueError("poisoned group")
        return [f"f{features.shape[1]}:{float(features[i].sum()):.0f}"
                for i in range(len(features))]

    def _rows_for(self, ids):
        bad = [v for v in ids if not v.startswith("vid")]
        if bad:
            raise ValueError(f"unknown video ids: {bad}")

    def caption_ids(self, ids):
        self._rows_for(ids)
        with self._lock:
            self.calls.append((len(ids), "ids"))
        return [f"id:{v}" for v in ids]


def concurrent(port, payloads, ids=False):
    """Each payload from its own thread; results (or the exception) in
    submission order."""
    results = [None] * len(payloads)
    barrier = threading.Barrier(len(payloads))

    def run(i, p):
        barrier.wait(timeout=TIMEOUT)
        try:
            results[i] = (request_caption_ids("127.0.0.1", port, p,
                                              timeout=TIMEOUT) if ids else
                          request_captions("127.0.0.1", port, p,
                                           timeout=TIMEOUT))
        except Exception as e:
            results[i] = e

    threads = [threading.Thread(target=run, args=(i, p), daemon=True)
               for i, p in enumerate(payloads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * TIMEOUT)
    return results


def test_coalescer_batches_concurrent_requests():
    stub = StubCaptioner()
    payloads = [np.full((1, 6, 8), float(i), np.float32) for i in range(4)]
    with Srv(ThreadedCaptionServer(stub, port=0,
                                   coalesce_wait_ms=300.0)) as s:
        results = concurrent(s.port, payloads)
        _, stats = get(s.port, "/stats")
    for i, got in enumerate(results):
        assert got == [f"f6:{float(payloads[i].sum()):.0f}"], (i, got)
    assert sum(n for n, _ in stub.calls) == 4 and len(stub.calls) < 4
    assert stats["coalesce"]["max_requests_per_dispatch"] >= 2


def test_coalescer_groups_by_signature():
    stub = StubCaptioner()
    payloads = [np.full((1, 6, 8), 1.0, np.float32),
                np.full((1, 7, 8), 2.0, np.float32),
                np.full((1, 6, 8), 3.0, np.float32)]
    with Srv(ThreadedCaptionServer(stub, port=0,
                                   coalesce_wait_ms=300.0)) as s:
        results = concurrent(s.port, payloads)
    assert results == [["f6:48"], ["f7:112"], ["f6:144"]]
    assert sum(n for n, f in stub.calls if f == 6) == 2
    assert sum(n for n, f in stub.calls if f == 7) == 1


def test_coalescer_group_error_is_isolated():
    stub = StubCaptioner(poison_f=7)
    good = np.full((1, 6, 8), 1.0, np.float32)
    bad = np.full((1, 7, 8), 2.0, np.float32)
    with Srv(ThreadedCaptionServer(stub, port=0,
                                   coalesce_wait_ms=300.0)) as s:
        results = concurrent(s.port, [good, bad])
        again = request_captions("127.0.0.1", s.port, good, timeout=TIMEOUT)
    assert results[0] == ["f6:48"] == again
    assert isinstance(results[1], RuntimeError)
    assert "500" in str(results[1]) and "poisoned" in str(results[1])


def test_coalescer_batches_id_requests_and_rejects_unknown_ids_alone():
    stub = StubCaptioner()
    payloads = [["vid1", "vid2"], ["vid3"], ["bad"]]
    with Srv(ThreadedCaptionServer(stub, port=0,
                                   coalesce_wait_ms=300.0)) as s:
        results = concurrent(s.port, payloads, ids=True)
    assert results[0] == ["id:vid1", "id:vid2"]
    assert results[1] == ["id:vid3"]
    assert isinstance(results[2], RuntimeError) and "400" in str(results[2])
    assert [c for c in stub.calls if c[1] == "ids"] == [(3, "ids")]


def test_single_threaded_server_has_no_coalescer():
    assert CaptionServer(StubCaptioner(), port=0,
                         coalesce_wait_ms=50.0).coalescer is None
