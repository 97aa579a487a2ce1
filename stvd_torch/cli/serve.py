"""Local captioning server over an exported artifact or a live run
directory (counterpart of stvd/cli/serve.py, with its routes, status
codes and JSON keys).

    python -m stvd_torch.cli.serve --artifact artifacts/msvd \
        [--params weights.npz] [--bank bank.npz] [--device cpu]
    python -m stvd_torch.cli.serve --run-dir runs/msvd [--quant int8]
        [--bank bank.npz] [--coalesce-wait-ms W] [--device cpu]

Endpoints (all JSON responses):

    GET  /healthz    {"status": "ok", "mode": "aot" | "live",
                      "requests_served": N}
    GET  /manifest   the artifact's manifest, or a config summary (and
                     the resident bank's ids)
    GET  /stats      per-route serving stats over a sliding window:
                     {route: {count, videos, min_ms, p50_ms, p95_ms}, ...}
    POST /caption    body is ONE OF
                     - ``application/x-stvd-raw``: 4-byte header length
                       + JSON {name: [shape, dtype]} + raw C-order
                       buffers (``features`` (N, F, D) float32, optional
                       ``regions`` (N, F, R, Dr) / ``motion`` (N, F,
                       Dm)) — zero-copy parse, the production format;
                     - ``application/x-npz``: the same arrays as an .npz;
                     - ``application/json``: nested lists.
                     -> {"captions": [str, ...], "n": N, "ms": float}
    POST /nbest      same body (+ optional ``?n=K`` query) -> ranked
                     hypothesis lists per video:
                     {"nbest": [[[text, logprob], ...], ...], ...}
                     (an artifact serves it from its n-best graphs, and
                     answers 400 without them)
    POST /caption_ids  (with ``--bank``) body {"ids": [video_id, ...]}
                     -> captions of videos whose features are resident on
                     the device: the request carries ids, not features.
                     /nbest_ids is the n-best analogue.
    POST /swap_params  (with ``--allow-swap``) body {"path": "x.npz"}
                     -> swap in same-architecture weights mid-run; the
                     resident bank and the listener stay up.
    POST /shutdown   (with ``--allow-shutdown``) a clean exit without a
                     signal.

The server is single-threaded by default: there is one card, and decode
requests would only contend on it, so the socket queue is the request
queue.  ``--coalesce-wait-ms W`` switches to a threaded server with
cross-request batching: concurrent /caption (and /caption_ids) requests
that arrive within a W-ms window are concatenated into one device call
and the captions split back per request.  Every request then pays up to
W ms of collection latency; device calls stay serialized on one lock.
Requests with different trailing shapes or stream sets dispatch as
separate groups, so a malformed group never poisons another.  The
kernels build at first use, so ``warmup`` runs before the listener
accepts requests.

``--artifact`` serves the graphs of ``stvd_torch.cli.export`` (mode
"aot"): weights are call-time inputs, so ``--params`` and /swap_params
change them without re-export; quantization is baked in at export time
(``--quant`` is refused).

A daemon of several ranks (``torchrun --nproc-per-node W -m
stvd_torch.cli.serve ...``) serves a bank sharded over N of them
(``--bank-shards N``: a 1-D data mesh in live mode or under a one-device
artifact, the artifact's own mesh, whose data degree must be N, under a
sharded one) or a sharded artifact.  It is SPMD: rank 0 owns the
listener and the files, the other ranks bind no socket and follow, and
every call that touches the mesh (the warm-up, /caption_ids,
/nbest_ids, /caption and /nbest of a sharded artifact, /swap_params with
rank 0's arrays, /shutdown) is broadcast from rank 0 in the order rank 0
makes it, under one lock, after rank 0 has validated the request (an
unknown id is a 400 and nothing is sent).  /caption of raw features in
live mode decodes on rank 0 alone.  An error that every rank raises
alike (a ValueError) is answered once by rank 0; any other error of a
mesh call, or a rank that stops answering (rank 0 sends a heartbeat
while idle), ends the daemon with a non-zero exit.

``request_captions`` is the matching client helper (raw wire format by
default; ``wire='npz'`` for the portable container).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import socketserver
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Dict, List, Optional, Sequence

import numpy as np

_STREAM_KEYS = ("features", "regions", "motion")


class _Pending:
    """One in-flight /caption request parked in the coalescer."""

    __slots__ = ("arrays", "event", "result", "error")

    def __init__(self, arrays: Dict):
        self.arrays = arrays
        self.event = threading.Event()
        self.result: Optional[List[str]] = None
        self.error: Optional[Exception] = None


class _Coalescer:
    """Cross-request batching for the threaded server: the first
    request to arrive becomes the LEADER, sleeps ``wait_ms`` collecting
    followers, then concatenates every compatible request into one
    ``captioner.caption`` call and splits the captions back.  Device
    calls are serialized on ``_dev_lock`` (one card); requests whose
    trailing shapes / stream sets differ dispatch as separate groups
    inside the same window."""

    def __init__(self, captioner, wait_ms: float):
        self.captioner = captioner
        self.wait_s = wait_ms / 1e3
        self._lock = threading.Lock()
        self._queue: List[_Pending] = []
        self._leader_active = False
        self._dev_lock = threading.Lock()
        # running counters, not a per-dispatch list: a long-lived daemon
        # would grow (and /stats would re-scan) the list forever
        self._stats_lock = threading.Lock()
        self.n_dispatches = 0
        self.n_requests = 0
        self.n_videos = 0
        self.max_requests_per_dispatch = 0

    def submit(self, arrays: Dict) -> List[str]:
        p = _Pending(arrays)
        with self._lock:
            self._queue.append(p)
            lead = not self._leader_active
            if lead:
                self._leader_active = True
        if lead:
            time.sleep(self.wait_s)          # collection window
            with self._lock:
                batch, self._queue = self._queue, []
                self._leader_active = False  # next arrival leads anew
            self._dispatch(batch)
        # leader's own event is set inside _dispatch; followers park
        # here until their leader (or the next one) serves them
        if not p.event.wait(timeout=600.0):
            raise RuntimeError("coalesced request timed out (600s)")
        if p.error is not None:
            raise p.error
        return p.result

    @staticmethod
    def _n_videos(p: _Pending) -> int:
        a = p.arrays
        return len(a["ids"]) if "ids" in a else len(a["features"])

    def _dispatch(self, batch: List[_Pending]) -> None:
        groups: Dict[tuple, List[_Pending]] = {}
        for p in batch:
            # bank-resident requests ({"ids": [...]}) are homogeneous —
            # one group; feature requests group by stream/shape key
            key = ("ids",) if "ids" in p.arrays else tuple(
                (k, p.arrays[k].shape[1:]) if k in p.arrays
                else (k, None) for k in _STREAM_KEYS)
            groups.setdefault(key, []).append(p)
        with self._dev_lock:
            for key, members in groups.items():
                try:
                    if key == ("ids",):
                        # ids are pre-validated by the handler (unknown
                        # ids 400 the requester before coalescing, so a
                        # bad id can never 500 innocent peers)
                        ids = [v for p in members for v in p.arrays["ids"]]
                        caps = self.captioner.caption_ids(ids)
                    else:
                        feats = np.concatenate(
                            [p.arrays["features"] for p in members])
                        kw = {k: np.concatenate([p.arrays[k]
                                                 for p in members])
                              for k in ("regions", "motion")
                              if k in members[0].arrays}
                        caps = self.captioner.caption(feats, **kw)
                    off = 0
                    for p in members:
                        n = self._n_videos(p)
                        p.result = caps[off:off + n]
                        off += n
                except Exception as e:   # the group fails together;
                    # wrap so a device-side ValueError is not mapped to
                    # HTTP 400 for innocent coalesced peers — a group
                    # failure is server-side and must surface as a 500
                    err = RuntimeError(
                        f"coalesced group failed "
                        f"({type(e).__name__}: {e})")
                    for p in members:    # other groups are unaffected
                        if p.result is None:
                            p.error = err
                finally:
                    for p in members:
                        p.event.set()
        with self._stats_lock:
            self.n_dispatches += 1
            self.n_requests += len(batch)
            self.n_videos += sum(self._n_videos(p) for p in batch)
            self.max_requests_per_dispatch = max(
                self.max_requests_per_dispatch, len(batch))


def _parse_raw_body(body: bytes) -> Dict:
    """``application/x-stvd-raw``: 4-byte big-endian header length, a
    JSON header {name: [shape, dtype]} in buffer order, then the raw
    C-order buffers concatenated.  Arrays are zero-copy views into the
    received body (np.frombuffer), with none of the npz container's CRC
    and copies."""
    if len(body) < 4:
        raise ValueError("raw body too short for header length")
    hlen = int.from_bytes(body[:4], "big")
    header = json.loads(body[4: 4 + hlen].decode("utf-8"))
    off = 4 + hlen
    arrays = {}
    for name, (shape, dtype) in header.items():
        if name not in _STREAM_KEYS:
            raise ValueError(f"unknown stream {name!r}")
        dt = np.dtype(dtype)
        if dt.kind not in "fiu":
            raise ValueError(f"{name}: non-numeric dtype {dtype!r}")
        if not shape or any(int(d) < 1 for d in shape):
            raise ValueError(f"{name}: invalid shape {shape}")
        count = int(np.prod(shape))
        need = off + count * dt.itemsize
        if need > len(body):
            raise ValueError(f"{name}: body truncated "
                             f"({need} > {len(body)} bytes)")
        arrays[name] = np.frombuffer(body, dt, count, off).reshape(shape)
        off = need
    return arrays


def _parse_caption_body(body: bytes, content_type: str) -> Dict:
    """Decode a /caption request body into {features, regions, motion}
    numpy arrays (regions/motion may be absent)."""
    ct = (content_type or "").split(";")[0].strip().lower()
    if ct == "application/x-stvd-raw":
        arrays = _parse_raw_body(body)
    elif ct == "application/x-npz":
        with np.load(io.BytesIO(body), allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files if k in _STREAM_KEYS}
    elif ct == "application/json":
        obj = json.loads(body.decode("utf-8"))
        arrays = {k: np.asarray(obj[k], dtype=np.float32)
                  for k in _STREAM_KEYS if obj.get(k) is not None}
    else:
        raise ValueError(f"unsupported Content-Type {content_type!r} "
                         "(use application/x-stvd-raw, application/x-npz "
                         "or application/json)")
    if "features" not in arrays:
        raise ValueError("request must contain 'features' (N, F, D)")
    feats = arrays["features"]
    if feats.ndim != 3:
        raise ValueError(f"features must be (N, F, D); got {feats.shape}")
    n = feats.shape[0]
    for k, want_ndim in (("regions", 4), ("motion", 3)):
        a = arrays.get(k)
        if a is None:
            continue
        if a.ndim != want_ndim or a.shape[0] != n:
            raise ValueError(f"{k} must be rank {want_ndim} with leading "
                             f"dim {n}; got {a.shape}")
    return arrays


class _Handler(BaseHTTPRequestHandler):
    # the captioner/state ride on the server object, not the handler
    # (one handler instance per request)
    server: "CaptionServer"

    def _reply(self, code: int, obj: Dict) -> None:
        data = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args):  # stdout noise -> opt-in
        if self.server.verbose:
            sys.stderr.write("%s - %s\n" % (self.address_string(),
                                            fmt % args))

    def do_GET(self):
        if self.path == "/healthz":
            self._reply(200, {"status": "ok", "mode": self.server.mode,
                              "requests_served": self.server.served})
        elif self.path == "/manifest":
            self._reply(200, self.server.manifest)
        elif self.path == "/stats":
            self._reply(200, self.server.stats_summary())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        from urllib.parse import parse_qs, urlparse
        url = urlparse(self.path)
        if url.path == "/shutdown":
            # clean exit without a signal (opt-in): scripted runs stop
            # the daemon here
            if not self.server.allow_shutdown:
                self._reply(403, {"error": "start with --allow-shutdown"})
                return
            self._reply(200, {"status": "shutting down"})
            threading.Thread(target=self.server.shutdown,
                             daemon=True).start()
            return
        if url.path == "/swap_params":
            # mid-run weight swap (opt-in): body {"path": "weights.npz"}
            # of same-architecture params — the bank stays loaded and
            # in-flight requests finish on the old weights (the device
            # lock serializes the assignment against dispatches)
            if not self.server.allow_swap:
                self._reply(403, {"error": "start with --allow-swap"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                obj = json.loads(self.rfile.read(length).decode("utf-8"))
                path = obj.get("path")
                if not isinstance(path, str) or not os.path.exists(path):
                    raise ValueError(f"no such params file: {path!r}")
                with np.load(path) as z:
                    params = {k: z[k] for k in z.files}
                coal = self.server.coalescer
                if coal is not None:
                    with coal._dev_lock:
                        self.server.captioner.swap_params(params)
                else:
                    self.server.captioner.swap_params(params)
                self._reply(200, {"status": "swapped",
                                  "n_params": len(params)})
            except (ValueError, KeyError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        if url.path in ("/caption_ids", "/nbest_ids"):
            # bank-resident mode: the request names videos whose
            # features already live on the device (serve --bank) —
            # bytes of ids in, bytes of text out, no feature transfer
            try:
                length = int(self.headers.get("Content-Length", "0"))
                obj = json.loads(self.rfile.read(length).decode("utf-8"))
                ids = obj.get("ids")
                if not isinstance(ids, list) or not ids \
                        or not all(isinstance(v, str) for v in ids):
                    raise ValueError(
                        "body must be {\"ids\": [video_id, ...]}")
                coal = self.server.coalescer
                t0 = time.perf_counter()
                if url.path == "/caption_ids":
                    if coal is not None:
                        # validate BEFORE coalescing: an unknown id is
                        # THIS client's 400, and must never surface as
                        # a group failure to coalesced peers
                        self.server.captioner._rows_for(ids)
                        caps = coal.submit({"ids": ids})
                    else:
                        caps = self.server.captioner.caption_ids(ids)
                    resp = {"captions": caps, "n": len(caps)}
                else:
                    q = parse_qs(url.query)
                    n = int(q["n"][0]) if q.get("n") else None
                    if coal is not None:
                        with coal._dev_lock:
                            hyps = self.server.captioner.nbest_ids(
                                ids, n=n)
                    else:
                        hyps = self.server.captioner.nbest_ids(ids, n=n)
                    resp = {"nbest": [[[t, s] for t, s in video]
                                      for video in hyps], "n": len(hyps)}
                ms = (time.perf_counter() - t0) * 1e3
                resp["ms"] = round(ms, 3)
                with self.server.stats_lock:
                    self.server.served += 1
                self.server.record(url.path.lstrip("/"), len(ids), ms)
                self._reply(200, resp)
            except (ValueError, KeyError) as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        if url.path not in ("/caption", "/nbest"):
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = self.rfile.read(length)
            arrays = _parse_caption_body(
                body, self.headers.get("Content-Type", ""))
            kwargs = dict(regions=arrays.get("regions"),
                          motion=arrays.get("motion"))
            coal = self.server.coalescer
            t0 = time.perf_counter()
            if url.path == "/caption":
                if coal is not None:
                    captions = coal.submit(arrays)
                else:
                    captions = self.server.captioner.caption(
                        arrays["features"], **kwargs)
                resp = {"captions": captions, "n": len(captions)}
            else:
                q = parse_qs(url.query)
                n = int(q["n"][0]) if q.get("n") else None
                if coal is not None:
                    # threaded mode: n-best calls share the device lock
                    with coal._dev_lock:
                        hyps = self.server.captioner.nbest(
                            arrays["features"], n=n, **kwargs)
                else:
                    hyps = self.server.captioner.nbest(
                        arrays["features"], n=n, **kwargs)
                resp = {"nbest": [[[t, s] for t, s in video]
                                  for video in hyps], "n": len(hyps)}
            ms = (time.perf_counter() - t0) * 1e3
            resp["ms"] = round(ms, 3)
            with self.server.stats_lock:
                self.server.served += 1
            self.server.record(url.path.lstrip("/"),
                               len(arrays["features"]), ms)
            self._reply(200, resp)
        except (ValueError, KeyError) as e:
            self._reply(400, {"error": str(e)})
        except Exception as e:  # surface, don't kill the daemon
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})


class CaptionServer(HTTPServer):
    """HTTP server bound to any object with a
    ``caption(features, regions=..., motion=...) -> [str]`` method
    (``api.Captioner``)."""

    # http.server's default listen backlog (5) makes a burst of
    # pipelined clients eat SYN-retransmit delays on the single-threaded
    # server, where the socket queue IS the request queue by design
    request_queue_size = 128

    def __init__(self, captioner, host: str = "127.0.0.1", port: int = 0,
                 mode: str = "live", manifest: Optional[Dict] = None,
                 verbose: bool = False, allow_shutdown: bool = False,
                 coalesce_wait_ms: float = 0.0,
                 allow_swap: bool = False):
        super().__init__((host, port), _Handler)
        self.captioner = captioner
        self.mode = mode
        self.manifest = manifest or {}
        self.verbose = verbose
        self.allow_shutdown = allow_shutdown
        self.allow_swap = allow_swap
        self.served = 0
        self.stats_lock = threading.Lock()
        self._lat = {}       # route -> deque of (n_videos, ms)
        # cross-request batching only makes sense with handler threads;
        # the base (single-threaded) server leaves it off
        self.coalescer = (_Coalescer(captioner, coalesce_wait_ms)
                          if coalesce_wait_ms > 0
                          and isinstance(self, socketserver.ThreadingMixIn)
                          else None)

    def record(self, route: str, n_videos: int, ms: float) -> None:
        from collections import deque
        with self.stats_lock:
            self._lat.setdefault(route, deque(maxlen=1000)).append(
                (n_videos, ms))

    def stats_summary(self) -> Dict:
        """Per-route latency percentiles over the sliding window (the
        number an operator checks before blaming the model)."""
        # snapshot under the lock: handler threads mutate _lat (dict
        # insert in record(), deque append) concurrently with /stats
        with self.stats_lock:
            out: Dict = {"requests_served": self.served}
            snap = {route: list(samples)
                    for route, samples in self._lat.items()}
        for route, samples in snap.items():
            ms = sorted(m for _, m in samples)
            vids = sum(n for n, _ in samples)
            out[route] = {
                "count": len(ms),
                "videos": vids,
                "min_ms": round(ms[0], 3),
                "p50_ms": round(ms[len(ms) // 2], 3),
                "p95_ms": round(ms[max(0, int(len(ms) * 0.95) - 1)], 3),
            }
        c = self.coalescer
        if c is not None:
            with c._stats_lock:
                if c.n_dispatches:
                    out["coalesce"] = {
                        "dispatches": c.n_dispatches,
                        "requests": c.n_requests,
                        "videos": c.n_videos,
                        "max_requests_per_dispatch":
                            c.max_requests_per_dispatch,
                    }
        return out

    def warmup(self) -> float:
        """One zeros-batch caption a batch size (``_warm``; on every rank
        of a daemon of several), so the kernels are built and the first
        real request never pays first-call costs.  Returns wall
        seconds."""
        sizes = self.manifest.get("batch_sizes") or [
            self.captioner.cfg.decode.decode_batch]
        t0 = time.perf_counter()
        if isinstance(self.captioner, _MeshCalls):
            self.captioner.warmup(sizes)
        else:
            _warm(self.captioner, sizes)
        return time.perf_counter() - t0


class ThreadedCaptionServer(socketserver.ThreadingMixIn, CaptionServer):
    """Handler-per-thread variant used by ``--coalesce-wait-ms``: HTTP
    parsing overlaps while the coalescer batches concurrent /caption
    requests into one device call (device access stays serialized on
    the coalescer's lock — one card)."""

    daemon_threads = True


def _request_arrays(features, regions=None, motion=None) -> Dict:
    arrays = {"features": np.ascontiguousarray(features, np.float32)}
    if regions is not None:
        arrays["regions"] = np.ascontiguousarray(regions, np.float32)
    if motion is not None:
        arrays["motion"] = np.ascontiguousarray(motion, np.float32)
    return arrays


def encode_npz_request(features, regions=None, motion=None) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **_request_arrays(features, regions, motion))
    return buf.getvalue()


def encode_raw_request(features, regions=None, motion=None) -> List:
    """Encode for ``application/x-stvd-raw`` as a CHUNK LIST (http.client
    sends each chunk without a concatenating copy; the server parses
    buffers zero-copy via np.frombuffer)."""
    arrays = _request_arrays(features, regions, motion)
    header = json.dumps({k: [list(a.shape), str(a.dtype)]
                         for k, a in arrays.items()}).encode("utf-8")
    return [len(header).to_bytes(4, "big"), header] \
        + [memoryview(a).cast("B") for a in arrays.values()]


def _post_request(host: str, port: int, path: str, features, regions,
                  motion, wire: str, timeout: float) -> Dict:
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        if wire == "raw":
            chunks = encode_raw_request(features, regions, motion)
            total = sum(len(c) for c in chunks)
            # iterable bodies need an explicit Content-Length (the
            # point of the chunk list: no concatenating client copy)
            conn.request("POST", path, body=iter(chunks),
                         headers={"Content-Type": "application/x-stvd-raw",
                                  "Content-Length": str(total)})
        elif wire == "npz":
            conn.request("POST", path,
                         body=encode_npz_request(features, regions, motion),
                         headers={"Content-Type": "application/x-npz"})
        else:
            raise ValueError(f"wire must be 'raw' or 'npz': {wire!r}")
        resp = conn.getresponse()
        obj = json.loads(resp.read().decode("utf-8"))
        if resp.status != 200:
            raise RuntimeError(f"server error {resp.status}: "
                               f"{obj.get('error')}")
        return obj
    finally:
        conn.close()


def request_captions(host: str, port: int, features, regions=None,
                     motion=None, timeout: float = 300.0,
                     wire: str = "raw") -> List[str]:
    """Client helper: POST /caption (default: the zero-copy raw wire
    format; ``wire='npz'`` for the portable container)."""
    return _post_request(host, port, "/caption", features, regions,
                         motion, wire, timeout)["captions"]


def request_nbest(host: str, port: int, features, regions=None,
                  motion=None, n: Optional[int] = None,
                  timeout: float = 300.0,
                  wire: str = "raw") -> List[List[tuple]]:
    """Client helper: POST /nbest -> per-video [(text, logprob), ...]."""
    path = f"/nbest?n={n}" if n else "/nbest"
    obj = _post_request(host, port, path, features, regions, motion,
                        wire, timeout)
    return [[(t, s) for t, s in video] for video in obj["nbest"]]


def request_caption_ids(host: str, port: int, ids: Sequence[str],
                        timeout: float = 300.0) -> List[str]:
    """Client helper: POST /caption_ids (bank-resident serving — the
    request is a JSON id list, no feature payload)."""
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        body = json.dumps({"ids": list(ids)}).encode("utf-8")
        conn.request("POST", "/caption_ids", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        obj = json.loads(resp.read().decode("utf-8"))
        if resp.status != 200:
            raise RuntimeError(f"server error {resp.status}: "
                               f"{obj.get('error')}")
        return obj["captions"]
    finally:
        conn.close()


def _attach_bank(cap, bank_path: str, manifest: Dict,
                 shards: int = 0) -> None:
    from ..data.bank import FeatureBank
    from ..train import parallel
    mesh = None
    if shards and shards > 1:
        # a sharded artifact's bank rides its serving mesh (whose data
        # degree must be N); otherwise a 1-D data mesh over N ranks
        mesh = getattr(cap, "_mesh", None)
        if mesh is not None:
            if parallel.axis_size(mesh) != shards:
                raise ValueError(
                    f"--bank-shards {shards} != the artifact's "
                    f"data-parallel degree {parallel.axis_size(mesh)} "
                    "(a sharded bank rides the artifact's serving mesh)")
        else:
            world = parallel.visible_ranks()
            if world != shards:
                raise ValueError(f"--bank-shards {shards} needs {shards} "
                                 f"devices; {world} visible")
            mesh = parallel.make_mesh(cap.device.type)
    n = cap.attach_bank(FeatureBank.load(bank_path), mesh=mesh)
    manifest["bank_videos"] = n
    manifest["bank_ids"] = cap.bank_ids
    manifest["bank_shards"] = int(shards or 0)
    _say(f"bank resident: {n} videos from {bank_path} "
         + (f"sharded over {shards} ranks " if mesh is not None else "")
         + "(POST /caption_ids)")


def _say(*args) -> None:
    """print on rank 0 (or a lone process) only."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(*args)


def _warm(captioner, sizes: Sequence[int]) -> None:
    """One zeros-batch caption a size, so the kernels are built and the
    first real request never pays first-call costs."""
    m = captioner.cfg.model
    for b in sizes:
        feats = np.zeros((b, m.n_frames, m.ctx_dim), np.float32)
        regs = (np.zeros((b, m.n_frames, m.n_regions, m.region_dim),
                         np.float32) if m.use_spatial else None)
        mots = (np.zeros((b, m.n_frames, m.motion_dim), np.float32)
                if m.use_motion else None)
        captioner.caption(feats, regions=regs, motion=mots)
    if captioner.device.type == "cuda":
        import torch
        torch.cuda.synchronize(captioner.device)


class _Slot:
    """A tensor's place in a broadcast message: its shape and dtype."""

    def __init__(self, t):
        self.shape, self.dtype = tuple(t.shape), t.dtype


def _map(tree, kind, fn):
    """``tree`` (dicts, lists, tuples) with each leaf of type ``kind``
    replaced by ``fn(leaf)``, in order."""
    if isinstance(tree, kind):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, kind, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, kind, fn) for v in tree)
    return tree


def _send(mesh, msg) -> None:
    """Rank 0's message ``(name, args, kwargs)`` to every rank: its plain
    values pickled in one broadcast, its tensors broadcast in place."""
    import torch
    from ..train import parallel
    tensors: List = []

    def slot(t):
        tensors.append(t.contiguous())
        return _Slot(t)

    parallel.broadcast_object(_map(msg, torch.Tensor, slot), mesh)
    if tensors:
        parallel.replicate(tensors, mesh)


def _receive(mesh, device):
    """The message of rank 0's ``_send``, its tensors on ``device``."""
    import torch
    from ..train import parallel
    tensors: List = []

    def tensor(sl):
        tensors.append(torch.empty(sl.shape, dtype=sl.dtype, device=device))
        return tensors[-1]

    msg = _map(parallel.broadcast_object(None, mesh), _Slot, tensor)
    if tensors:
        parallel.replicate(tensors, mesh)      # fills them in place
    return msg


# idle seconds between rank 0's heartbeats: a follower waits in a
# collective, which fails after the group's timeout without one
_HEARTBEAT_S = 10.0


class _MeshCalls:
    """Rank 0's captioner in a daemon of several ranks: each call that
    touches the mesh is validated here, then sent to every rank and run
    by each (``_Follower`` on the others) under one lock, so two handler
    threads never interleave their messages.  Every other attribute is
    the captioner's."""

    def __init__(self, captioner, mesh, sharded_graphs: bool):
        self._cap = captioner
        self._mesh = mesh
        self._sharded_graphs = sharded_graphs
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._stopped = False
        self.failed: Optional[BaseException] = None
        self.on_failure = None

    def __getattr__(self, name):
        return getattr(self._cap, name)

    def _run(self, name: str, *args, **kwargs):
        """Send ``name(*args, **kwargs)`` to every rank, then run it
        here: a ValueError or KeyError comes alike from every rank and is
        the caller's; anything else ends the daemon."""
        with self._lock:
            if self.failed is not None:
                raise RuntimeError(f"the ranks are gone: {self.failed}")
            if self._stopped:
                raise RuntimeError("the daemon has released its ranks")
            try:
                _send(self._mesh, (name, args, kwargs))
                self._last = time.monotonic()
                if name == "warmup":
                    return _warm(self._cap, *args)
                if name == "ping":
                    return None
                return getattr(self._cap, name)(*args, **kwargs)
            except (ValueError, KeyError):
                raise
            except BaseException as e:
                self._fail(e)
                raise

    def _fail(self, e: BaseException) -> None:
        self.failed = e
        sys.stderr.write(f"serve: a mesh call failed, stopping: "
                         f"{type(e).__name__}: {e}\n")
        if self.on_failure is not None:
            threading.Thread(target=self.on_failure, daemon=True).start()

    def heartbeat(self, stop: threading.Event) -> None:
        """Send a no-op to every rank whenever the mesh has been idle
        for ``_HEARTBEAT_S`` seconds, until ``stop`` is set."""
        while not stop.wait(_HEARTBEAT_S / 4):
            if time.monotonic() - self._last >= _HEARTBEAT_S:
                try:
                    self._run("ping")
                except BaseException:
                    return

    def stop(self) -> None:
        """Release the other ranks (once; not after a failure): no mesh
        call is sent after this."""
        with self._lock:
            if self._stopped or self.failed is not None:
                return
            self._stopped = True
            _send(self._mesh, ("shutdown", (), {}))

    def warmup(self, sizes: Sequence[int]) -> None:
        self._run("warmup", list(sizes))

    def caption_ids(self, ids: Sequence[str]) -> List[str]:
        self._cap._rows_for(ids)          # a 400 before anything is sent
        return self._run("caption_ids", list(ids))

    def nbest_ids(self, ids: Sequence[str], n: Optional[int] = None,
                  norm: bool = True) -> List[List[tuple]]:
        self._cap._rows_for(ids)
        return self._run("nbest_ids", list(ids), n=n, norm=norm)

    def _packed(self, features, regions, motion):
        from ..api import pack_request
        return pack_request(self._cap.cfg.model, features, regions, motion,
                            device=self._cap.device)

    def caption(self, features, regions=None, motion=None) -> List[str]:
        """A sharded artifact's captions: the packed batch goes to every
        rank; in live mode rank 0 decodes alone."""
        if not self._sharded_graphs:
            with self._lock:
                return self._cap.caption(features, regions, motion)
        return self._run("caption_batch",
                         self._packed(features, regions, motion))

    def nbest(self, features, regions=None, motion=None,
              n: Optional[int] = None, norm: bool = True):
        if not self._sharded_graphs:
            with self._lock:
                return self._cap.nbest(features, regions, motion, n=n,
                                       norm=norm)
        return self._run("caption_nbest",
                         self._packed(features, regions, motion), n=n,
                         norm=norm)

    def swap_params(self, params) -> None:
        """Rank 0's arrays, checked here, then sent to every rank."""
        import torch
        from ..api import _check_swap_compatible
        _check_swap_compatible(getattr(self._cap, "_shapes",
                                       self._cap.params), params)
        self._run("swap_params", {
            k: torch.as_tensor(np.asarray(v, np.float32)).to(
                self._cap.device) for k, v in params.items()})


class _Follower:
    """A rank above 0 of a daemon of several ranks: no socket; it runs
    each call rank 0 sends, in order, until rank 0 sends ``shutdown``
    (the server's ``warmup`` / ``serve_forever`` / ``server_close``
    shape, so ``main`` drives either)."""

    def __init__(self, captioner, mesh):
        self.captioner = captioner
        self.mesh = mesh
        self.mode = "follower"
        self.manifest: Dict = {}

    def warmup(self) -> float:
        return 0.0      # rank 0's warm-up arrives as a message

    def serve_forever(self) -> None:
        import torch.distributed as dist
        while True:
            name, args, kwargs = _receive(self.mesh, self.captioner.device)
            if name == "shutdown":
                return
            if name == "ping":
                continue
            try:
                if name == "warmup":
                    _warm(self.captioner, *args)
                else:
                    getattr(self.captioner, name)(*args, **kwargs)
            except (ValueError, KeyError) as e:   # rank 0 answers it
                sys.stderr.write(f"rank {dist.get_rank()}: {name}: {e}\n")

    def server_close(self) -> None:
        pass


def _on_ranks(cap, server_for):
    """On a daemon of several ranks, rank 0's server over ``_MeshCalls``
    (``server_for(captioner)``) or a ``_Follower``; a lone process's
    server as it is.  The mesh the ranks follow is the artifact's, else
    the bank's: one of them spans every rank."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return server_for(cap)
    mesh = getattr(cap, "_mesh", None)
    sharded_graphs = mesh is not None
    mesh = mesh if mesh is not None else getattr(cap, "_bank_mesh", None)
    if mesh is None:
        raise ValueError(
            f"{dist.get_world_size()} ranks serve a sharded artifact or a "
            "bank sharded over them (--bank-shards); this daemon has "
            "neither")
    if dist.get_rank():
        return _Follower(cap, mesh)
    calls = _MeshCalls(cap, mesh, sharded_graphs)
    server = server_for(calls)
    calls.on_failure = server.shutdown
    return server


def build_server(args):
    """The daemon of ``args``: a ``CaptionServer``, or on a rank above 0
    of a daemon of several ranks its ``_Follower``."""
    if bool(getattr(args, "artifact", None)) == bool(args.run_dir):
        raise ValueError("exactly one of --artifact / --run-dir required")
    wait_ms = float(getattr(args, "coalesce_wait_ms", 0) or 0)
    cls = ThreadedCaptionServer if wait_ms > 0 else CaptionServer
    dev = getattr(args, "device", "cuda")
    from ..train import parallel
    if parallel.visible_ranks() > 1:
        # each rank on its device (cuda:LOCAL_RANK under torchrun)
        dev = parallel.rank_device(dev)
    kw = dict(verbose=args.verbose,
              allow_shutdown=getattr(args, "allow_shutdown", False),
              coalesce_wait_ms=wait_ms,
              allow_swap=getattr(args, "allow_swap", False))
    if args.artifact:
        if getattr(args, "quant", None) not in (None, "none"):
            raise ValueError(
                "--quant applies to live mode only; quantization is "
                "baked into an artifact at export time (cli.export "
                "--quant int8)")
        from ..export_aot import load_artifact
        params = None
        if getattr(args, "params", None):
            with np.load(args.params) as z:
                params = {k: z[k] for k in z.files}
        cap = load_artifact(args.artifact, params=params, device=dev)
        manifest = dict(cap.manifest)
        if getattr(args, "bank", None):
            _attach_bank(cap, args.bank, manifest,
                         shards=getattr(args, "bank_shards", 0))
        return _on_ranks(cap, lambda c: cls(
            c, args.host, args.port, mode="aot", manifest=manifest, **kw))
    from ..api import Captioner
    cap = Captioner.from_run_dir(args.run_dir, quant=args.quant, device=dev)
    summary = {"mode": "live", "run_dir": args.run_dir,
               "beam_size": cap.cfg.decode.beam_size,
               "decode_batch": cap.cfg.decode.decode_batch,
               "maxlen": cap.cfg.decode.maxlen}
    if getattr(args, "bank", None):
        _attach_bank(cap, args.bank, summary,
                     shards=getattr(args, "bank_shards", 0))
    return _on_ranks(cap, lambda c: cls(
        c, args.host, args.port, mode="live", manifest=summary, **kw))


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--artifact",
                     help="exported artifact dir (stvd_torch.cli.export)")
    src.add_argument("--run-dir", help="live mode: training run dir")
    ap.add_argument("--bank", default=None, metavar="BANK.npz",
                    help="make a packed feature bank device-resident "
                         "and enable id-addressed captioning (POST "
                         "/caption_ids {\"ids\": [...]}) — no feature "
                         "transfer per request")
    ap.add_argument("--bank-shards", type=int, default=0, metavar="N",
                    help="shard the resident bank's videos over N ranks "
                         "(torchrun --nproc-per-node N; under a sharded "
                         "artifact N must be its data-parallel degree)")
    ap.add_argument("--params", default=None,
                    help="override weights: an .npz of same-architecture "
                         "params (aot mode; no re-export needed)")
    ap.add_argument("--quant", default=None, choices=["none", "int8"],
                    help="live mode: override model.decode_quant")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a CPU run)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8017)
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--coalesce-wait-ms", type=float, default=0.0,
                    help="batch concurrent /caption requests arriving "
                         "within this window into one device call "
                         "(threaded server; adds up to this much "
                         "latency per request; 0 = single-threaded)")
    ap.add_argument("--allow-swap", action="store_true",
                    help="enable POST /swap_params {\"path\": x.npz} — "
                         "mid-run same-architecture weight swap; "
                         "the bank and the listener stay up")
    ap.add_argument("--allow-shutdown", action="store_true",
                    help="enable POST /shutdown (a clean exit without a "
                         "signal, for scripted runs)")
    ap.add_argument("--verbose", action="store_true",
                    help="log each request to stderr")
    args = ap.parse_args(argv)

    server = build_server(args)
    if not args.no_warmup:
        secs = server.warmup()
        _say(f"warmup: {secs:.1f}s "
             f"(sizes {server.manifest.get('batch_sizes') or 'live'})")
    if isinstance(server, _Follower):
        server.serve_forever()
        return 0
    _say(f"serving {server.mode} on http://{args.host}:"
         f"{server.server_port}  (POST /caption, GET /healthz)")
    calls = server.captioner if isinstance(server.captioner,
                                           _MeshCalls) else None
    stop = threading.Event()
    if calls is not None:
        threading.Thread(target=calls.heartbeat, args=(stop,),
                         daemon=True).start()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        stop.set()
        if calls is not None:
            calls.stop()
        server.server_close()
    return 1 if calls is not None and calls.failed is not None else 0


if __name__ == "__main__":
    sys.exit(main())
