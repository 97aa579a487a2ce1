"""Sharded serving of the port (``export_aot`` with ``data_parallel`` /
``model_parallel``, ``ExportedCaptioner`` on a mesh, a bank sharded on
an artifact's mesh, int8 decode under a model axis, ``cli.export`` and a
multi-rank ``cli.serve --bank-shards``) against the JAX package, over
gloo on the CPU.

As in tests/test_torch_tensor_parallel.py the ranks are spawned
processes (``parallel.spawn``), one spawn a world that computes every
check, and the references come from the JAX package in this process on
the conftest's 8 virtual CPU devices while the ranks run; the ranks
import no ``jax``.  Worlds: 2 ranks (a data-parallel artifact, a 1 x 2
tensor-parallel one made by ``cli.export --model-parallel 2``) and 4
ranks (a 2 x 2 artifact, whose data rows carry model groups of different
names).  Held, at float32 with tokens identical and scores within 1e-5:

* artifact captions, n-best lists and ``swap_params`` against the JAX
  package's sharded artifacts (``save_artifact(..., data_parallel=2)``,
  ``(model_parallel=2)``, ``(data_parallel=2, model_parallel=2)``);
* ``caption_ids`` / ``nbest_ids`` of a bank sharded on each artifact's
  mesh against the JAX ``attach_bank(mesh=)``;
* int8 decode under DP (a sharded bank) and under TP at 1 x 2 and 2 x 2
  against the JAX package's;
* the traceable collectives against the live ones, bit for bit;
* the two-rank ``cli.serve --bank-shards 2`` daemon over HTTP;
* the refusals the JAX package makes, and a graph whose process group
  does not resolve.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import os
import shutil
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

from stvd_torch import config as tconfig
from stvd_torch.train import parallel

MODEL = dict(n_words=48, dim_word=16, dim=32, ctx_dim=32, n_frames=6,
             compute_dtype="float32")
DECODE = dict(beam_size=3, maxlen=8, decode_batch=4)
N_FEATS = 5             # a padded chunk of the size-4 graphs
N_BANK = 7
NBEST = 2
IDS = [f"vid{i}" for i in (6, 0, 3, 1, 5)]
RANK_TIMEOUT = 150.0
TOL = 1e-5


def model_cfg(**kw):
    return dict(MODEL, **kw)


def config_json(**model):
    cfg = tconfig.Config(model=tconfig.ModelConfig(**model_cfg(**model)),
                         decode=tconfig.DecodeConfig(**DECODE))
    return cfg.to_json()


def features():
    return np.random.RandomState(3).randn(
        N_FEATS, MODEL["n_frames"], MODEL["ctx_dim"]).astype(np.float32)


def vocab_words():
    return {f"w{i}": i for i in range(2, MODEL["n_words"])}


def _lists(hyps):
    """n-best lists as (texts, scores)."""
    return ([[t for t, _ in v] for v in hyps],
            [[s for _, s in v] for v in hyps])


# ---------------------------------------------------------------------------
# The ranks (no jax here)
# ---------------------------------------------------------------------------

def _serve_checks(cap, bank, swap):
    """What an artifact serves: captions, n-best lists, the bank on the
    artifact's mesh, then the same after a weight swap."""
    feats = features()
    out = {"caption": cap.caption(feats),
           "nbest": _lists(cap.nbest(feats, n=NBEST))}
    cap.attach_bank(bank, mesh=cap._mesh)
    out["caption_ids"] = cap.caption_ids(IDS)
    out["nbest_ids"] = _lists(cap.nbest_ids(IDS, n=NBEST))
    cap.swap_params(swap)
    out["swapped"] = cap.caption(feats)
    out["swapped_ids"] = cap.caption_ids(IDS)
    return out


def _tp_decode(mesh, params, cfgj, batch_np, tail="off"):
    from stvd_torch.config import Config
    from stvd_torch.decode import parallel as dparallel
    cfg = Config.from_json(cfgj)
    batch = parallel.shard_batch(
        {k: torch.from_numpy(v) for k, v in batch_np.items()}, mesh)
    p = dparallel.shard_decode_params(
        {k: torch.from_numpy(v) for k, v in params.items()}, mesh)
    d = cfg.decode
    r = dparallel.make_tp_beam_decode(
        cfg.model, mesh, beam_size=d.beam_size, maxlen=d.maxlen,
        length_norm=d.length_norm, tail=tail)(p, batch)
    return r.tokens, r.norm_scores


def _collectives(mesh, params, cfgj, batch_np):
    """The live and the traceable spelling of the model axis'
    collectives on the same inputs: the TP decode (both tails) and the
    two collectives on data with -0.0 in it, as raw bits."""
    from stvd_torch.model import tp
    out = {}
    for tail in ("off", "tp"):
        live = _tp_decode(mesh, params, cfgj, batch_np, tail)
        with tp.functional_collectives():
            traced = _tp_decode(mesh, params, cfgj, batch_np, tail)
        out[tail] = all(torch.equal(a, b) for a, b in zip(live, traced))
    axis = tp.Axis(parallel.model_group(mesh), parallel.model_axis_size(mesh),
                   parallel.model_rank(mesh), MODEL["n_words"])
    g = torch.Generator().manual_seed(parallel.model_rank(mesh))
    x = torch.randn(3, 5, generator=g, dtype=torch.float64)
    x[0, 0] = -0.0
    xf = x.float()
    xb = xf.to(torch.bfloat16)
    pairs = {}
    for name, fn in (
            ("gather_f64", lambda: tp.gather(x, axis, 1)),
            ("gather_f32_rows", lambda: tp.gather(xf, axis, 0)),
            ("gather_bf16", lambda: tp.gather(xb, axis, -1)),
            ("sum_f32", lambda: tp.all_reduce(xf.clone(), axis)),
            ("max_f32", lambda: tp.all_reduce(xf.clone(), axis, "max")),
            ("sum_i32", lambda: tp.all_reduce(
                (xf * 1e6).to(torch.int32), axis))):
        live = fn()
        with tp.functional_collectives():
            traced = fn() * 1       # waits for the functional result
        pairs[name] = (live.dtype == traced.dtype
                       and live.shape == traced.shape
                       and live.contiguous().view(torch.uint8).equal(
                           traced.contiguous().view(torch.uint8)))
    out["ops"] = pairs
    return out


def _errors(root, params, cfgj, bank_path, dp_cap, live_cap, tp_path):
    """What the sharded paths refuse, each message as raised."""
    from stvd_torch import export_aot
    from stvd_torch.cli import serve
    from stvd_torch.config import Config
    from stvd_torch.data.bank import FeatureBank
    from stvd_torch.data.text import Vocab
    cfg = Config.from_json(cfgj)
    out = {}

    def catch(name, call):
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)

    catch("indivisible", lambda: export_aot.save_artifact(
        os.path.join(root, "never"), params, cfg, Vocab(vocab_words()),
        platforms=("cpu",), batch_sizes=(3, 4), data_parallel=2,
        device="cpu"))
    catch("world_1d", lambda: parallel.serving_mesh(3, "cpu"))
    catch("world_2d", lambda: parallel.serving_mesh_2d(2, 2, "cpu"))
    catch("shards_vs_artifact", lambda: serve._attach_bank(
        dp_cap, bank_path, {}, shards=4))
    catch("shards_world", lambda: serve._attach_bank(
        live_cap, bank_path, {}, shards=4))
    other = parallel.make_mesh_2d("cpu", model_parallel=2)
    catch("other_mesh", lambda: dp_cap.attach_bank(
        FeatureBank.load(bank_path), mesh=other))
    wrong = os.path.join(root, "wrong_world")
    if parallel.is_first_rank(live_cap._bank_mesh):
        shutil.copytree(tp_path, wrong)
        with open(os.path.join(wrong, "manifest.json")) as f:
            manifest = json.load(f)
        manifest["data_parallel"] = 2
        with open(os.path.join(wrong, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    torch.distributed.barrier()
    catch("load_world", lambda: export_aot.load_artifact(wrong,
                                                         device="cpu"))
    # a graph's collectives against the groups the artifact records
    ep = torch.export.load(os.path.join(
        tp_path, f"decode_b4_cpu_m{parallel.model_rank(live_cap._bank_mesh)}"
        ".pt2"))
    module = ep.module()
    with open(os.path.join(tp_path, "manifest.json")) as f:
        traced = json.load(f)["group_names"]
    out["group_names"] = traced
    out["collectives"] = sum(
        1 for n in module.graph.nodes if n.op == "call_function"
        and getattr(n.target, "namespace", "") == "_c10d_functional")
    mine = torch.distributed.group.WORLD.group_name
    # each refusal comes before the graph is changed
    catch("unrecorded", lambda: export_aot.bind_groups(
        module, ["no-such-group"], mine))
    catch("unresolved", lambda: export_aot.bind_groups(
        module, traced, "no-such-group"))
    return out


def checks_2(mesh1, root, params, swap, cfgj, cfgj8, bank_path, run_dir,
             batch_np):
    """Every check of the 2-rank world."""
    torch.set_num_threads(1)
    from stvd_torch import export_aot
    from stvd_torch.api import Captioner
    from stvd_torch.cli import export as texport
    from stvd_torch.config import Config
    from stvd_torch.data.bank import FeatureBank
    from stvd_torch.data.text import Vocab
    cfg = Config.from_json(cfgj)
    vocab = Vocab(vocab_words())
    bank = FeatureBank.load(bank_path)
    out = {"rank": torch.distributed.get_rank()}

    dp_path = os.path.join(root, "dp")
    t0 = time.perf_counter()
    manifest = export_aot.save_artifact(
        dp_path, params, cfg, vocab, platforms=("cpu",), batch_sizes=(4,),
        nbest=True, data_parallel=2, device="cpu")
    out["dp_manifest"] = {k: manifest[k] for k in (
        "data_parallel", "model_parallel", "batch_sizes", "custom_ops")}
    dp_cap = export_aot.load_artifact(dp_path, device="cpu")
    out["dp"] = _serve_checks(dp_cap, bank, swap)
    out["dp_seconds"] = time.perf_counter() - t0

    # the 1 x 2 artifact through the CLI, whose --check holds it to live
    tp_path = os.path.join(root, "tp")
    out["cli_export"] = texport.main([
        "--run-dir", run_dir, "--out", tp_path, "--platforms", "cpu",
        "--batch", "4", "--nbest", "--model-parallel", "2", "--check",
        "--device", "cpu"])
    # the same layout for the card, traced on this host: the kernels'
    # custom ops and the collectives in one graph
    cuda = export_aot.save_artifact(
        os.path.join(root, "tp_cuda"), params, cfg, vocab,
        platforms=("cuda",), batch_sizes=(4,), model_parallel=2,
        device="cpu")
    ep = torch.export.load(os.path.join(
        root, "tp_cuda", f"decode_b4_cuda_m{torch.distributed.get_rank()}"
        ".pt2"))
    out["tp_cuda"] = {"custom_ops": cuda["custom_ops"],
                      "use_kernel": cuda["use_kernel"],
                      "ops": sorted({str(n.target) for n in ep.graph.nodes
                                     if n.op == "call_function"
                                     and "::" not in str(n.target)
                                     and str(n.target).startswith(
                                         ("_c10d", "stvd_torch"))})}
    tp_cap = export_aot.load_artifact(tp_path, device="cpu")
    out["tp_manifest"] = {k: tp_cap.manifest[k] for k in (
        "data_parallel", "model_parallel", "group_names")}
    out["tp"] = _serve_checks(tp_cap, bank, swap)

    # int8: a live decode of a bank sharded over the data axis (DP), and
    # the TP decode at 1 x 2
    icfg = Config.from_json(cfgj8)
    live8 = Captioner(params, icfg, vocab, device="cpu")
    live8.attach_bank(bank, mesh=parallel.make_mesh("cpu"))
    out["int8_dp"] = live8.caption_ids(IDS)
    mesh2 = parallel.make_mesh_2d("cpu", model_parallel=2)
    out["int8_tp"] = [t.numpy() for t in _tp_decode(mesh2, params, cfgj8,
                                                    batch_np)]
    out["collectives"] = _collectives(mesh2, params, cfgj, batch_np)

    live = Captioner(params, cfg, vocab, device="cpu")
    live.attach_bank(bank, mesh=parallel.make_mesh("cpu"))
    out["errors"] = _errors(root, params, cfgj, bank_path, dp_cap, live,
                            tp_path)
    out["modules"] = sorted(m for m in sys.modules
                            if m == "jax" or m.startswith("jax.")
                            or m == "stvd" or m.startswith("stvd."))
    return out


def checks_4(mesh1, root, params, swap, cfgj, cfgj8, bank_path, batch_np):
    """Every check of the 4-rank (2 x 2) world."""
    torch.set_num_threads(1)
    from stvd_torch import export_aot
    from stvd_torch.config import Config
    from stvd_torch.data.bank import FeatureBank
    from stvd_torch.data.text import Vocab
    cfg = Config.from_json(cfgj)
    bank = FeatureBank.load(bank_path)
    path = os.path.join(root, "tp2x2")
    export_aot.save_artifact(
        path, params, cfg, Vocab(vocab_words()), platforms=("cpu",),
        batch_sizes=(4,), nbest=True, data_parallel=2, model_parallel=2,
        device="cpu")
    cap = export_aot.load_artifact(path, device="cpu")
    mesh = cap._mesh
    out = {"rank": torch.distributed.get_rank(),
           "data_rank": parallel.axis_rank(mesh),
           "model_rank": parallel.model_rank(mesh),
           "model_group": parallel.model_group(mesh).group_name,
           "group_names": cap.manifest["group_names"]}
    out["tp"] = _serve_checks(cap, bank, swap)
    shard = bank.to_device_sharded(mesh, device="cpu")
    out["bank_shard"] = {k: v.numpy() for k, v in shard.items()}
    out["int8_tp"] = [t.numpy() for t in _tp_decode(mesh, params, cfgj8,
                                                    batch_np)]
    return out


def daemon_rank(mesh1, argv):
    """One rank of ``cli.serve``'s main; rank 1 records each message it
    follows."""
    torch.set_num_threads(1)
    from stvd_torch.cli import serve
    seen = []
    receive = serve._receive

    def recording(mesh, device):
        msg = receive(mesh, device)
        if msg[0] != "ping":
            seen.append(msg[0])
        return msg

    serve._receive = recording
    rc = serve.main(argv)
    return {"rc": rc, "followed": seen}


# ---------------------------------------------------------------------------
# The JAX package's sharded paths, in this process
# ---------------------------------------------------------------------------

def jax_params(p):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in p.items()}


def jax_serve(cap, bank, swap):
    """``_serve_checks`` through a JAX ``ExportedCaptioner``."""
    feats = features()
    out = {"caption": cap.caption(feats),
           "nbest": _lists(cap.nbest(feats, n=NBEST))}
    cap.attach_bank(bank, mesh=cap._mesh)
    out["caption_ids"] = cap.caption_ids(IDS)
    out["nbest_ids"] = _lists(cap.nbest_ids(IDS, n=NBEST))
    cap.swap_params(jax_params(swap))
    out["swapped"] = cap.caption(feats)
    out["swapped_ids"] = cap.caption_ids(IDS)
    return out


def jax_tp_decode(n, model, params, cfgj, batch_np):
    import jax
    from stvd.config import Config
    from stvd.decode import parallel as jdparallel
    from stvd.train import parallel as jparallel
    cfg = Config.from_json(cfgj)
    mesh = jparallel.make_mesh_2d(jax.devices()[:n], model_parallel=model)
    batch = jparallel.shard_batch(jax_params(batch_np), mesh)
    p = jdparallel.shard_decode_params(jax_params(params), mesh)
    d = cfg.decode
    r = jdparallel.make_tp_beam_decode(
        cfg.model, mesh, beam_size=d.beam_size, maxlen=d.maxlen,
        length_norm=d.length_norm)(p, batch)
    return [np.asarray(r.tokens), np.asarray(r.norm_scores)]


def jax_references(world, root, params, swap, cfgj, cfgj8, bank_path,
                   batch_np):
    import jax
    from stvd import export_aot as jexport
    from stvd.api import Captioner as JCaptioner
    from stvd.config import Config
    from stvd.data.bank import FeatureBank
    from stvd.data.text import Vocab
    from stvd.train import parallel as jparallel
    cfg = Config.from_json(cfgj)
    vocab = Vocab(vocab_words())
    jp = jax_params(params)
    out = {}
    layouts = ({"dp": dict(data_parallel=2), "tp": dict(model_parallel=2)}
               if world == 2 else
               {"tp": dict(data_parallel=2, model_parallel=2)})
    for name, kw in layouts.items():
        path = os.path.join(root, f"jax_{name}")
        jexport.save_artifact(path, jp, cfg, vocab, platforms=("cpu",),
                              batch_sizes=(4,), nbest=True, **kw)
        out[name] = jax_serve(jexport.load_artifact(path),
                              FeatureBank.load(bank_path), swap)
    if world == 2:
        cap8 = JCaptioner(jp, Config.from_json(cfgj8), vocab)
        cap8.attach_bank(FeatureBank.load(bank_path),
                         mesh=jparallel.make_mesh(jax.devices()[:2]))
        out["int8_dp"] = cap8.caption_ids(IDS)
        out["int8_tp"] = jax_tp_decode(2, 2, params, cfgj8, batch_np)
        with pytest.raises(ValueError) as e:
            jexport.save_artifact(os.path.join(root, "jax_never"), jp, cfg,
                                  vocab, platforms=("cpu",),
                                  batch_sizes=(3, 4), data_parallel=2)
        out["indivisible"] = str(e.value)
        with pytest.raises(ValueError) as e:
            jexport._serving_mesh(9)
        out["world_1d"] = str(e.value)
        with pytest.raises(ValueError) as e:
            jexport._serving_mesh_2d(3, 3)
        out["world_2d"] = str(e.value)
    else:
        out["int8_tp"] = jax_tp_decode(4, 2, params, cfgj8, batch_np)
    return out


# ---------------------------------------------------------------------------
# Fixtures: the data, one spawn a world, the daemon
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Weights, a swap, the configs, a bank file and the run dirs of
    one weight set (the JAX package's and the port's)."""
    from conftest import small_cfg
    from test_torch_cli import make_run_dirs
    from test_torch_step import numpy_params
    from stvd_torch.data.bank import synthetic_bank
    root = tmp_path_factory.mktemp("sharded")
    mcfg = small_cfg(**{k: v for k, v in MODEL.items()
                        if k != "compute_dtype"})
    params = numpy_params(mcfg, seed=11)
    swap = numpy_params(mcfg, seed=12)
    bank = synthetic_bank(N_BANK, k=MODEL["n_frames"], d=MODEL["ctx_dim"],
                          seed=4)
    bank = dataclasses.replace(bank, ids=[f"vid{i}" for i in range(N_BANK)])
    bank_path = str(root / "bank.npz")
    bank.save(bank_path)
    np.savez(str(root / "swap.npz"), **swap)
    (root / "runs").mkdir()
    jdir, tdir = make_run_dirs(root / "runs", params=params)
    for d in (jdir, tdir):      # the tests' decode: beam 3, batch 4
        path = os.path.join(d, "config.json")
        with open(path) as f:
            c = json.load(f)
        c["decode"].update(DECODE)
        with open(path, "w") as f:
            json.dump(c, f)
    rng = np.random.RandomState(7)
    frames = rng.randn(4, MODEL["n_frames"], MODEL["ctx_dim"]).astype(
        np.float32)
    mask = (rng.rand(4, MODEL["n_frames"]) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    return dict(root=str(root), params=params, swap=swap,
                cfgj=config_json(),
                cfgj8=config_json(decode_quant="int8"),
                bank_path=bank_path, swap_path=str(root / "swap.npz"),
                jdir=jdir, tdir=tdir,
                batch={"frames": frames, "frame_mask": mask})


def _spawn_beside(fn, n, args, reference):
    """``parallel.spawn(fn, n, args)`` in a thread while ``reference()``
    runs here; (reference's result, the ranks')."""
    box = {}

    def ranks():
        try:
            box["ranks"] = parallel.spawn(fn, n, args, device="cpu",
                                          timeout=RANK_TIMEOUT)
        except BaseException as e:     # raised again below
            box["error"] = e

    th = threading.Thread(target=ranks)
    th.start()
    try:
        ref = reference()
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    return ref, box["ranks"]


@pytest.fixture(scope="module")
def world2(data, tmp_path_factory):
    d = data
    root = str(tmp_path_factory.mktemp("world2"))
    ref, ranks = _spawn_beside(
        checks_2, 2, (root, d["params"], d["swap"], d["cfgj"], d["cfgj8"],
                      d["bank_path"], d["tdir"], d["batch"]),
        lambda: jax_references(2, root, d["params"], d["swap"], d["cfgj"],
                               d["cfgj8"], d["bank_path"], d["batch"]))
    ref["root"] = root
    return ref, ranks


@pytest.fixture(scope="module")
def world4(data, tmp_path_factory):
    d = data
    root = str(tmp_path_factory.mktemp("world4"))
    return _spawn_beside(
        checks_4, 4, (root, d["params"], d["swap"], d["cfgj"], d["cfgj8"],
                      d["bank_path"], d["batch"]),
        lambda: jax_references(4, root, d["params"], d["swap"], d["cfgj"],
                               d["cfgj8"], d["bank_path"], d["batch"]))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read().decode())
    finally:
        conn.close()


@pytest.fixture(scope="module")
def daemon(data):
    """The two-rank live daemon with a bank sharded over both ranks,
    driven over HTTP from here; the JAX Captioner of the sibling run dir
    answers the same requests."""
    from stvd.api import Captioner as JCaptioner
    from stvd.data.bank import FeatureBank
    port = _free_port()
    argv = ["--run-dir", data["tdir"], "--bank", data["bank_path"],
            "--bank-shards", "2", "--device", "cpu", "--port", str(port),
            "--allow-swap", "--allow-shutdown"]
    ids = IDS + ["vid2", "vid4", "vid6"]       # 8 ids: two full chunks

    def client():
        got = {}
        deadline = time.monotonic() + RANK_TIMEOUT
        while True:
            try:
                if _request(port, "GET", "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise TimeoutError("the daemon did not come up")
            time.sleep(0.2)
        got["caption_ids"] = _request(port, "POST", "/caption_ids",
                                      {"ids": ids})
        got["odd_ids"] = _request(port, "POST", "/caption_ids",
                                  {"ids": ids[:5]})
        got["nbest_ids"] = _request(port, "POST", f"/nbest_ids?n={NBEST}",
                                    {"ids": IDS})
        got["unknown"] = _request(port, "POST", "/caption_ids",
                                  {"ids": ["vid0", "nope"]})
        got["swap"] = _request(port, "POST", "/swap_params",
                               {"path": data["swap_path"]})
        got["swapped_ids"] = _request(port, "POST", "/caption_ids",
                                      {"ids": ids})
        got["manifest"] = _request(port, "GET", "/manifest")
        got["shutdown"] = _request(port, "POST", "/shutdown")
        return got

    got, ranks = _spawn_beside(daemon_rank, 2, (argv,), client)
    jcap = JCaptioner.from_run_dir(data["jdir"])
    jcap.attach_bank(FeatureBank.load(data["bank_path"]))
    want = {"caption_ids": jcap.caption_ids(ids),
            "odd_ids": jcap.caption_ids(ids[:5]),
            "nbest_ids": _lists(jcap.nbest_ids(IDS, n=NBEST))}
    jcap.swap_params(jax_params(data["swap"]))
    want["swapped_ids"] = jcap.caption_ids(ids)
    return got, want, ranks


@pytest.fixture(scope="module")
def artifact_daemon(data, world2):
    """The two-rank daemon over the data-parallel artifact of ``world2``
    with the bank on its mesh: the warm-up, raw-feature requests (the
    packed batch goes to both ranks) and id requests."""
    from stvd_torch.cli import serve
    port = _free_port()
    argv = ["--artifact", os.path.join(world2[0]["root"], "dp"),
            "--bank", data["bank_path"], "--bank-shards", "2",
            "--device", "cpu", "--port", str(port), "--allow-shutdown"]

    def client():
        deadline = time.monotonic() + RANK_TIMEOUT
        while True:
            try:
                if _request(port, "GET", "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            if time.monotonic() > deadline:
                raise TimeoutError("the daemon did not come up")
            time.sleep(0.2)
        return {"caption": serve.request_captions("127.0.0.1", port,
                                                  features()),
                "nbest": serve.request_nbest("127.0.0.1", port, features(),
                                             n=NBEST),
                "caption_ids": _request(port, "POST", "/caption_ids",
                                        {"ids": IDS}),
                "shutdown": _request(port, "POST", "/shutdown")}

    return _spawn_beside(daemon_rank, 2, (argv,), client)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def _same_nbest(got, want):
    assert got[0] == want[0]
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=0, atol=TOL)


SERVED = ("caption", "caption_ids", "swapped", "swapped_ids")


@pytest.mark.parametrize("what", SERVED)
@pytest.mark.parametrize("layout", ["dp", "tp"])
def test_artifact_serves_jax_s_captions(world2, layout, what):
    """The data-parallel and the 1 x 2 tensor-parallel artifact give the
    JAX package's sharded artifact's captions on every rank: of raw
    features, of a bank on the artifact's mesh, after a weight swap."""
    ref, ranks = world2
    for r in ranks:
        assert r[layout][what] == ref[layout][what]


@pytest.mark.parametrize("what", SERVED)
def test_2x2_artifact_serves_jax_s_captions(world4, what):
    ref, ranks = world4
    for r in ranks:
        assert r["tp"][what] == ref["tp"][what]


@pytest.mark.parametrize("what", ["nbest", "nbest_ids"])
@pytest.mark.parametrize("layout", ["dp", "tp"])
def test_artifact_nbest_matches_jax(world2, layout, what):
    ref, ranks = world2
    for r in ranks:
        _same_nbest(r[layout][what], ref[layout][what])


@pytest.mark.parametrize("what", ["nbest", "nbest_ids"])
def test_2x2_artifact_nbest_matches_jax(world4, what):
    ref, ranks = world4
    for r in ranks:
        _same_nbest(r["tp"][what], ref["tp"][what])


def test_sharded_manifests_and_the_export_cli(world2):
    """The JAX package's manifest keys; ``cli.export --model-parallel 2
    --check`` passes on both ranks; one graph a model rank."""
    _, ranks = world2
    for r in ranks:
        assert r["dp_manifest"] == {"data_parallel": 2, "model_parallel": 0,
                                    "batch_sizes": [4], "custom_ops": []}
        assert r["cli_export"] == 0
        assert r["tp_manifest"]["data_parallel"] == 1
        assert r["tp_manifest"]["model_parallel"] == 2
        assert len(r["tp_manifest"]["group_names"]) == 1


def test_cuda_tensor_parallel_graph_holds_kernels_and_collectives(world2):
    """A cuda-only 1 x 2 export (traced on this host, no kernel run) runs
    the live TP decode's kernel step: kernels 1 and 2 as custom ops (2 on
    the rank's vocab shard) and the model axis' functional collectives,
    where the JAX package refuses kernels under a model axis."""
    _, ranks = world2
    for r in ranks:
        c = r["tp_cuda"]
        assert c["use_kernel"] is True
        assert c["custom_ops"] == ["stvd_torch::attention_core",
                                   "stvd_torch::logit_tail"]
        assert c["ops"] == ["_c10d_functional.all_reduce.default",
                            "_c10d_functional.wait_tensor.default",
                            "stvd_torch.attention_core.default",
                            "stvd_torch.logit_tail.default"]


def test_2x2_graphs_call_their_own_model_group(world4):
    """The two data rows shared the tracing (the decode graphs on one,
    the n-best graphs on the other), so the artifact records both rows'
    model groups; the loader's groups have other names still (its mesh
    is new), and each rank's graphs were pointed at its own (its captions
    above are right)."""
    _, ranks = world4
    rows = {r["data_rank"]: r["model_group"] for r in ranks}
    assert rows[0] != rows[1]
    for r in ranks:
        assert len(r["group_names"]) == 2
        assert set(r["group_names"]).isdisjoint(rows.values())


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_int8_tensor_parallel_decode_matches_jax(world, request):
    """int8 under a model axis (1 x 2 and 2 x 2): the JAX TP int8
    decode's tokens on every rank, scores within 1e-5."""
    ref, ranks = request.getfixturevalue(world)
    n = ref["int8_tp"][0].shape[0] // (len(ranks) // 2)   # rows a data rank
    for r in ranks:
        row = r.get("data_rank", 0)
        want = [x[row * n:(row + 1) * n] for x in ref["int8_tp"]]
        np.testing.assert_array_equal(r["int8_tp"][0], want[0])
        np.testing.assert_allclose(r["int8_tp"][1], want[1], rtol=0,
                                   atol=TOL)


def test_int8_data_parallel_bank_matches_jax(world2):
    ref, ranks = world2
    for r in ranks:
        assert r["int8_dp"] == ref["int8_dp"]


@pytest.mark.parametrize("tail", ["off", "tp"])
def test_traceable_collectives_give_the_live_bits(world2, tail):
    """The spelling an exported graph holds (functional all_reduce, the
    gather as an integer sum of zero-padded blocks) against the live
    c10d calls: the TP decode's tokens and scores bit for bit."""
    _, ranks = world2
    for r in ranks:
        assert r["collectives"][tail]


@pytest.mark.parametrize("op", ["gather_f64", "gather_f32_rows",
                                "gather_bf16", "sum_f32", "max_f32",
                                "sum_i32"])
def test_traceable_collective_ops_give_the_live_bits(world2, op):
    """Each collective on data holding -0.0: the same bytes."""
    _, ranks = world2
    for r in ranks:
        assert r["collectives"]["ops"][op]


@pytest.mark.parametrize("name", ["indivisible", "world_1d", "world_2d"])
def test_refusals_in_the_jax_package_s_words(world2, name):
    """An indivisible batch size raises the JAX package's error word for
    word; a world of the wrong size its error with the port's counts."""
    import re
    ref, ranks = world2
    for r in ranks:
        got = r["errors"][name]
        if name == "indivisible":
            assert got == ref[name]
        else:
            pattern = re.sub(r"\d+", r"\\d+", re.escape(ref[name]))
            assert re.fullmatch(pattern, got), (got, ref[name])
    assert ranks[0]["errors"]["world_1d"] == (
        "data_parallel=3 needs 3 devices; only 2 visible")


def test_bank_shards_refusals(world2):
    """--bank-shards against an artifact of another data degree, and
    against a world of another size (the JAX daemon's words), a sharded
    artifact loaded in a world of the wrong size, and a bank sharded on
    a mesh of another layout than the artifact's."""
    _, ranks = world2
    for r in ranks:
        e = r["errors"]
        assert e["shards_vs_artifact"] == (
            "--bank-shards 4 != the artifact's data-parallel degree 2 (a "
            "sharded bank rides the artifact's serving mesh)")
        assert e["shards_world"] == "--bank-shards 4 needs 4 devices; 2 visible"
        assert e["load_world"] == ("data_parallel=2 x model_parallel=2 "
                                   "needs 4 devices; 2 visible")
        assert "cannot ride the artifact's (2,) ('data',)" in e["other_mesh"]


def test_a_graph_never_calls_a_group_it_does_not_know(world2):
    """A TP graph holds collectives; pointing them at a group name that
    does not resolve, or loading a graph whose group the artifact does
    not record, raises a ValueError that says so."""
    _, ranks = world2
    for r in ranks:
        e = r["errors"]
        assert e["collectives"] > 0
        assert "does not resolve" in e["unresolved"]
        assert "does not record" in e["unrecorded"]


def test_2x2_bank_shard_is_the_same_on_a_model_group(world4):
    """On a 2-D mesh the bank is sharded over the data axis: the ranks of
    a model group hold the same rows, padded to a multiple of 2."""
    _, ranks = world4
    by_row = {}
    for r in ranks:
        by_row.setdefault(r["data_rank"], []).append(r["bank_shard"])
    sn = -(-N_BANK // 2)
    for row, shards in by_row.items():
        for k in shards[0]:
            assert shards[0][k].shape[0] == sn
            np.testing.assert_array_equal(shards[0][k], shards[1][k])
    assert not np.array_equal(by_row[0][0]["frames"], by_row[1][0]["frames"])


def test_ranks_import_no_jax(world2):
    _, ranks = world2
    for r in ranks:
        assert r["modules"] == []


@pytest.mark.parametrize("what", ["caption_ids", "odd_ids", "swapped_ids"])
def test_daemon_bank_shards_captions_match_jax(daemon, what):
    """/caption_ids over the two-rank daemon: chunks of 4 (scattered) and
    a chunk of 1 (replicated), before and after /swap_params, equal the
    JAX Captioner's."""
    got, want, _ = daemon
    status, obj = got[what]
    assert status == 200 and obj["captions"] == want[what]


def test_daemon_nbest_ids_and_errors(daemon):
    got, want, ranks = daemon
    status, obj = got["nbest_ids"]
    assert status == 200
    _same_nbest(([[t for t, _ in v] for v in obj["nbest"]],
                 [[s for _, s in v] for v in obj["nbest"]]),
                want["nbest_ids"])
    status, obj = got["unknown"]
    assert status == 400 and "nope" in obj["error"]
    assert got["swap"][0] == 200
    assert got["manifest"][1]["bank_shards"] == 2
    assert got["shutdown"][0] == 200


def test_daemon_broadcasts_each_mesh_call_once_in_order(daemon):
    """Rank 1 follows rank 0's calls in order and nothing of the refused
    request; both ranks exit 0."""
    _, _, ranks = daemon
    assert [r["rc"] for r in ranks] == [0, 0]
    assert ranks[0]["followed"] == []
    assert ranks[1]["followed"] == [
        "warmup", "caption_ids", "caption_ids", "nbest_ids",
        "swap_params", "caption_ids", "shutdown"]


def test_artifact_daemon_serves_jax_s_captions(artifact_daemon, world2):
    """``cli.serve --artifact <data-parallel> --bank-shards 2`` over two
    ranks: raw-feature /caption and /nbest (the packed batch sent to both
    ranks) and /caption_ids equal the JAX package's data-parallel
    artifact; both ranks exit 0 after /shutdown; rank 1 followed the
    warm-up and the three requests."""
    got, ranks = artifact_daemon
    ref = world2[0]["dp"]
    assert got["caption"] == ref["caption"]
    _same_nbest(_lists(got["nbest"]), ref["nbest"])
    status, obj = got["caption_ids"]
    assert status == 200 and obj["captions"] == ref["caption_ids"]
    assert got["shutdown"][0] == 200
    assert [r["rc"] for r in ranks] == [0, 0]
    assert ranks[1]["followed"] == ["warmup", "caption_batch",
                                    "caption_nbest", "caption_ids",
                                    "shutdown"]
