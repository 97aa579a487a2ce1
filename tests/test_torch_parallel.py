"""Data parallelism of the port (``stvd_torch.train.parallel``) against
the JAX package's mesh paths, over gloo on the CPU.

Ranks are spawned processes (``parallel.spawn``: a file store in a fresh
directory, so parallel test workers cannot collide, and a time limit on
every collective and on the launch).  The references come from the JAX
package in this process, over the conftest's 8 virtual CPU devices, and
reach the ranks as numpy arrays; the ranks import no ``jax`` (this module
imports it only inside the functions that run here):

* DP train updates, both spellings (``use_shard_map`` True and False),
  3 updates without dropout against ``stvd.train.loop.make_train_step``
  over ``make_mesh(devs[:n])``: loss within 1e-5 relative, parameters
  within 1e-5, the ranks' parameters bitwise equal;
* a DP update with dropout against the port's single-process update on
  the global batch (the masks are the global batch's, cut to the rank),
  and one without dropout bit for bit the single-process update of the
  same split (``grad_accum`` = the ranks);
* ``generate_captions(..., mesh)`` and the sharded bank's
  ``caption_ids`` / ``nbest_ids`` on divisible and indivisible chunks
  against the JAX package's: the same tokens;
* ``fit(..., mesh)`` and ``cli.train --data-parallel`` against the
  port's single-process ``fit``: loss per update within 1e-5 relative,
  the same valid metrics, one writer; a reload from rank 0's checkpoint
  when the other ranks' ``save_dir`` holds none.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from stvd_torch import config as tconfig
from stvd_torch.api import Captioner
from stvd_torch.data.bank import to_device
from stvd_torch.data.batching import gather_batch, synthetic_dataset
from stvd_torch.model.convert import params_from_numpy
from stvd_torch.train import loop as tloop
from stvd_torch.train import parallel
from stvd_torch.train.evaluate import generate_captions

WORLDS = (2, 4)
# tests/test_parallel.py's model, its batch of 8 and its sgd
MODEL = dict(n_words=48, dim_word=16, dim=32, ctx_dim=32, n_frames=6,
             compute_dtype="float32", use_dropout=False)
TRAIN = dict(optimizer="sgd", lr=0.1, batch_size=8, clip_c=1.0,
             donate_state=False)
BATCH = 8
WEIGHT = np.array([1, 1, 1, 1, 1, 1, 1, 0], np.float32)  # wrapped tail
UPDATES = 3
MAXLEN = 10
N_VIDEOS = 10           # 4 ranks pad the bank to 12 rows
DECODE = dict(beam_size=3, maxlen=MAXLEN, length_norm=0.6)
CAPTION_BATCHES = {"divisible": 8, "indivisible": 5}
NBEST_BATCHES = {"divisible": 4, "indivisible": 5}
ORDER = [9, 0, 4, 7, 2, 5, 1, 8, 3, 6]
RANK_TIMEOUT = 120.0


def dataset(seed=0, n=BATCH):
    return synthetic_dataset(n_videos=n, captions_per_video=1, k=6, d=32,
                             maxlen=MAXLEN, seed=seed)


# ---------------------------------------------------------------------------
# The ranks (no jax here)
# ---------------------------------------------------------------------------

def _state(params, tcfg):
    p = params_from_numpy(params, "cpu")
    for v in p.values():
        v.requires_grad_(True)
    return {"params": p, "opt_state": tloop.make_optimizer(tcfg).init(p),
            "step": 0, "generator": torch.Generator().manual_seed(0)}


def _numpy(params):
    return {k: v.detach().numpy().copy() for k, v in params.items()}


def _global_batch():
    ds = dataset()
    b = gather_batch(to_device(ds.bank, "cpu"), ds.captions,
                     np.arange(BATCH))
    b["weight"] = torch.from_numpy(WEIGHT)
    return b


def _train(mesh, params, spelling):
    mcfg = tconfig.ModelConfig(**MODEL)
    tcfg = tconfig.TrainConfig(**TRAIN)
    state = parallel.replicate(_state(params, tcfg), mesh)
    step = tloop.make_train_step(mcfg, tcfg, None, mesh,
                                 use_shard_map=spelling == "shard_map")
    batch = parallel.shard_batch(_global_batch(), mesh)
    losses = []
    for _ in range(UPDATES):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": _numpy(state["params"])}


def _dropout_update(mesh, params):
    """One DP update with dropout, and the single-process update over the
    global batch from the same state, on this rank."""
    mcfg = tconfig.ModelConfig(**{**MODEL, "use_dropout": True})
    tcfg = tconfig.TrainConfig(**TRAIN)
    batch = _global_batch()
    out = {}
    for name, m in (("dp", mesh), ("single", None)):
        state = _state(params, tcfg)
        state, met = tloop.make_train_step(mcfg, tcfg, None, m)(
            state, parallel.shard_batch(batch, m) if m else batch)
        out[name] = {"loss": float(met["loss"]),
                     "params": _numpy(state["params"])}
    return out


def _split_update(mesh, params):
    """One DP update and, on this rank, the single-process update of the
    same split (``grad_accum`` = the ranks: each share's gradient,
    summed, then divided), without dropout."""
    mcfg = tconfig.ModelConfig(**MODEL)
    n = parallel.axis_size(mesh)
    out = {}
    for name, m, acc in (("dp", mesh, 1), ("split", None, n)):
        tcfg = tconfig.TrainConfig(**{**TRAIN, "grad_accum": acc})
        batch = _global_batch()
        state, met = tloop.make_train_step(mcfg, tcfg, None, m)(
            _state(params, tcfg),
            parallel.shard_batch(batch, m) if m else batch)
        out[name] = {"loss": float(met["loss"]),
                     "params": _numpy(state["params"])}
    return out


def _captioner(params, decode_batch):
    cfg = tconfig.Config(model=tconfig.ModelConfig(**MODEL),
                         decode=tconfig.DecodeConfig(
                             decode_batch=decode_batch, **DECODE))
    return Captioner(params, cfg, dataset().vocab, device="cpu")


def _bank(mesh, params):
    ds = dataset(seed=7, n=N_VIDEOS)
    out = {"caption_ids": {}, "nbest_ids": {}, "shard_rows": {}}
    for name, bsz in CAPTION_BATCHES.items():
        cap = _captioner(params, bsz)
        cap.attach_bank(ds.bank, mesh=mesh)
        out["shard_rows"] = {k: int(v.shape[0])
                             for k, v in cap._bank_dev.items()}
        ids = cap.bank_ids
        out["caption_ids"][name] = cap.caption_ids([ids[i] for i in ORDER])
    for name, bsz in NBEST_BATCHES.items():
        cap = _captioner(params, bsz)
        cap.attach_bank(ds.bank, mesh=mesh)
        out["nbest_ids"][name] = cap.nbest_ids(cap.bank_ids[:7], n=2)
    return out


def _fit_config(save_dir, **train):
    model = tconfig.ModelConfig(**{**MODEL, "use_dropout": True})
    tc = tconfig.TrainConfig(**{
        **TRAIN, "metric": "bleu4", "disp_freq": 1, "valid_freq": 2,
        "sample_freq": 2, "save_freq": 0, "save_dir": str(save_dir),
        **train})
    return tconfig.Config(model=model, train=tc,
                          decode=tconfig.DecodeConfig(decode_batch=6,
                                                      **DECODE))


def _fit(mesh, root):
    """``fit`` over the mesh with a per-device batch, and (on rank 0) the
    single-process ``fit`` with the same global batch."""
    n = parallel.axis_size(mesh)
    ds = synthetic_dataset(n_videos=12, k=6, d=32, maxlen=MAXLEN, seed=4)
    dp_dir = os.path.join(root, f"fit_dp{n}")
    res = tloop.fit(_fit_config(dp_dir, batch_size=0,
                                per_device_batch=BATCH // n),
                    ds, ds, None, mesh, max_updates=4, device="cpu")
    out = {"dp": {"log": res.log, "history": res.history,
                  "params": _numpy(res.state["params"])}}
    if parallel.axis_rank(mesh) == 0:
        single = tloop.fit(_fit_config(os.path.join(root, f"fit_one{n}")),
                           ds, ds, max_updates=4, device="cpu")
        out["single"] = {"log": single.log, "history": single.history}
        with open(os.path.join(dp_dir, "metrics.jsonl")) as f:
            out["records"] = [json.loads(ln)["kind"] for ln in f]
        out["files"] = sorted(os.listdir(dp_dir))
    return out


def _fit_reload(mesh, root):
    """``fit(..., mesh)`` resumed with ``reload_`` from ``_fit``'s run to
    6 updates, rank 0 in ``_fit``'s directory and every other rank in an
    empty one of its own, as on hosts that share no ``save_dir``."""
    n, r = parallel.axis_size(mesh), parallel.axis_rank(mesh)
    ds = synthetic_dataset(n_videos=12, k=6, d=32, maxlen=MAXLEN, seed=4)
    run = os.path.join(root, f"fit_dp{n}" if r == 0 else f"fit_rank{n}_{r}")
    res = tloop.fit(_fit_config(run, batch_size=0,
                                per_device_batch=BATCH // n, reload_=True),
                    ds, ds, None, mesh, max_updates=6, device="cpu")
    return {"updates": [x["update"] for x in res.log],
            "step": res.state["step"],
            "params": _numpy(res.state["params"])}


def _cli_train(mesh, root):
    from stvd_torch.cli import train as ttrain
    n = parallel.axis_size(mesh)
    run = os.path.join(root, f"cli{n}")
    flags = ["--preset", "msvd-dp", "--device", "cpu",
             "--max-updates", "2", "--data-parallel", "--no-shard-map"]
    for k, v in {**{f"model.{k}": v for k, v in MODEL.items()},
                 "data.synthetic_videos": 8, "train.per_device_batch": 2,
                 "train.valid_freq": 2, "train.save_dir": run}.items():
        flags += ["--set", f"{k}={v}"]
    rc = ttrain.main(flags)
    files = (sorted(os.listdir(run)) if parallel.axis_rank(mesh) == 0
             else None)
    return {"rc": rc, "files": files}


def _errors(mesh):
    """What the mesh paths refuse, as the JAX package refuses it."""
    out = {}
    try:
        tloop.make_train_step(tconfig.ModelConfig(**MODEL),
                              tconfig.TrainConfig(**{**TRAIN,
                                                     "grad_accum": 2}),
                              None, mesh)
    except ValueError as e:
        out["grad_accum"] = str(e)
    try:
        tloop.fit(_fit_config("unused", batch_size=BATCH - 1),
                  dataset(), None, None, mesh, device="cpu")
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def _collectives(mesh):
    """``replicate`` of rank-dependent state, ``psum_mean_grads`` and
    ``all_gather_rows`` of rank-dependent tensors."""
    r = parallel.axis_rank(mesh)
    tree = {"w": torch.full((2, 3), float(r)),
            "slots": (torch.arange(4) * (r + 1), [torch.tensor(r + 0.5)]),
            "count": (r + 7, {"step": 3 * r}),
            "generator": torch.Generator().manual_seed(100 + r)}
    tree = parallel.replicate(tree, mesh)
    mean = parallel.psum_mean_grads(
        {"a": torch.full((3,), float(r)), "b": torch.tensor(2.0 * r)}, mesh)
    return {"w": tree["w"].tolist(), "slots": tree["slots"][0].tolist(),
            "scalar": float(tree["slots"][1][0]), "count": tree["count"],
            "object": parallel.broadcast_object({"rank": r}, mesh),
            "draw": torch.rand(2, generator=tree["generator"]).tolist(),
            "mean": {k: v.tolist() for k, v in mean.items()},
            "gathered": parallel.all_gather_rows(
                torch.full((2, 2), r), mesh).tolist()}


def rank_checks(mesh, params, root):
    """Every check of one world size, on one rank."""
    torch.set_num_threads(1)
    out = {"rank": parallel.axis_rank(mesh), "size": parallel.axis_size(mesh),
           "backend": torch.distributed.get_backend()}
    out["collectives"] = _collectives(mesh)
    for spelling in ("pjit", "shard_map"):
        out[spelling] = _train(mesh, params, spelling)
    out["dropout"] = _dropout_update(mesh, params)
    out["split"] = _split_update(mesh, params)
    dcfg = tconfig.DecodeConfig(decode_batch=6, **DECODE)
    ds = dataset(seed=3, n=N_VIDEOS)
    out["captions"] = generate_captions(
        params_from_numpy(params, "cpu"), tconfig.ModelConfig(**MODEL),
        to_device(ds.bank, "cpu"), N_VIDEOS, dcfg, mesh=mesh)
    out["bank"] = _bank(mesh, params)
    out["fit"] = _fit(mesh, root)
    out["fit_reload"] = _fit_reload(mesh, root)
    out["cli"] = _cli_train(mesh, root)
    out["errors"] = _errors(mesh)
    out["modules"] = sorted(m for m in sys.modules
                            if m == "jax" or m.startswith("jax.")
                            or m == "stvd" or m.startswith("stvd."))
    return out


def _fail_on_rank_1(mesh):
    if parallel.axis_rank(mesh) == 1:
        raise RuntimeError("rank 1 fails")
    return "fine"


def _hang_on_rank_1(mesh):
    if parallel.axis_rank(mesh) == 1:
        time.sleep(60)
    return "fine"


# ---------------------------------------------------------------------------
# The JAX package's mesh paths, in this process
# ---------------------------------------------------------------------------

def jax_references(n, params):
    import jax
    import jax.numpy as jnp

    from stvd.api import Captioner as JCaptioner
    from stvd.config import Config, DecodeConfig, ModelConfig, TrainConfig
    from stvd.data.batching import gather_batch as jgather
    from stvd.data.batching import synthetic_dataset as jsynthetic
    from stvd.train import parallel as jparallel
    from stvd.train.evaluate import generate_captions as jgenerate
    from stvd.train.loop import make_optimizer, make_train_step

    mesh = jparallel.make_mesh(jax.devices()[:n])
    mcfg, tcfg = ModelConfig(**MODEL), TrainConfig(**TRAIN)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jds = jsynthetic(n_videos=BATCH, captions_per_video=1, k=6, d=32,
                     maxlen=MAXLEN, seed=0)
    batch = jgather(jds.bank.to_device(), jds.captions,
                    np.arange(BATCH, dtype=np.int32))
    batch["weight"] = jnp.asarray(WEIGHT)
    out = {}
    for spelling in ("pjit", "shard_map"):
        state = jparallel.replicate(
            {"params": jp, "opt_state": make_optimizer(tcfg).init(jp),
             "step": jnp.zeros((), jnp.int32),
             "rng": jax.random.PRNGKey(0)}, mesh)
        step = make_train_step(mcfg, tcfg, mesh=mesh,
                               use_shard_map=spelling == "shard_map")
        sharded = jparallel.shard_batch(batch, mesh)
        losses = []
        for _ in range(UPDATES):
            state, m = step(state, sharded)
            losses.append(float(m["loss"]))
        out[spelling] = {"losses": losses,
                         "params": {k: np.asarray(v) for k, v in
                                    state["params"].items()}}
    ds = jsynthetic(n_videos=N_VIDEOS, captions_per_video=1, k=6, d=32,
                    maxlen=MAXLEN, seed=3)
    out["captions"] = jgenerate(jp, mcfg, ds.bank.to_device(), N_VIDEOS,
                                DecodeConfig(decode_batch=6, **DECODE),
                                mesh=mesh)
    bank = jsynthetic(n_videos=N_VIDEOS, captions_per_video=1, k=6, d=32,
                      maxlen=MAXLEN, seed=7).bank
    vocab = jsynthetic(n_videos=BATCH, captions_per_video=1, k=6, d=32,
                       maxlen=MAXLEN, seed=0).vocab

    def captioner(bsz):
        cap = JCaptioner(jp, Config(model=mcfg, decode=DecodeConfig(
            decode_batch=bsz, **DECODE)), vocab)
        cap.attach_bank(bank, mesh=mesh)
        return cap

    out["caption_ids"] = {}
    for name, bsz in CAPTION_BATCHES.items():
        cap = captioner(bsz)
        out["caption_ids"][name] = cap.caption_ids(
            [cap.bank_ids[i] for i in ORDER])
    out["nbest_ids"] = {}
    for name, bsz in NBEST_BATCHES.items():
        cap = captioner(bsz)
        out["nbest_ids"][name] = cap.nbest_ids(cap.bank_ids[:7], n=2)
    return out


@pytest.fixture(scope="module")
def weights():
    """numpy weights with the JAX names and shapes, at a scale that keeps
    logits apart (``test_torch_step.numpy_params``)."""
    from conftest import small_cfg
    from test_torch_step import numpy_params
    return numpy_params(small_cfg(**{k: v for k, v in MODEL.items()
                                     if k != "compute_dtype"}))


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"ranks{n}")
def run(request, weights, tmp_path_factory):
    n = request.param
    ref = jax_references(n, weights)
    root = str(tmp_path_factory.mktemp(f"ranks{n}"))
    ranks = parallel.spawn(rank_checks, n, (weights, root), device="cpu",
                           timeout=RANK_TIMEOUT)
    return n, ref, ranks


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spelling", ["pjit", "shard_map"])
def test_dp_train_updates_match_jax(run, spelling):
    """3 DP updates on n ranks against the JAX package's DP step over n
    virtual devices: loss within 1e-5 relative, each parameter within
    1e-5."""
    _, ref, ranks = run
    want = ref[spelling]
    for got in (r[spelling] for r in ranks):
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=1e-5)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                       atol=1e-5, err_msg=k)


def test_dp_ranks_hold_bitwise_equal_parameters(run):
    """After 3 updates every rank holds the same bits, in both
    spellings, and the two spellings (one update) agree bit for bit."""
    _, _, ranks = run
    for spelling in ("pjit", "shard_map"):
        first = ranks[0][spelling]["params"]
        for r in ranks[1:]:
            for k, v in r[spelling]["params"].items():
                assert np.array_equal(v, first[k]), (spelling, k)
    for k, v in ranks[0]["pjit"]["params"].items():
        assert np.array_equal(v, ranks[0]["shard_map"]["params"][k]), k


def test_dp_dropout_update_matches_single_process(run):
    """With dropout each rank draws the global batch's masks and keeps
    its rows, so a DP update equals the single-process update."""
    _, _, ranks = run
    for r in ranks:
        dp, single = r["dropout"]["dp"], r["dropout"]["single"]
        assert abs(dp["loss"] - single["loss"]) <= 1e-5 * abs(
            single["loss"])
        for k, v in single["params"].items():
            np.testing.assert_allclose(dp["params"][k], v, rtol=0,
                                       atol=1e-6, err_msg=k)


def test_dp_update_is_the_split_update_bit_for_bit(run):
    """A DP update is one process's update of the same split
    (``grad_accum`` = the ranks): the one all-reduce adds the shares'
    gradients and loss terms as the microbatch loop does, and both
    divide once by the global example weight.  Bit for bit on 2 ranks
    (one addition, which commutes); on 4 the all-reduce may add the
    shares in another order than the loop: within 1e-6 of each leaf's
    largest entry."""
    n, _, ranks = run
    for r in ranks:
        dp, split = r["split"]["dp"], r["split"]["split"]
        if n == 2:
            assert dp["loss"] == split["loss"]
            for k, v in split["params"].items():
                assert np.array_equal(dp["params"][k], v), k
        else:
            assert dp["loss"] == pytest.approx(split["loss"], rel=1e-6)
            for k, v in split["params"].items():
                np.testing.assert_allclose(
                    dp["params"][k], v, rtol=0,
                    atol=1e-6 * np.abs(v).max(), err_msg=k)


def test_dp_generate_captions_match_jax(run):
    """Each rank decodes its slice of every decode batch (6 rows: 3 a
    rank on 2 ranks, 4 rows on 4); every rank returns every caption,
    token for token the JAX package's mesh decode."""
    _, ref, ranks = run
    for r in ranks:
        assert r["captions"] == ref["captions"]


@pytest.mark.parametrize("chunk", sorted(CAPTION_BATCHES))
def test_sharded_bank_caption_ids_match_jax(run, chunk):
    """``caption_ids`` over a bank sharded on the ranks: a decode batch
    of 8 divides the axis (gathered, then decoded data-parallel), one of
    5 does not (decoded whole on every rank)."""
    _, ref, ranks = run
    want = ref["caption_ids"][chunk]
    assert len(want) == N_VIDEOS
    for r in ranks:
        assert r["bank"]["caption_ids"][chunk] == want


@pytest.mark.parametrize("chunk", sorted(NBEST_BATCHES))
def test_sharded_bank_nbest_ids_match_jax(run, chunk):
    _, ref, ranks = run
    want = ref["nbest_ids"][chunk]
    for r in ranks:
        got = r["bank"]["nbest_ids"][chunk]
        assert [[t for t, _ in row] for row in got] == \
            [[t for t, _ in row] for row in want]
        for grow, wrow in zip(got, want):
            np.testing.assert_allclose([s for _, s in grow],
                                       [s for _, s in wrow], rtol=1e-5)


def test_sharded_bank_holds_a_share_on_each_rank(run):
    """10 videos on n ranks: every rank holds ceil(10 / n) rows of each
    stream (padded with zeros), not the whole bank."""
    n, _, ranks = run
    for r in ranks:
        assert r["bank"]["shard_rows"] == {"frames": -(-N_VIDEOS // n),
                                           "frame_mask": -(-N_VIDEOS // n)}


def test_dp_fit_matches_single_process_fit(run):
    """``fit(..., mesh)`` with ``per_device_batch`` and dropout against
    the single-process ``fit`` at the same global batch: loss per update
    within 1e-5 relative, the same valid metrics; only rank 0 writes."""
    n, _, ranks = run
    single = ranks[0]["fit"]["single"]
    for r in ranks:
        dp = r["fit"]["dp"]
        assert [x["update"] for x in dp["log"]] == [1, 2, 3, 4]
        np.testing.assert_allclose([x["loss"] for x in dp["log"]],
                                   [x["loss"] for x in single["log"]],
                                   rtol=1e-5)
        assert [h["update"] for h in dp["history"]] == [2, 4]
        for got, want in zip(dp["history"], single["history"]):
            assert set(got) == set(want)
            for k in want:
                assert got[k] == pytest.approx(want[k], rel=1e-5), k
        for k, v in dp["params"].items():
            assert np.array_equal(v, ranks[0]["fit"]["dp"]["params"][k]), k
    kinds = ranks[0]["fit"]["records"]
    assert kinds.count("valid") == 2 and kinds.count("train") == 4
    assert kinds.count("sample") == 4
    assert {"ckpt.pt", "ckpt_best.pt", "metrics.jsonl",
            "valid_samples.txt"} <= set(ranks[0]["fit"]["files"])


def test_dp_fit_reloads_rank_0_s_checkpoint(run):
    """``reload_`` over the mesh resumes every rank from rank 0's
    checkpoint (step 4 of ``_fit``'s run), also where a rank's own
    ``save_dir`` holds none: every rank runs updates 5 and 6 and ends
    with the same bits."""
    _, _, ranks = run
    first = ranks[0]["fit_reload"]["params"]
    for r in ranks:
        assert r["fit_reload"]["updates"] == [5, 6]
        assert r["fit_reload"]["step"] == 6
        for k, v in r["fit_reload"]["params"].items():
            assert np.array_equal(v, first[k]), k


def test_cli_train_data_parallel_over_the_ranks(run):
    """``cli.train --preset msvd-dp --data-parallel`` on the ranks of a
    launch: every rank returns 0, rank 0 writes the run directory."""
    _, _, ranks = run
    assert [r["cli"]["rc"] for r in ranks] == [0] * len(ranks)
    assert {"config.json", "vocab.pkl", "ckpt.pt",
            "metrics.jsonl"} <= set(ranks[0]["cli"]["files"])


def test_mesh_paths_refuse_what_jax_refuses(run):
    _, _, ranks = run
    for r in ranks:
        assert "grad_accum" in r["errors"]["grad_accum"]
        assert "divisible" in r["errors"]["indivisible"]


def test_ranks_import_no_jax_and_run_gloo(run):
    n, _, ranks = run
    assert [r["rank"] for r in ranks] == list(range(n))
    for r in ranks:
        assert r["size"] == n and r["backend"] == "gloo"
        assert r["modules"] == []


def test_replicate_and_reductions_over_the_ranks(run):
    """``replicate`` gives every rank rank 0's tensors, generator state
    and other leaves (counts), ``broadcast_object`` rank 0's object;
    ``psum_mean_grads`` is the rank mean; ``all_gather_rows``
    stacks the ranks' rows in rank order."""
    n, _, ranks = run
    draw = torch.rand(2, generator=torch.Generator().manual_seed(100))
    for r in ranks:
        c = r["collectives"]
        assert c["w"] == [[0.0] * 3] * 2 and c["slots"] == [0, 1, 2, 3]
        assert c["scalar"] == 0.5 and c["draw"] == draw.tolist()
        assert c["count"] == (7, {"step": 0}) and c["object"] == {"rank": 0}
        mean = (n - 1) / 2
        assert c["mean"] == {"a": [mean] * 3, "b": 2 * mean}
        assert c["gathered"] == [[q, q] for q in range(n) for _ in (0, 1)]


def test_spawn_raises_when_a_rank_fails():
    from torch.multiprocessing import ProcessRaisedException
    with pytest.raises(ProcessRaisedException, match="rank 1 fails"):
        parallel.spawn(_fail_on_rank_1, 2, device="cpu", timeout=60)


def test_spawn_ends_hung_ranks_at_its_time_limit():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        parallel.spawn(_hang_on_rank_1, 2, device="cpu", timeout=5)
    assert time.monotonic() - t0 < 30


class _Mesh:
    """Stand-in for a DeviceMesh's bookkeeping, for what needs no group."""

    def __init__(self, size, rank, names=("data",)):
        self._size, self._rank, self.mesh_dim_names = size, rank, names

    def size(self, dim=None):
        return self._size

    def get_local_rank(self, name=None):
        return self._rank


def test_shard_batch_takes_the_rank_s_contiguous_rows():
    batch = {"a": np.arange(8), "b": torch.arange(16).view(8, 2)}
    got = parallel.shard_batch(batch, _Mesh(4, 2))
    assert got["a"].tolist() == [4, 5]
    assert got["b"].tolist() == [[8, 9], [10, 11]]
    with pytest.raises(ValueError, match="divide"):
        parallel.shard_batch(batch, _Mesh(3, 0))


def test_model_axis_raises_naming_its_item():
    with pytest.raises(NotImplementedError, match="item 8b"):
        parallel.make_mesh_2d(model_parallel=2)
    with pytest.raises(NotImplementedError, match="item 8b"):
        parallel.check_data_mesh(_Mesh(2, 0, names=("data", "model")))
