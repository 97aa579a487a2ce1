"""Tensor parallelism of the port (a 2-D data x model mesh:
``train.parallel``, ``model.tp``, ``decode.parallel``) against the JAX
package's 2-D mesh paths, over gloo on the CPU.

As in tests/test_torch_parallel.py the ranks are spawned processes
(``parallel.spawn``: a file store in a fresh directory, a time limit on
every collective and on the launch), one spawn a world that computes
every check, and the references come from the JAX package in this
process over the conftest's 8 virtual CPU devices
(``make_mesh_2d(devs[:n], model_parallel=M)``); they are computed while
the ranks run and reach the tests as numpy arrays.  The ranks import no
``jax``.  Worlds: 1 x 2 and 2 x 2 (data x model).

* ``state_shardings`` against the JAX package's spec of every leaf, for
  the temporal, spatial and motion + frame-LSTM configs and an
  indivisible vocab;
* 3 TP updates of each of those configs (sgd, clip on) against the JAX
  TP step: loss within 1e-5 relative, the gathered parameters within
  1e-5; one scheduled-sampling update (the JAX package's coins) and one
  autodiff-scan update likewise;
* replicated leaves bitwise equal on every rank, sharded slices bitwise
  equal across the data axis;
* the per-shard logit tail and its exact merge on quantized tie inputs
  against ``_tp_tail_factory``, and its refusal of an indivisible vocab;
* TP beam and greedy decode against ``make_tp_beam_decode`` (tail 'tp'
  and 'off') and the single-device decode: the same tokens, the same
  tokens on every rank of a model group;
* ``fit`` over the mesh against the single-process ``fit``, its
  full-state checkpoint loaded in one process and resumed by the ranks,
  ``cli.train --model-parallel 2`` and the refusals.
"""

from __future__ import annotations

import os
import sys
import threading

import numpy as np
import pytest
import torch

from stvd_torch import config as tconfig
from stvd_torch.data.bank import to_device
from stvd_torch.data.batching import gather_batch, synthetic_dataset
from stvd_torch.decode import parallel as dparallel
from stvd_torch.decode.beam import beam_decode
from stvd_torch.decode.greedy import greedy_decode
from stvd_torch.model import tp
from stvd_torch.model.convert import params_from_numpy
from stvd_torch.train import loop as tloop
from stvd_torch.train import parallel

WORLDS = ((1, 2), (2, 2))          # (data, model)
MODEL = dict(n_words=48, dim_word=16, dim=32, ctx_dim=32, n_frames=6,
             compute_dtype="float32", use_dropout=False)
TRAIN = dict(optimizer="sgd", lr=0.1, batch_size=8, clip_c=1.0,
             donate_state=False)
CONFIGS = {"temporal": {},
           "spatial": dict(use_spatial=True, n_regions=4, region_dim=16),
           "motion_lstm": dict(use_motion=True, motion_dim=20,
                               encoder="lstm")}
BATCH = 8
WEIGHT = np.array([1, 1, 1, 1, 1, 1, 1, 0], np.float32)  # wrapped tail
UPDATES = 3
MAXLEN = 10
SS_PROB = 0.25
DECODE = dict(beam_size=3, maxlen=MAXLEN, length_norm=0.6)
TAIL = dict(rows=16, dw=16, v=256, k=5)
RANK_TIMEOUT = 120.0


def model_cfg(name, **kw):
    return dict(MODEL, **CONFIGS[name], **kw)


def dataset(name="temporal", seed=0, n=BATCH, module=None):
    kw = {k: v for k, v in CONFIGS[name].items()
          if k in ("n_regions", "region_dim", "motion_dim")}
    make = synthetic_dataset if module is None else module
    return make(n_videos=n, captions_per_video=1, k=6, d=32, maxlen=MAXLEN,
                seed=seed, **kw)


def tie_inputs():
    """test_parallel.py's quantized logits: rows with equal values."""
    rng = np.random.RandomState(0)
    act = (np.round(rng.randn(TAIL["rows"], TAIL["dw"]) * 2) / 2
           ).astype(np.float32)
    w = (np.round(rng.randn(TAIL["dw"], TAIL["v"])) / 4).astype(np.float32)
    b = (np.round(rng.randn(TAIL["v"])) / 4).astype(np.float32)
    return act, w, b


# ---------------------------------------------------------------------------
# The ranks (no jax here)
# ---------------------------------------------------------------------------

def _numpy(params):
    return {k: v.detach().numpy().copy() for k, v in params.items()}


def _full_state(params, tcfg):
    p = params_from_numpy(params, "cpu")
    for v in p.values():
        v.requires_grad_(True)
    return {"params": p, "opt_state": tloop.make_optimizer(tcfg).init(p),
            "step": 0, "generator": torch.Generator().manual_seed(0)}


def _global_batch(name):
    ds = dataset(name)
    b = gather_batch(to_device(ds.bank, "cpu"), ds.captions,
                     np.arange(BATCH))
    b["weight"] = torch.from_numpy(WEIGHT)
    return b


def _train(mesh, params, name, updates=UPDATES, **kw):
    """``updates`` TP updates from the full state: losses, the gathered
    parameters and this rank's own."""
    mcfg = tconfig.ModelConfig(**model_cfg(name, **kw.pop("model", {})))
    tcfg = tconfig.TrainConfig(**dict(TRAIN, **kw))
    full = _full_state(params, tcfg)
    shardings = parallel.state_shardings(full, mesh)
    state = parallel.shard_state(full, mesh)
    step = tloop.make_train_step(mcfg, tcfg, None, mesh)
    batch = parallel.shard_batch(_global_batch(name), mesh)
    losses = []
    for _ in range(updates):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    whole = parallel.gather_state(state, mesh, shardings)
    return {"losses": losses, "grad_norm": float(m["grad_norm"]),
            "params": _numpy(whole["params"]),
            "local": _numpy(state["params"])}


def _ss_update(mesh, params, coins):
    """One scheduled-sampling update, the scan drawing the JAX package's
    coins (cut to this rank's rows, as ``rand_rows`` cuts its draws)."""
    from stvd_torch.model import decoder as tdecoder
    rows = parallel.local_slice(BATCH, mesh)
    real = tdecoder._ss_coins
    tdecoder._ss_coins = lambda g, p, b, t, device: torch.from_numpy(
        coins[:, rows]).to(device)
    try:
        return _train(mesh, params, "temporal", 1, ss_prob=SS_PROB)
    finally:
        tdecoder._ss_coins = real


def _tail(mesh):
    """The per-shard tail on this rank's columns of the tie inputs, and
    the factory's answer for an indivisible vocab."""
    act, w, b = (torch.from_numpy(x) for x in tie_inputs())
    m, r = parallel.model_axis_size(mesh), parallel.model_rank(mesh)
    part = TAIL["v"] // m
    cols = slice(r * part, (r + 1) * part)
    mk = dparallel._tp_tail_factory(mesh)
    with tp.model_axis(mesh, tconfig.ModelConfig(**dict(MODEL,
                                                        n_words=TAIL["v"]))):
        vals, idx, lse = mk(w[:, cols].contiguous(), b[cols].contiguous(),
                            TAIL["k"])(act)
    with tp.model_axis(mesh, tconfig.ModelConfig(**dict(
            MODEL, n_words=TAIL["v"] - 1))):
        declined = mk(w[:, :-1], b[:-1], TAIL["k"]) is None
    return {"vals": vals.numpy(), "idx": idx.numpy(), "lse": lse.numpy(),
            "declined": declined}


def _decode(mesh, params):
    """TP beam decode through both tails and TP greedy decode of the
    rank's rows (the kernel step: on the CPU its wrappers run the plain
    versions)."""
    from stvd_torch.model import kernel
    mcfg = tconfig.ModelConfig(**MODEL)
    ds = dataset(seed=7)
    batch = parallel.shard_batch(
        {k: v for k, v in to_device(ds.bank, "cpu").items()}, mesh)
    p = dparallel.shard_decode_params(params_from_numpy(params, "cpu"), mesh)
    out = {}
    with torch.no_grad():
        for tail in ("tp", "off"):
            r = dparallel.make_tp_beam_decode(mcfg, mesh, tail=tail,
                                              **DECODE)(p, batch)
            out[tail] = (r.tokens.numpy(), r.norm_scores.numpy())
        with tp.model_axis(mesh, mcfg):
            g = greedy_decode(p, mcfg, batch, maxlen=MAXLEN,
                              step_fn=dparallel.make_tp_step(
                                  mesh, kernel.step_kernels))
        out["greedy"] = g.tokens.numpy()
    return out


def _fit_config(save_dir, **train):
    model = tconfig.ModelConfig(**dict(MODEL, use_dropout=True))
    tc = tconfig.TrainConfig(**{
        **TRAIN, "metric": "bleu4", "disp_freq": 1, "valid_freq": 2,
        "sample_freq": 2, "save_freq": 0, "save_dir": str(save_dir),
        **train})
    return tconfig.Config(model=model, train=tc,
                          decode=tconfig.DecodeConfig(decode_batch=6,
                                                      **DECODE))


def _fit(mesh, root):
    """``fit`` over the mesh for 2 updates, then resumed with ``reload_``
    to 4 (rank 0 in the run's directory, every other rank in an empty
    one); on rank 0 the single-process ``fit`` and its checkpoint's
    leaves."""
    tag = f"{parallel.axis_size(mesh)}x{parallel.model_axis_size(mesh)}"
    first = parallel.is_first_rank(mesh)
    ds = synthetic_dataset(n_videos=12, k=6, d=32, maxlen=MAXLEN, seed=4)
    run = os.path.join(root, f"fit{tag}")
    res = tloop.fit(_fit_config(run), ds, ds, None, mesh, max_updates=2,
                    device="cpu")
    out = {"log": res.log, "history": res.history,
           "params": _numpy(res.state["params"])}
    again = tloop.fit(
        _fit_config(run if first else os.path.join(
            root, f"fit{tag}_{torch.distributed.get_rank()}"),
            reload_=True), ds, ds, None, mesh, max_updates=4, device="cpu")
    out["reload"] = {"updates": [x["update"] for x in again.log],
                     "step": again.state["step"],
                     "params": _numpy(again.state["params"])}
    if first:
        single = tloop.fit(_fit_config(os.path.join(root, f"one{tag}")),
                           ds, ds, max_updates=2, device="cpu")
        out["single"] = {"log": single.log, "history": single.history}
        blob = torch.load(os.path.join(run, "ckpt_best.pt"),
                          weights_only=True)
        out["ckpt_shapes"] = {k: tuple(v.shape)
                              for k, v in blob["params"].items()}
    return out


def _cli(mesh, root):
    from stvd_torch.cli import train as ttrain
    run = os.path.join(root, "cli")
    flags = ["--preset", "msvd-beam", "--device", "cpu", "--max-updates",
             "2", "--model-parallel", str(parallel.model_axis_size(mesh))]
    for k, v in {**{f"model.{k}": v for k, v in MODEL.items()},
                 "data.synthetic_videos": 8, "train.batch_size": 4,
                 "train.valid_freq": 2, "train.save_dir": run}.items():
        flags += ["--set", f"{k}={v}"]
    rc = ttrain.main(flags)
    files = sorted(os.listdir(run)) if parallel.is_first_rank(mesh) else None
    return {"rc": rc, "files": files}


def _errors(mesh):
    """What the 2-D mesh paths refuse."""
    out = {}
    mcfg = tconfig.ModelConfig(**MODEL)
    tcfg = tconfig.TrainConfig(**TRAIN)
    for name, call in (
            ("shard_map", lambda: tloop.make_train_step(
                mcfg, tcfg, None, mesh, use_shard_map=True)),
            ("gates_kernel", lambda: tloop.make_train_step(
                tconfig.ModelConfig(**dict(MODEL, gates_kernel="on")),
                tcfg, None, mesh)),
            ("train_tail_kernel", lambda: tloop.make_train_step(
                tconfig.ModelConfig(**dict(MODEL, train_tail_kernel="on")),
                tcfg, None, mesh)),
            ("indivisible", lambda: parallel.make_mesh_2d(
                "cpu", model_parallel=3))):
        try:
            call()
        except ValueError as e:
            out[name] = str(e)
    return out


def rank_checks(mesh1, model, weights, coins, root, entry_points):
    """Every check of one world, on one rank (``fit``, ``cli.train`` and
    the refusals with ``entry_points``: the first world only, to keep the
    file within its time)."""
    torch.set_num_threads(1)
    mesh = parallel.make_mesh_2d("cpu", model_parallel=model)
    out = {"rank": torch.distributed.get_rank(),
           "data_rank": parallel.axis_rank(mesh),
           "model_rank": parallel.model_rank(mesh),
           "backend": torch.distributed.get_backend()}
    out["train"] = {name: _train(mesh, weights[name], name)
                    for name in CONFIGS}
    out["ss"] = _ss_update(mesh, weights["temporal"], coins)
    out["autodiff"] = _train(mesh, weights["temporal"], "temporal", 1,
                             model={"fused_seq_grad": False})
    out["tail"] = _tail(mesh)
    out["decode"] = _decode(mesh, weights["temporal"])
    if entry_points:
        out["fit"] = _fit(mesh, root)
        out["cli"] = _cli(mesh, root)
        out["errors"] = _errors(mesh)
    out["modules"] = sorted(m for m in sys.modules
                            if m == "jax" or m.startswith("jax.")
                            or m == "stvd" or m.startswith("stvd."))
    return out


# ---------------------------------------------------------------------------
# The JAX package's 2-D mesh paths, in this process
# ---------------------------------------------------------------------------

def jax_params(p):
    import jax.numpy as jnp
    return {k: jnp.asarray(v) for k, v in p.items()}


def jax_coins():
    """The JAX TP step's scheduled-sampling coins: its loss key is the
    second half of ``split(PRNGKey(0))``, whose sampling half gives one
    key a step (tests/test_torch_train.py's ``jax_coins``)."""
    import jax
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    _, rng_ss = jax.random.split(sub)
    keys = jax.random.split(rng_ss, MAXLEN)
    return np.stack([np.asarray(jax.random.bernoulli(keys[i], SS_PROB,
                                                     (BATCH,)))
                     for i in range(MAXLEN)])


def jax_references(n, model, weights):
    import jax
    import jax.numpy as jnp

    from stvd.config import ModelConfig, TrainConfig
    from stvd.data.batching import gather_batch as jgather
    from stvd.data.batching import synthetic_dataset as jsynthetic
    from stvd.decode import parallel as jdparallel
    from stvd.decode.greedy import greedy_decode as jgreedy
    from stvd.train import parallel as jparallel
    from stvd.train.loop import make_optimizer, make_train_step

    mesh = jparallel.make_mesh_2d(jax.devices()[:n], model_parallel=model)
    out = {"train": {}}

    def train(name, updates=UPDATES, model_kw=None, **kw):
        mcfg = ModelConfig(**model_cfg(name, **(model_kw or {})))
        tcfg = TrainConfig(**dict(TRAIN, **kw))
        jp = jax_params(weights[name])
        state = jparallel.shard_state(
            {"params": jp, "opt_state": make_optimizer(tcfg).init(jp),
             "step": jnp.zeros((), jnp.int32),
             "rng": jax.random.PRNGKey(0)}, mesh)
        ds = dataset(name, module=jsynthetic)
        batch = jgather(ds.bank.to_device(), ds.captions,
                        np.arange(BATCH, dtype=np.int32))
        batch["weight"] = jnp.asarray(WEIGHT)
        step = make_train_step(mcfg, tcfg, mesh=mesh)
        sharded = jparallel.shard_batch(batch, mesh)
        losses = []
        for _ in range(updates):
            state, m = step(state, sharded)
            losses.append(float(m["loss"]))
        return {"losses": losses, "grad_norm": float(m["grad_norm"]),
                "params": {k: np.asarray(v)
                           for k, v in state["params"].items()}}

    for name in CONFIGS:
        out["train"][name] = train(name)
    out["ss"] = train("temporal", 1, ss_prob=SS_PROB)
    out["autodiff"] = train("temporal", 1,
                            model_kw={"fused_seq_grad": False})

    act, w, b = tie_inputs()
    tail = jdparallel._tp_tail_factory(mesh)(jnp.asarray(w), jnp.asarray(b),
                                            TAIL["k"])
    vals, idx, lse = jax.jit(tail)(jnp.asarray(act))
    out["tail"] = {"vals": np.asarray(vals), "idx": np.asarray(idx),
                   "lse": np.asarray(lse),
                   "declined": jdparallel._tp_tail_factory(mesh)(
                       jnp.asarray(w[:, :-1]), jnp.asarray(b[:-1]),
                       TAIL["k"]) is None}

    mcfg = ModelConfig(**MODEL)
    ds = dataset(seed=7, module=jsynthetic)
    dev = ds.bank.to_device()
    batch = jparallel.shard_batch({k: dev[k] for k in ("frames",
                                                       "frame_mask")}, mesh)
    p_sh = jdparallel.shard_decode_params(jax_params(weights["temporal"]),
                                          mesh)
    out["decode"] = {}
    for t in ("tp", "off"):
        r = jdparallel.make_tp_beam_decode(mcfg, mesh, tail=t,
                                           **DECODE)(p_sh, batch)
        out["decode"][t] = (np.asarray(r.tokens), np.asarray(r.norm_scores))
    step = jdparallel.make_tp_step(mesh)
    out["decode"]["greedy"] = np.asarray(jax.jit(
        lambda p, bt: jgreedy(p, mcfg, bt, maxlen=MAXLEN,
                              step_fn=step).tokens)(p_sh, batch))
    return out


def jax_specs(name, model, **kw):
    """The JAX package's spec of every leaf of a train state, as the
    sharded axis (or None), keyed by the leaf's path."""
    import jax

    from stvd.config import ModelConfig, TrainConfig
    from stvd.train import parallel as jparallel
    from stvd.train.loop import init_train_state

    mesh = jparallel.make_mesh_2d(jax.devices()[:2 * model],
                                  model_parallel=model)
    state = init_train_state(jax.random.PRNGKey(0),
                             ModelConfig(**model_cfg(name, **kw)),
                             TrainConfig(**TRAIN))
    specs = jparallel.state_shardings(state, mesh)
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        axes = [i for i, a in enumerate(s.spec) if a == "model"]
        out[jax.tree_util.keystr(path)] = axes[0] if axes else None
    return out


@pytest.fixture(scope="module")
def weights():
    """numpy weights with the JAX names and shapes of each config, at a
    scale that keeps logits apart (``test_torch_step.numpy_params``)."""
    from conftest import small_cfg
    from test_torch_step import numpy_params
    return {name: numpy_params(small_cfg(**{
        k: v for k, v in model_cfg(name).items() if k != "compute_dtype"}))
        for name in CONFIGS}


@pytest.fixture(scope="module", params=WORLDS,
                ids=lambda w: f"mesh{w[0]}x{w[1]}")
def run(request, weights, tmp_path_factory):
    """One spawn of the world's ranks, the JAX references computed
    while they run."""
    data, model = request.param
    n = data * model
    root = str(tmp_path_factory.mktemp(f"tp{data}x{model}"))
    coins = jax_coins()
    box = {}

    def ranks():
        try:
            box["ranks"] = parallel.spawn(
                rank_checks, n, (model, weights, coins, root,
                                 request.param == WORLDS[0]),
                device="cpu", timeout=RANK_TIMEOUT)
        except BaseException as e:     # raised again below
            box["error"] = e

    th = threading.Thread(target=ranks)
    th.start()
    try:
        ref = jax_references(n, model, weights)
    finally:
        th.join()
    if "error" in box:
        raise box["error"]
    return data, model, ref, box["ranks"]


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

class _Mesh2D:
    """A DeviceMesh's bookkeeping for what needs no process group."""
    mesh_dim_names = ("data", "model")

    def __init__(self, model):
        self._model = model

    def size(self, dim=None):
        return {0: 2, 1: self._model}[dim]

    def get_local_rank(self, name=None):
        return 0


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("name,kw", [
    ("temporal", {}), ("spatial", {}), ("motion_lstm", {}),
    ("temporal", {"n_words": 50})],
    ids=["temporal", "spatial", "motion_lstm", "indivisible_vocab"])
def test_state_shardings_match_jax(name, kw, model):
    """Each leaf of a train state (parameters and both adadelta slots) is
    sharded on the JAX package's axis, or replicated where it is; with
    50 words ``ff_logit_W`` is replicated on a model axis of 4 and
    ``U`` sharded."""
    mcfg = tconfig.ModelConfig(**model_cfg(name, **kw))
    tcfg = tconfig.TrainConfig(**dict(TRAIN, optimizer="adadelta"))
    state = tloop.init_train_state(0, mcfg, tcfg, "cpu")
    got = parallel.state_shardings(state, _Mesh2D(model))
    want = jax_specs(name, model, **kw)
    params = {k: v for k, v in want.items() if k.startswith("['params']")}
    assert len(params) == len(got["params"])
    for k, ax in got["params"].items():
        assert ax == want[f"['params']['{k}']"], k
    for slot in range(2):
        for k, ax in got["opt_state"][1][slot].items():
            assert ax == got["params"][k], k
    assert any(ax is not None for ax in got["params"].values())
    if kw:
        assert got["params"]["U"] == 0
        assert (got["params"]["ff_logit_W"] is None) == (model == 4)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tp_train_updates_match_jax(run, name):
    """3 TP updates (sgd, global-norm clip at 1) against the JAX TP step
    on the same 2-D mesh: loss within 1e-5 relative, each gathered
    parameter within 1e-5, the clip's norm within 1e-5 relative."""
    _, _, ref, ranks = run
    want = ref["train"][name]
    for got in (r["train"][name] for r in ranks):
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=1e-5)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kind", ["ss", "autodiff"])
def test_tp_autograd_scan_updates_match_jax(run, kind):
    """One update of the scheduled-sampling scan (the JAX package's
    coins) and one of the autodiff scan, both through autograd with the
    products over the model axis, against the JAX TP step."""
    _, _, ref, ranks = run
    want = ref[kind]
    for got in (r[kind] for r in ranks):
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=0,
                                       atol=1e-5, err_msg=k)


def test_ranks_hold_their_shards_bitwise(run):
    """Replicated leaves are bitwise equal on every rank; a sharded
    leaf's slice is bitwise equal across the data axis, and the slices
    of a model group put together are the gathered leaf."""
    data, model, _, ranks = run
    for name in CONFIGS:
        full = ranks[0]["train"][name]["params"]
        for r in ranks:
            local = r["train"][name]["local"]
            mate = ranks[r["model_rank"]]["train"][name]["local"]
            for k, v in local.items():
                assert np.array_equal(v, mate[k]), (name, k)
                if v.shape == full[k].shape:
                    assert np.array_equal(v, full[k]), (name, k)
                else:
                    ax = [i for i, (a, b) in enumerate(zip(v.shape,
                                                           full[k].shape))
                          if a != b][0]
                    part = full[k].shape[ax] // model
                    want = np.take(full[k], range(r["model_rank"] * part,
                                                  (r["model_rank"] + 1)
                                                  * part), axis=ax)
                    assert np.array_equal(v, want), (name, k)
    # the big weights are sharded, not quietly replicated
    local = ranks[0]["train"]["temporal"]["local"]
    assert local["U"].shape[0] == MODEL["dim"] // model
    assert local["ff_logit_W"].shape[1] == MODEL["n_words"] // model


def test_tail_merge_matches_jax_on_ties(run):
    """The per-shard tail and its merge on quantized ties: ids equal,
    vals within 1e-6, lse within 1e-5 of ``_tp_tail_factory``'s; both
    decline an indivisible vocab."""
    _, _, ref, ranks = run
    want = ref["tail"]
    for r in ranks:
        got = r["tail"]
        np.testing.assert_array_equal(got["idx"], want["idx"])
        np.testing.assert_allclose(got["vals"], want["vals"], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got["lse"], want["lse"], rtol=1e-5,
                                   atol=1e-6)
        assert got["declined"] and want["declined"]


def test_tp_decode_matches_jax_and_single_device(run, weights):
    """TP beam decode through the per-shard tail and through the gathered
    logits, and TP greedy decode, give each data rank the JAX package's
    tokens for its rows (``make_tp_beam_decode`` tail 'tp' and 'off',
    ``greedy_decode`` with ``make_tp_step``) and the port's single-device
    tokens; norm_scores within 1e-5; every rank of a model group the
    same tokens."""
    data, model, ref, ranks = run
    mcfg = tconfig.ModelConfig(**MODEL)
    ds = dataset(seed=7)
    p = params_from_numpy(weights["temporal"], "cpu")
    bank = to_device(ds.bank, "cpu")
    with torch.no_grad():
        single = beam_decode(p, mcfg, bank, **DECODE)
        single_g = greedy_decode(p, mcfg, bank, maxlen=MAXLEN)
    share = BATCH // data
    for r in ranks:
        rows = slice(r["data_rank"] * share, (r["data_rank"] + 1) * share)
        dec = r["decode"]
        for t in ("tp", "off"):
            toks, norm = dec[t]
            np.testing.assert_array_equal(toks, ref["decode"][t][0][rows])
            np.testing.assert_array_equal(toks, single.tokens[rows].numpy())
            np.testing.assert_allclose(norm, ref["decode"][t][1][rows],
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(dec["greedy"],
                                      ref["decode"]["greedy"][rows])
        np.testing.assert_array_equal(dec["greedy"],
                                      single_g.tokens[rows].numpy())
        lead = ranks[r["data_rank"] * model]["decode"]
        for t in ("tp", "off"):
            assert np.array_equal(dec[t][0], lead[t][0])
            assert np.array_equal(dec[t][1], lead[t][1])


FIRST_WORLD = pytest.mark.parametrize("run", WORLDS[:1], indirect=True,
                                      ids=lambda w: f"mesh{w[0]}x{w[1]}")


@FIRST_WORLD
def test_tp_fit_matches_single_process_fit(run):
    """``fit`` over the 2-D mesh with dropout against the single-process
    ``fit``: loss per update within 1e-5 relative, the same valid
    metrics, the whole state on every rank; rank 0's checkpoint holds
    full-width leaves, and a reload resumes every rank from it (updates
    3 and 4, the same bits on every rank)."""
    _, _, _, ranks = run
    first = ranks[0]["fit"]
    single = first["single"]
    for r in ranks:
        got = r["fit"]
        assert [x["update"] for x in got["log"]] == [1, 2]
        np.testing.assert_allclose([x["loss"] for x in got["log"]],
                                   [x["loss"] for x in single["log"]],
                                   rtol=1e-5)
        assert [h["update"] for h in got["history"]] == [2]
        for a, b in zip(got["history"], single["history"]):
            assert set(a) == set(b)
            for k in b:
                assert a[k] == pytest.approx(b[k], rel=1e-5), k
        for k, v in got["params"].items():
            assert np.array_equal(v, first["params"][k]), k
        assert got["reload"]["updates"] == [3, 4]
        assert got["reload"]["step"] == 4
        for k, v in got["reload"]["params"].items():
            assert np.array_equal(v, first["reload"]["params"][k]), k
    assert first["ckpt_shapes"] == {k: v.shape
                                    for k, v in first["params"].items()}


@FIRST_WORLD
def test_cli_train_model_parallel_over_the_ranks(run):
    """``cli.train --model-parallel 2`` on the ranks of a launch: every
    rank returns 0 and rank 0 writes the run directory."""
    _, _, _, ranks = run
    assert [r["cli"]["rc"] for r in ranks] == [0] * len(ranks)
    assert {"config.json", "vocab.pkl", "ckpt.pt",
            "metrics.jsonl"} <= set(ranks[0]["cli"]["files"])


@FIRST_WORLD
def test_tp_paths_refuse_what_cannot_run(run):
    """``use_shard_map`` on a 2-D mesh (as the JAX package refuses it),
    kernels 3 and 6 forced on under a model axis, and a world that the
    model axis does not divide raise ``ValueError``."""
    _, _, _, ranks = run
    for r in ranks:
        e = r["errors"]
        assert "pjit" in e["shard_map"]
        assert "gates_kernel='on'" in e["gates_kernel"]
        assert "train_tail_kernel='on'" in e["train_tail_kernel"]
        assert "model_parallel=3" in e["indivisible"]


def test_ranks_import_no_jax_and_run_gloo(run):
    data, model, _, ranks = run
    assert [r["rank"] for r in ranks] == list(range(data * model))
    for r in ranks:
        assert r["backend"] == "gloo" and r["modules"] == []
        assert r["rank"] == r["data_rank"] * model + r["model_rank"]
