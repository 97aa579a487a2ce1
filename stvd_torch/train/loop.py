"""The training loop (counterpart of stvd/train/loop.py): optimizers, the
train step, validation by NLL and caption metrics, model selection,
checkpointing and early stopping, on one device.

The optimizers follow the JAX package's ``make_optimizer``, which uses
optax: each is a pair of functions ``init(params) -> state`` and
``update(grads, state) -> (updates, state)`` over dicts of tensors, with
optax's operation order, and ``apply_updates`` adds the updates to the
float32 master parameters in place.  Global-norm clipping is optax's
``clip_by_global_norm`` (scale by ``clip / norm`` once the norm reaches
``clip``, no epsilon), not ``torch.nn.utils.clip_grad_norm_``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import parse_buckets
from ..data.bank import to_device
from ..data.batching import (BatchIterator, BucketedBatchIterator, Dataset,
                             gather_batch)
from ..decode.greedy import greedy_decode
from ..model.decoder import init_params
from ..model.kernel import get_step_fn
from ..model.step import Params, compute_dtype
from .evaluate import evaluate_split
from .loss import loss_from_terms, loss_terms

TrainState = Dict[str, Any]  # {"params", "opt_state", "step", "generator"}
Tensors = Dict[str, torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any], Tuple[Tensors, Any]]


def _zeros(params: Tensors, dtype=torch.float32) -> Tensors:
    return {k: torch.zeros(p.shape, dtype=dtype, device=p.device)
            for k, p in params.items()}


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax's order: leaves
    in sorted key order)."""
    return torch.sqrt(sum((tensors[k].float() ** 2).sum()
                          for k in sorted(tensors)))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax.clip_by_global_norm: ``t / g_norm * max_norm`` when
    ``g_norm >= max_norm``; chosen on the device, so no host sync."""

    def update(grads, state):
        g_norm = global_norm(grads)
        keep = g_norm < max_norm
        return ({k: torch.where(keep, g, (g / g_norm) * max_norm)
                 for k, g in grads.items()}, state)

    return GradientTransformation(lambda params: (), update)


def adadelta(lr: float, rho: float = 0.9, eps: float = 1e-6,
             slot_dtype: torch.dtype = torch.float32
             ) -> GradientTransformation:
    """optax.adadelta's math (scale_by_adadelta then -lr), with the two
    slots stored in ``slot_dtype``; the update math is float32 (slots are
    cast in and rounded out), so float32 slots are optax exactly."""

    def init(params):
        return (_zeros(params, slot_dtype), _zeros(params, slot_dtype))

    def update(grads, state):
        e_g, e_x = state
        ups, ng, nx = {}, {}, {}
        for k, g in grads.items():
            g = g.float()
            a = (1 - rho) * (g * g) + rho * e_g[k].float()
            u = (torch.sqrt(e_x[k].float() + eps) / torch.sqrt(a + eps)) * g
            d = (1 - rho) * (u * u) + rho * e_x[k].float()
            ups[k] = u * (-lr)
            ng[k], nx[k] = a.to(slot_dtype), d.to(slot_dtype)
        return ups, (ng, nx)

    return GradientTransformation(init, update)


def graves_rmsprop(step_size: float = 1e-4, momentum: float = 0.9,
                   decay: float = 0.95, eps: float = 1e-4,
                   slot_dtype: torch.dtype = torch.float32
                   ) -> GradientTransformation:
    """The reference's centred RMSProp with heavy-ball momentum (the JAX
    package's ``graves_rmsprop``): the step size is fixed at 1e-4 and the
    configured lr is not read, as in the reference."""

    def init(params):
        return tuple(_zeros(params, slot_dtype) for _ in range(3))

    def update(grads, state):
        rg, rg2, ud = state
        ups, n1, n2, n3 = {}, {}, {}, {}
        for k, g in grads.items():
            g = g.float()
            a = decay * rg[k].float() + (1 - decay) * g
            a2 = decay * rg2[k].float() + (1 - decay) * (g * g)
            u = (momentum * ud[k].float()
                 - (step_size * g) / torch.sqrt(a2 - a * a + eps))
            ups[k] = u
            n1[k], n2[k], n3[k] = (a.to(slot_dtype), a2.to(slot_dtype),
                                   u.to(slot_dtype))
        return ups, (n1, n2, n3)

    return GradientTransformation(init, update)


def sgd(lr: float) -> GradientTransformation:
    """optax.sgd without momentum: ``-lr * g``."""
    return GradientTransformation(
        lambda params: (),
        lambda grads, state: ({k: g * (-lr) for k, g in grads.items()},
                              state))


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> GradientTransformation:
    """optax.adam: bias-corrected moments, ``m / (sqrt(v) + eps) * -lr``."""

    def init(params):
        return (0, _zeros(params), _zeros(params))

    def update(grads, state):
        count, mu, nu = state
        count += 1
        f32 = torch.float32
        bc1 = 1 - torch.tensor(b1, dtype=f32) ** count
        bc2 = 1 - torch.tensor(b2, dtype=f32) ** count
        ups, nm, nv = {}, {}, {}
        for k, g in grads.items():
            g = g.float()
            nm[k] = (1 - b1) * g + b1 * mu[k]
            nv[k] = (1 - b2) * (g * g) + b2 * nu[k]
            m_hat = nm[k] / bc1.to(g.device)
            v_hat = nv[k] / bc2.to(g.device)
            ups[k] = (m_hat / (torch.sqrt(v_hat) + eps)) * (-lr)
        return ups, (count, nm, nv)

    return GradientTransformation(init, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state):
        new = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s)
            new.append(s)
        return grads, tuple(new)

    return GradientTransformation(init, update)


def make_optimizer(tcfg) -> GradientTransformation:
    """The JAX package's optimizers, chained after global-norm clipping
    when ``clip_c > 0``."""
    slot = (torch.bfloat16 if tcfg.opt_slot_dtype == "bfloat16"
            else torch.float32)
    if tcfg.optimizer == "adadelta":
        opt = adadelta(tcfg.lr, slot_dtype=slot)
    elif tcfg.optimizer == "rmsprop":
        opt = graves_rmsprop(slot_dtype=slot)   # ignores tcfg.lr
    elif tcfg.optimizer == "sgd":
        opt = sgd(tcfg.lr)
    elif tcfg.optimizer == "adam":
        opt = adam(tcfg.lr)
    else:
        raise ValueError(f"unknown optimizer {tcfg.optimizer!r}")
    if tcfg.clip_c > 0:
        return chain(clip_by_global_norm(tcfg.clip_c), opt)
    return opt


@torch.no_grad()
def apply_updates(params: Params, updates: Tensors) -> None:
    """p += u in place (optax.apply_updates on the float32 masters)."""
    for k, p in params.items():
        p.add_(updates[k].to(p.dtype))


def init_train_state(seed: int, mcfg, tcfg,
                     device: torch.device | str = "cuda") -> TrainState:
    """Random parameters from ``seed``, fresh optimizer slots, step 0 and
    the dropout generator (seeded from ``seed + 1``), all on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    params = init_params(mcfg, g, device)
    for p in params.values():
        p.requires_grad_(True)
    return {"params": params,
            "opt_state": make_optimizer(tcfg).init(params), "step": 0,
            "generator": torch.Generator(device=device).manual_seed(seed + 1)}


def _grads(obj: torch.Tensor, params: Params) -> Tensors:
    keys = list(params)
    gs = torch.autograd.grad(obj, [params[k] for k in keys],
                             allow_unused=True)
    return {k: (torch.zeros_like(params[k]) if g is None else g)
            for k, g in zip(keys, gs)}


def make_train_step(mcfg, tcfg
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``train_step(state, batch) -> (state, metrics)``: loss and
    gradients through the hand-derived sequence VJP, one optimizer
    update.  With ``grad_accum > 1`` the batch runs as that many
    microbatches, summing the gradients of the summed objective and the
    loss terms before one weighted-mean divide (the full-batch gradient,
    with one microbatch's activations alive at a time).  Metrics stay on
    the device: loss, nll, nll_per_token, grad_norm (before clipping)."""
    opt = make_optimizer(tcfg)
    n_acc = tcfg.grad_accum

    def objective(params, batch, gen):
        t = loss_terms(params, mcfg, batch, generator=gen, train=True,
                       ss_prob=tcfg.ss_prob)
        return t["nll_num"] + mcfg.alpha_c * t["reg_num"], t

    def train_step(state: TrainState, batch):
        params = state["params"]
        for p in params.values():
            p.requires_grad_(True)
        gen = state["generator"]
        if n_acc > 1:
            mbs = batch["tokens"].shape[0] // n_acc
            grads = terms = None
            for i in range(n_acc):
                mb = {k: v[i * mbs:(i + 1) * mbs] for k, v in batch.items()}
                obj, t = objective(params, mb, gen)
                g = _grads(obj, params)
                t = {k: v.detach() for k, v in t.items()}
                if grads is None:
                    grads, terms = g, t
                else:
                    grads = {k: grads[k] + g[k] for k in grads}
                    terms = {k: terms[k] + t[k] for k in terms}
            den = terms["ex_den"].clamp_min(1.0)
            grads = {k: g / den for k, g in grads.items()}
            loss, aux = loss_from_terms(terms, mcfg)
        else:
            t = loss_terms(params, mcfg, batch, generator=gen, train=True,
                           ss_prob=tcfg.ss_prob)
            loss, aux = loss_from_terms(t, mcfg)
            grads = _grads(loss, params)
        gnorm = global_norm(grads)
        updates, opt_state = opt.update(grads, state["opt_state"])
        apply_updates(params, updates)
        new_state = {"params": params, "opt_state": opt_state,
                     "step": state["step"] + 1, "generator": gen}
        metrics = {"loss": loss.detach(), "nll": aux["nll"].detach(),
                   "nll_per_token": aux["nll_per_token"].detach(),
                   "grad_norm": gnorm}
        return new_state, metrics

    return train_step


@torch.no_grad()
def evaluate_nll_stats(params: Params, mcfg, ds: Dataset, batch_size: int,
                       device: torch.device | str = "cuda"
                       ) -> Tuple[float, float, float]:
    """(NLL numerator, example count, token count) over a split, without
    dropout, in fixed-shape batches (the wrapped tail weighs 0)."""
    dev = to_device(ds.bank, device, compute_dtype(mcfg))
    it = BatchIterator(ds.captions.n, min(batch_size, ds.captions.n),
                       shuffle=False)
    num = ex = tok = 0.0
    for idx, w in it.epoch():
        batch = gather_batch(dev, ds.captions, idx)
        batch["weight"] = torch.from_numpy(w).to(device)
        t = loss_terms(params, mcfg, batch, train=False)
        num += float(t["nll_num"])
        ex += float(t["ex_den"])
        tok += float(t["tok_den"])
    return num, ex, tok


def evaluate_nll(params: Params, mcfg, ds: Dataset, batch_size: int,
                 device: torch.device | str = "cuda") -> float:
    """Mean per-example NLL over a split."""
    num, ex, _ = evaluate_nll_stats(params, mcfg, ds, batch_size, device)
    return num / max(ex, 1.0)


# ---------------------------------------------------------------------------
# Checkpoints: params, optimizer slots, step and the dropout generator
# ---------------------------------------------------------------------------

def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def save_checkpoint(path: str, state: TrainState, fit_state: Dict) -> None:
    """One file (written then renamed) that ``fit`` resumes from, with the
    early-stop bookkeeping ``fit_state``; it holds only tensors and plain
    values, so it loads with ``weights_only=True``."""
    blob = {"params": _to(state["params"], "cpu"),
            "opt_state": _to(state["opt_state"], "cpu"),
            "step": int(state["step"]),
            "generator": state["generator"].get_state(),
            "fit": fit_state}
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, state: TrainState,
                       device: torch.device | str) -> Tuple[TrainState, Dict]:
    """Load ``save_checkpoint``'s file into ``state`` (parameters in
    place); returns the state and the saved ``fit_state``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    with torch.no_grad():
        for k, p in state["params"].items():
            p.copy_(blob["params"][k])
    state["opt_state"] = _to(blob["opt_state"], device)
    state["step"] = blob["step"]
    state["generator"].set_state(blob["generator"])
    return state, blob["fit"]


@dataclasses.dataclass
class FitResult:
    best_metric: float
    best_step: int
    history: list
    state: TrainState
    bad_rounds: int = 0
    log: List[Dict] = dataclasses.field(default_factory=list)


def _emit(save_dir: str, record: Dict, logger=None) -> Dict:
    """One record through ``logger`` (a ``MetricsLogger``), or without
    one as a JSON line on stdout and in ``save_dir/metrics.jsonl``."""
    if logger is not None:
        logger.log(record["kind"],
                   **{k: v for k, v in record.items() if k != "kind"})
        return record
    print(json.dumps(record), flush=True)
    with open(os.path.join(save_dir, "metrics.jsonl"), "a") as f:
        f.write(json.dumps(record) + "\n")
    return record


def _metric_key(name: str) -> str:
    # 'blue' is the reference's (misspelled) early-stop metric option
    return {"meteor": "METEOR", "bleu4": "Bleu_4", "blue": "Bleu_4",
            "cider": "CIDEr", "rouge": "ROUGE_L", "nll": "nll"}[name]


def perplexity(nll_per_token: float) -> float:
    """Token-level perplexity (the reference prints it next to NLL)."""
    return math.exp(min(nll_per_token, 50.0))


def _validate(params: Params, cfg, ds: Dataset, step_fn, update: int,
              split: str, device, logger=None) -> Dict[str, float]:
    """NLL and the caption metrics of a split, as one record of kind
    ``split``; the samples files go to ``save_dir``."""
    nll = evaluate_nll(params, cfg.model, ds, cfg.train.valid_batch_size,
                       device)
    scores = evaluate_split(params, cfg, ds, split=split,
                            save_dir=cfg.train.save_dir, step_fn=step_fn,
                            device=device)
    scores["nll"] = nll
    _emit(cfg.train.save_dir, {"kind": split, "update": update, **scores},
          logger)
    return scores


def _print_samples(params: Params, cfg, ds: Dataset, dev_bank, step_fn,
                   update: int, logger=None, n: int = 2) -> None:
    """Greedy captions of the split's first ``n`` videos beside their
    first reference, one ``sample`` record each."""
    rows = torch.arange(min(n, ds.bank.n_videos),
                        device=dev_bank["frames"].device)
    batch = {k: v.index_select(0, rows) for k, v in dev_bank.items()}
    with torch.no_grad():
        toks = greedy_decode(params, cfg.model, batch,
                             maxlen=cfg.decode.maxlen,
                             step_fn=step_fn).tokens.cpu().numpy()
    for i in range(len(rows)):
        refs = ds.references[i]
        _emit(cfg.train.save_dir, {
            "kind": "sample", "update": update, "video": ds.bank.ids[i],
            "pred": " ".join(ds.vocab.decode(toks[i])),
            "gold": " ".join(refs[0]) if refs else ""}, logger)


def fit(cfg, train_ds: Dataset, valid_ds: Optional[Dataset] = None,
        step_fn=None, *, logger=None, max_updates: Optional[int] = None,
        test_ds: Optional[Dataset] = None,
        device: torch.device | str = "cuda") -> FitResult:
    """Train until ``max_epochs``, ``max_updates`` or early stopping on
    the validation metric (``train.metric``: METEOR, BLEU-4, CIDEr and
    ROUGE-L from decoded captions, bigger is better; or NLL), as the JAX
    package's ``fit`` does.  The positional parameters are the JAX
    package's: ``step_fn`` is the decode step of validation and samples
    (``None``: ``get_step_fn(None, device)``, the kernel step on a CUDA
    device); training takes its kernels from the model config.

    Every ``disp_freq`` updates a ``train`` record (loss, grad norm,
    seconds since the last record), every ``sample_freq`` two greedy
    ``sample`` records of the training split, and every ``valid_freq``
    a ``valid`` record (NLL and every caption metric) and, with
    ``test_ds``, a ``test`` record; the model is selected on valid only.
    Records go through ``logger`` (a ``utils.logging.MetricsLogger``,
    which the caller closes) or, without one, to stdout and
    ``save_dir/metrics.jsonl``.  A better
    metric writes ``ckpt_best.pt`` and a ``best`` record; ``patience``
    rounds without one end the run with an ``early_stop`` record.
    ``length_buckets`` batches captions by length (``maxlen`` added as
    the last bucket).  ``ckpt.pt`` is written every ``save_freq``
    updates and at the end; ``reload_`` resumes from it, keeping the
    early-stop state only if it was saved under the same metric.  An
    interrupt (``KeyboardInterrupt``) ends the run with an ``interrupt``
    record and the same final ``ckpt.pt``."""
    tcfg, mcfg = cfg.train, cfg.model
    if tcfg.debug_nans:
        raise NotImplementedError("debug_nans is not ported yet")
    if step_fn is None:
        step_fn = get_step_fn(None, device)
    os.makedirs(tcfg.save_dir, exist_ok=True)
    state = init_train_state(tcfg.seed, mcfg, tcfg, device)
    metric_name = tcfg.metric
    key = _metric_key(metric_name)
    bigger_is_better = metric_name != "nll"
    fs = {"best": None, "best_step": 0, "bad_rounds": 0, "history": [],
          "metric": metric_name}
    ckpt = os.path.join(tcfg.save_dir, "ckpt.pt")
    best_ckpt = os.path.join(tcfg.save_dir, "ckpt_best.pt")
    reload = tcfg.reload_ and os.path.exists(ckpt)
    if reload:
        state, saved = restore_checkpoint(ckpt, state, device)
        # a best of another metric is no yardstick: keep the weights only
        if saved.get("metric") == metric_name:
            fs = saved
    best = fs["best"] if fs["best"] is not None else (
        -math.inf if bigger_is_better else math.inf)
    if reload:
        _emit(tcfg.save_dir, {"kind": "reload", "step": state["step"],
                              "best": float(best),
                              "bad_rounds": fs["bad_rounds"]}, logger)
    train_step = make_train_step(mcfg, tcfg)
    dev = to_device(train_ds.bank, device, compute_dtype(mcfg))
    if tcfg.length_buckets:
        buckets = parse_buckets(tcfg.length_buckets)
        if max(buckets) < tcfg.maxlen:
            buckets = buckets + (tcfg.maxlen,)
        lens = train_ds.captions.mask.sum(axis=1).astype(np.int64)
        it = BucketedBatchIterator(lens, tcfg.batch_size, buckets,
                                   seed=tcfg.seed)
    else:
        it = BatchIterator(train_ds.captions.n, tcfg.batch_size,
                           seed=tcfg.seed)
    update = state["step"]
    log: List[Dict] = []
    stop = update >= (max_updates if max_updates is not None else math.inf)
    t_last = time.perf_counter()
    try:
        for epoch in range(tcfg.max_epochs):
            if stop:
                break
            for item in it.epoch():
                # a bucketed batch also gives its bucket's length
                idx, w = item[0], item[1]
                t_b = item[2] if len(item) == 3 else 0
                batch = gather_batch(dev, train_ds.captions, idx,
                                     seq_len=t_b)
                batch["weight"] = torch.from_numpy(w).to(device)
                state, m = train_step(state, batch)
                update += 1
                if update % tcfg.disp_freq == 0:
                    rec = {"kind": "train", "epoch": epoch,
                           "update": update, "loss": float(m["loss"]),
                           "grad_norm": float(m["grad_norm"])}
                    now = time.perf_counter()
                    rec["seconds"] = now - t_last
                    t_last = now
                    log.append(_emit(tcfg.save_dir, rec, logger))
                if tcfg.sample_freq > 0 and update % tcfg.sample_freq == 0:
                    _print_samples(state["params"], cfg, train_ds, dev,
                                   step_fn, update, logger)
                if (tcfg.valid_freq > 0 and update % tcfg.valid_freq == 0
                        and valid_ds is not None):
                    scores = _validate(state["params"], cfg, valid_ds,
                                       step_fn, update, "valid", device,
                                       logger)
                    if test_ds is not None:
                        _validate(state["params"], cfg, test_ds, step_fn,
                                  update, "test", device, logger)
                    val = scores[key]
                    fs["history"].append({"update": update, **scores})
                    if (val > best) if bigger_is_better else (val < best):
                        best = val
                        fs.update(best=val, best_step=update, bad_rounds=0)
                        save_checkpoint(best_ckpt, state, fs)
                        _emit(tcfg.save_dir, {"kind": "best",
                                              "update": update,
                                              "metric": metric_name,
                                              "value": val}, logger)
                    else:
                        fs["bad_rounds"] += 1
                        if fs["bad_rounds"] >= tcfg.patience:
                            _emit(tcfg.save_dir, {
                                "kind": "early_stop", "update": update,
                                "bad_rounds": fs["bad_rounds"]}, logger)
                            stop = True
                            break
                if tcfg.save_freq > 0 and update % tcfg.save_freq == 0:
                    save_checkpoint(ckpt, state, fs)
                if max_updates is not None and update >= max_updates:
                    stop = True
                    break
    except KeyboardInterrupt:
        # keep the progress: the checkpoint below holds the last update
        _emit(tcfg.save_dir, {"kind": "interrupt", "update": update},
              logger)
    save_checkpoint(ckpt, state, fs)
    return FitResult(best_metric=float(best), best_step=fs["best_step"],
                     history=fs["history"], state=state,
                     bad_rounds=fs["bad_rounds"], log=log)
