"""Import reference Theano checkpoints (.npz) into the port's
parameters (counterpart of stvd/model/importer.py, with the same name
map).

The reference saves ``numpy.savez(..., **unzip(tparams))``, so a user
migrating from it holds flat .npz files keyed by Theano parameter names.
This module maps those names and shapes onto the port's parameter dict
(the JAX package's names), so a reference-trained model can be decoded
and fine-tuned here.  The same file format carries a model between the
two packages: ``save_reference_npz`` of either package writes it and
``cli.convert --ref-model`` of either package makes a run directory of
it.

Structural conversions handled:

  * the attention-LSTM block is prefixed (``decoder_W`` -> ``W`` ...),
  * ``U_att (attn, 1)`` / ``W_sel (dim, 1)`` column vectors squeeze to
    vector params; ``c_tt`` / ``b_sel`` ``(1,)`` squeeze to scalars,
  * a reference ``ff_logit_ctx_b`` folds into ``ff_logit_lstm_b``
    (the logit activation sums both branches before the tanh),
  * gate order needs no permutation: both sides slice the 4d
    preactivation as (i, f, o, c).

Anything unmapped is reported, never silently dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from .decoder import init_params
from .step import Params

# stvd name -> candidate reference names, first present wins.  The
# decoder prefix varies across the lineage ('decoder', 'bo_lstm'); an
# unprefixed fallback is accepted last.
_ALIASES: Dict[str, List[str]] = {
    "Wemb": ["Wemb"],
    "ff_state_W": ["ff_state_W"],
    "ff_state_b": ["ff_state_b"],
    "ff_memory_W": ["ff_memory_W"],
    "ff_memory_b": ["ff_memory_b"],
    "W": ["decoder_W", "bo_lstm_W"],
    "U": ["decoder_U", "bo_lstm_U"],
    "b": ["decoder_b", "bo_lstm_b"],
    "Wc": ["decoder_Wc", "bo_lstm_Wc"],
    "Wc_att": ["decoder_Wc_att", "bo_lstm_Wc_att"],
    "b_att": ["decoder_b_att", "bo_lstm_b_att"],
    "Wd_att": ["decoder_Wd_att", "bo_lstm_Wd_att"],
    "U_att": ["decoder_U_att", "bo_lstm_U_att"],
    "c_att": ["decoder_c_tt", "decoder_c_att", "bo_lstm_c_tt"],
    "W_sel": ["decoder_W_sel", "bo_lstm_W_sel"],
    "b_sel": ["decoder_b_sel", "bo_lstm_b_sel"],
    # spatial attention (the tuyunbin addition; names doubly [RECON])
    "Ws_att": ["decoder_Wr_att", "decoder_Ws_att", "spatial_Wc_att"],
    "bs_att": ["decoder_br_att", "decoder_bs_att", "spatial_b_att"],
    "Wsd_att": ["decoder_Wrd_att", "decoder_Wsd_att", "spatial_Wd_att"],
    "Us_att": ["decoder_Ur_att", "decoder_Us_att", "spatial_U_att"],
    "cs_att": ["decoder_c_rtt", "decoder_cs_att", "spatial_c_tt"],
    "W_spat_fuse": ["decoder_W_spat", "spatial_W_fuse"],
    # frame-level LSTM encoder (reference encoder='lstm')
    "enc_W": ["encoder_W"],
    "enc_U": ["encoder_U"],
    "enc_b": ["encoder_b"],
    # logit stack
    "ff_logit_lstm_W": ["ff_logit_lstm_W"],
    "ff_logit_lstm_b": ["ff_logit_lstm_b"],
    "ff_logit_ctx_W": ["ff_logit_ctx_W"],
    "ff_logit_W": ["ff_logit_W"],
    "ff_logit_b": ["ff_logit_b"],
}

# reference keys that are intentionally consumed without a 1:1 target
_FOLDED = {"ff_logit_ctx_b"}


@dataclasses.dataclass
class ImportReport:
    mapped: List[str]          # stvd params loaded from the npz
    missing: List[str]         # stvd params kept at their init values
    unused: List[str]          # npz keys not consumed
    folded: List[str]          # npz keys folded into another param

    def __str__(self) -> str:
        return (f"mapped {len(self.mapped)} params"
                + (f"; missing (init kept): {sorted(self.missing)}"
                   if self.missing else "")
                + (f"; folded: {sorted(self.folded)}" if self.folded else "")
                + (f"; unused npz keys: {sorted(self.unused)}"
                   if self.unused else ""))


def _coerce(name: str, arr: np.ndarray, want: torch.Tensor) -> np.ndarray:
    """Squeeze the reference's trailing singleton columns / (1,)
    scalars onto the tensor's vector/scalar shapes; everything else must
    match exactly."""
    a = np.asarray(arr, dtype=np.float32)
    shape = tuple(want.shape)
    if a.shape == shape:
        return a
    if a.ndim == len(shape) + 1 and a.shape[-1] == 1 \
            and a.shape[:-1] == shape:
        return a[..., 0]
    if len(shape) == 0 and a.size == 1:
        return a.reshape(())
    raise ValueError(
        f"reference param for {name!r} has shape {a.shape}, "
        f"stvd expects {shape} — check the config (dim/ctx_dim/"
        f"n_words/attn_dim must match the reference run's options)")


def load_reference_npz(
    path: str,
    cfg: ModelConfig,
    params: Optional[Params] = None,
    generator: Optional[torch.Generator] = None,
    strict: bool = False,
) -> Tuple[Params, ImportReport]:
    """Load a reference ``model_best_so_far.npz`` onto a parameter dict
    of float32 CPU tensors.

    ``params`` (or a fresh ``init_params`` from ``generator``, seed 0 by
    default) supplies shapes and the fallback values for weights absent
    from the npz.  ``strict=True`` raises if any parameter has no
    counterpart (beyond additions the reference never had, e.g. the
    dual-stream fusion weights).
    """
    if params is None:
        params = init_params(cfg, generator if generator is not None
                             else torch.Generator().manual_seed(0), "cpu")
    params = {k: torch.as_tensor(v).detach().to("cpu", torch.float32)
              for k, v in params.items()}
    with np.load(path, allow_pickle=False) as z:
        ref = {k: np.asarray(z[k]) for k in z.files}

    out = dict(params)
    mapped: List[str] = []
    missing: List[str] = []
    folded: List[str] = []
    used = set()
    for name, want in params.items():
        src = next((a for a in _ALIASES.get(name, []) if a in ref), None)
        if src is None:
            missing.append(name)
            continue
        out[name] = torch.from_numpy(_coerce(name, ref[src], want).copy())
        used.add(src)
        mapped.append(name)
    # fold ff_logit_ctx_b (if the reference run had one) into the single
    # pre-tanh bias — tanh(Wh·h + b_h + Wc·c + b_c) == our
    # tanh(Wh·h + (b_h + b_c) + Wc·c)
    if "ff_logit_ctx_b" in ref and "ff_logit_lstm_b" in out:
        b = _coerce("ff_logit_ctx_b", ref["ff_logit_ctx_b"],
                    out["ff_logit_lstm_b"])
        out["ff_logit_lstm_b"] = out["ff_logit_lstm_b"] + torch.from_numpy(b)
        used.add("ff_logit_ctx_b")
        folded.append("ff_logit_ctx_b")

    unused = [k for k in ref if k not in used]
    report = ImportReport(mapped, missing, unused, folded)
    if strict:
        stvd_only = {"W_app", "W_mot", "b_fuse"}   # no reference analog
        hard_missing = [m for m in missing if m not in stvd_only]
        if hard_missing:
            raise ValueError(f"strict import: no reference weights for "
                             f"{sorted(hard_missing)} ({report})")
    return out, report


def _first(ref_keys, name: str) -> Optional[str]:
    return next((a for a in _ALIASES[name] if a in ref_keys), None)


def infer_model_config(path: str, base: Optional[ModelConfig] = None
                       ) -> ModelConfig:
    """Derive the ModelConfig a reference npz was trained with from its
    weight shapes (Wemb -> n_words/dim_word, U -> dim, Wc_att ->
    ctx_dim/attn_dim, spatial/encoder blocks -> flags).  ``base``
    supplies every knob shapes can't determine (dropout, dtypes...)."""
    base = base or ModelConfig()
    with np.load(path, allow_pickle=False) as z:
        shapes = {k: z[k].shape for k in z.files}
    need = {}
    for name in ("Wemb", "U", "Wc_att"):
        src = _first(shapes, name)
        if src is None:
            raise ValueError(f"npz lacks any alias of {name!r}: "
                             f"not a reference checkpoint? keys="
                             f"{sorted(shapes)[:8]}...")
        need[name] = shapes[src]
    # attn_dim is ctx_dim by construction (ModelConfig property, the
    # reference's Wc_att is (ctx_dim, ctx_dim)) — verify, don't set
    if need["Wc_att"][1] != need["Wc_att"][0]:
        raise ValueError(
            f"reference Wc_att is {need['Wc_att']}; stvd ties the "
            f"attention width to ctx_dim (SURVEY.md §2 inventory)")
    kw = dict(
        n_words=need["Wemb"][0], dim_word=need["Wemb"][1],
        dim=need["U"][0], ctx_dim=need["Wc_att"][0],
        encoder="lstm" if _first(shapes, "enc_W") else "none",
        use_motion=False,
    )
    spat = _first(shapes, "Ws_att")
    kw["use_spatial"] = spat is not None
    if spat is not None:
        kw["region_dim"] = shapes[spat][0]
    return dataclasses.replace(base, **kw)


def save_reference_npz(path: str, params: Params) -> None:
    """Export parameters (tensors or arrays) under reference names: the
    file the JAX package's importer also reads.  Vector/scalar params
    regain the reference's trailing-singleton shapes."""
    inv: Dict[str, np.ndarray] = {}
    for name, arr in params.items():
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().to("cpu", torch.float32).numpy()
        a = np.asarray(arr, np.float32)
        cands = _ALIASES.get(name)
        if not cands:
            continue
        ref_name = cands[0]
        if name in ("U_att", "W_sel", "Us_att"):
            a = a[:, None]
        elif name in ("c_att", "b_sel", "cs_att") and a.ndim == 0:
            a = a.reshape(1)
        inv[ref_name] = a
    np.savez(path, **inv)
