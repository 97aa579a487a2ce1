"""Training loss (counterpart of stvd/train/loss.py): masked NLL averaged
over the batch's examples, plus the optional attention-coverage term
``alpha_c``."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..model.decoder import StepFn, forward_train


def loss_terms(params, cfg, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               train: bool = True, ss_prob: float = 0.0,
               step_fn: Optional[StepFn] = None
               ) -> Dict[str, torch.Tensor]:
    """Unreduced loss terms (weighted sums): ``nll_num``, ``ex_den``,
    ``tok_den``, ``reg_num``.  Kept apart from the final ratios so
    microbatches can sum numerators and denominators before one divide.
    ``batch['weight']`` (B,), if present, weighs each example (0 for the
    batch iterator's wrapped padding).  ``step_fn`` is the step of the
    autograd scans (``forward_train``)."""
    out = forward_train(params, cfg, batch, generator=generator,
                        train=train, ss_prob=ss_prob, step_fn=step_fn)
    w = batch.get("weight")
    if w is None:
        w = torch.ones_like(out.nll_per_example)
    tmask = batch["token_mask"]
    terms = {"nll_num": (out.nll_per_example * w).sum(),
             "ex_den": w.sum(),
             "tok_den": (tmask * w[:, None]).sum(),
             "reg_num": torch.zeros((), device=w.device)}
    if cfg.alpha_c > 0.0:
        # coverage: total attention per frame close to T_valid / K_valid
        fmask = batch["frame_mask"]
        asum = (out.alphas * tmask[..., None]).sum(dim=1)        # (B, K)
        t_valid = tmask.sum(dim=1, keepdim=True)
        k_valid = fmask.sum(dim=1, keepdim=True).clamp_min(1.0)
        reg = (((t_valid / k_valid - asum) ** 2) * fmask).sum(dim=1)
        terms["reg_num"] = (reg * w).sum()
    return terms


def loss_from_terms(terms: Dict[str, torch.Tensor], cfg
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    denom = terms["ex_den"].clamp_min(1.0)
    nll = terms["nll_num"] / denom
    loss = nll
    if cfg.alpha_c > 0.0:
        loss = loss + cfg.alpha_c * terms["reg_num"] / denom
    aux = {"nll": nll,
           "nll_per_token": terms["nll_num"] / terms["tok_den"].clamp_min(1.0)}
    return loss, aux


def loss_fn(params, cfg, batch: Dict[str, torch.Tensor],
            generator: Optional[torch.Generator] = None, train: bool = True,
            ss_prob: float = 0.0, step_fn: Optional[StepFn] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Scalar loss and an aux dict (``nll``, ``nll_per_token``)."""
    terms = loss_terms(params, cfg, batch, generator=generator, train=train,
                       ss_prob=ss_prob, step_fn=step_fn)
    return loss_from_terms(terms, cfg)
