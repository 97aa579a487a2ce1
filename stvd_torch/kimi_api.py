"""Serving Kimi-VL-A3B's language model as a beam-search video captioner
over visual tokens resident on the device (``model/kimi_vl.py``).

    cfg = KimiServeConfig(model=KimiVLConfig(prompt_before=(...),
                                              prompt_after=(...)))
    cap = KimiCaptioner(params, cfg, vocab)        # published weight names
    cap.attach_bank(FeatureBank(ids, frames=tokens, frame_mask=mask))
    texts = cap.caption_ids(["vid1", "vid7"])

A bank's ``frames`` are each video's visual tokens as the vision tower's
projector gives them, (N, Nv, hidden); ``frame_mask`` (N, Nv) marks the
real ones.  ``KimiCaptioner`` is a ``BeamCaptioner``, as the LSTM's
``Captioner`` is: the same bank, id requests, prepared batches, n-best
lists, chunking, detokenising and CUDA graphs of the beam decode (the
prologue, here the prompt's prefill, as one graph and each step t as
one), through the shared beam loop with the model's ``KimiBeam``.  The
weights are kept in the compute dtype (bf16, as the model is published)
and laid out once for the decode (``kimi_vl.pack``); float32 masters
of a 16-billion-parameter model would not fit beside the bank.  When
every token of the attached bank is real, its decodes run the prefill's
attention as causal alone.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from .api import BeamCaptioner, _check_swap_compatible
from .data.text import Vocab
from .decode import graphs as decode_graphs
from .decode.beam import beam_decode
from .model import kernel, kimi_vl, moe
from .model.kimi_config import KimiServeConfig

__all__ = ["KimiCaptioner", "KimiServeConfig"]


class KimiCaptioner(BeamCaptioner):
    """Caption videos' visual tokens with Kimi-VL-A3B's language model on
    ``device`` by beam search.  ``params``: the published weights (names
    of ``kimi_vl.param_shapes``), or None with ``packed``, weights already
    laid out by ``kimi_vl.pack``.  ``logit_bias`` (V,) is added to the
    head's logits (the published head has no bias).  ``counter`` (an
    ``moe.ExpertCounter``) counts the expert routing of every decode."""

    def __init__(self, params, cfg: KimiServeConfig, vocab: Vocab, *,
                 device: torch.device | str = "cuda",
                 packed: Optional[dict] = None,
                 logit_bias: Optional[torch.Tensor] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("KimiCaptioner: no CUDA device; pass "
                               "device='cpu' to run on the CPU")
        self.cfg = cfg
        self.vocab = vocab
        m = cfg.model
        self.counter = moe.ExpertCounter(len(m.moe_layers),
                                         m.n_routed_experts, self.device)
        self._beams = {dense: kimi_vl.KimiBeam(dense, self.counter)
                       for dense in (False, True)}
        # the decode's step: the identity a graph set serves
        self.step_fn = self._beams[False]
        self.params = (packed if packed is not None else
                       kimi_vl.pack(params, m, self.device, logit_bias))
        self._bank_dense = False
        self._graphs: Optional[decode_graphs.DecodeGraphs] = None
        self._graphs_lock = threading.Lock()

    def _new_graphs(self, params) -> decode_graphs.DecodeGraphs:
        return decode_graphs.DecodeGraphs(
            params, self.step_fn, wrappers=(kernel.logit_tail,
                                            moe.expert_mm))

    def attach_bank(self, bank, dtype: Optional[torch.dtype] = None,
                    mesh=None) -> int:
        n = super().attach_bank(bank, dtype, mesh)
        self._bank_dense = bool(np.all(np.asarray(bank.frame_mask) > 0))
        return n

    def _bank_keys(self) -> List[str]:
        keys = ["frames", "frame_mask"]
        bad = [k for k in keys if k not in self._bank_dev]
        if bad:
            raise ValueError(f"bank lacks streams the model needs: {bad}")
        return keys

    def swap_params(self, params) -> None:
        """Swap in published weights of the same shapes; the head's bias
        is kept."""
        params = dict(params)
        _check_swap_compatible(
            {k: torch.empty(s, device="meta") for k, s in
             kimi_vl.param_shapes(self.cfg.model).items()}, params)
        self.params = kimi_vl.pack(params, self.cfg.model, self.device,
                                   self.params["logit_bias"])
        with self._graphs_lock:
            self._graphs = None

    def _decode(self, params, batch: Dict[str, torch.Tensor], dense: bool):
        d = self.cfg.decode
        if d.beam_size <= 1:
            raise ValueError("KimiCaptioner decodes by beam search "
                             "(beam_size > 1)")
        with torch.inference_mode(), self._graphs_for(params) as graphs:
            return beam_decode(params, self.cfg.model, batch,
                               beam_size=d.beam_size, maxlen=d.maxlen,
                               length_norm=d.length_norm,
                               step_fn=self.step_fn, graphs=graphs,
                               model=self._beams[dense])

    def _run(self, params, batch: Dict[str, torch.Tensor],
             dense: bool = False):
        out = self._decode(params, batch, dense)
        return out.tokens, out.norm_scores

    def _run_ids(self, params, bank: Dict[str, torch.Tensor],
                 rows: torch.Tensor):
        def run(p, batch):
            return self._run(p, batch, self._bank_dense)

        if self._bank_mesh is not None:
            return self._on_shards(run, params, bank, rows)
        with self._graphs_for(params) as graphs:
            if graphs is not None:
                return run(params, graphs.gather(bank, rows))
            return run(params, {k: v.index_select(0, rows)
                                for k, v in bank.items()})

    def _nbest_decode(self, params, batch: Dict[str, torch.Tensor],
                      norm: bool):
        out = self._decode(params, batch, False)
        return out.all_tokens, (out.all_norm_scores if norm
                                else out.all_scores)
