"""Configuration of the Kimi-VL-A3B language model as a video captioner.

``KimiVLConfig`` holds the published settings of the language model
(moonshotai/Kimi-VL-A3B-Instruct's ``config.json``, text part; the
DeepSeek-V3 design: latent attention, sigmoid-routed experts with a
selection bias, shared experts, leading dense layers) under their
published names, and the serving settings the port adds: the compute
dtype and the prompt ids around a video's visual tokens.  The JAX
package has no such model, so this lives beside ``config.py`` (which
copies the JAX package's config field for field), not in it.

``KimiServeConfig`` pairs it with the beam decode's ``DecodeConfig``, in
the shape ``Captioner`` reads (``cfg.model``, ``cfg.decode``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..config import DecodeConfig


@dataclasses.dataclass(frozen=True)
class KimiVLConfig:
    """The language model's shape (published keys and defaults of
    Kimi-VL-A3B-Instruct) and the captioner's prompt."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264          # the dense layers' SwiGLU
    moe_intermediate_size: int = 1408       # one expert's SwiGLU
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    n_shared_experts: int = 2               # one SwiGLU of 2 x 1408
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.446
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    norm_topk_prob: bool = True
    scoring_func: str = "sigmoid"
    topk_method: str = "noaux_tc"
    n_group: int = 1
    topk_group: int = 1
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    rope_scaling: Optional[dict] = None
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    hidden_act: str = "silu"
    max_position_embeddings: int = 131072
    # the port's serving settings
    compute_dtype: str = "bfloat16"
    prompt_before: Tuple[int, ...] = ()     # ids before the visual tokens
    prompt_after: Tuple[int, ...] = ()      # ids after them

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Width of a cached position: the latent and the shared RoPE key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    def is_moe(self, layer: int) -> bool:
        return (layer >= self.first_k_dense_replace
                and layer % self.moe_layer_freq == 0)

    @property
    def moe_layers(self) -> Tuple[int, ...]:
        return tuple(i for i in range(self.num_hidden_layers)
                     if self.is_moe(i))

    @staticmethod
    def from_dict(d: dict) -> "KimiVLConfig":
        """The fields of ``d`` this config has (a published ``config.json``
        holds more keys, which are left out); prompt ids as tuples."""
        names = {f.name for f in dataclasses.fields(KimiVLConfig)}
        kw = {k: v for k, v in d.items() if k in names}
        for k in ("prompt_before", "prompt_after"):
            if k in kw:
                kw[k] = tuple(int(i) for i in kw[k])
        return validate(KimiVLConfig(**kw))


def validate(cfg: KimiVLConfig) -> KimiVLConfig:
    """Refuse settings the port does not implement (a query LoRA, RoPE
    scaling, grouped routing, other scores or activations)."""
    bad = []
    if cfg.q_lora_rank is not None:
        bad.append("q_lora_rank")
    if cfg.rope_scaling is not None:
        bad.append("rope_scaling")
    if cfg.scoring_func != "sigmoid" or cfg.topk_method != "noaux_tc":
        bad.append("scoring_func/topk_method")
    if cfg.n_group != 1 or cfg.topk_group != 1:
        bad.append("n_group/topk_group")
    if cfg.hidden_act != "silu" or cfg.attention_bias:
        bad.append("hidden_act/attention_bias")
    if cfg.tie_word_embeddings:
        bad.append("tie_word_embeddings")
    if cfg.num_key_value_heads != cfg.num_attention_heads:
        bad.append("num_key_value_heads")
    if bad:
        raise ValueError(f"KimiVLConfig: not implemented: {bad}")
    return cfg


@dataclasses.dataclass(frozen=True)
class KimiServeConfig:
    """The model and its beam decode, as ``Captioner`` reads a config."""

    model: KimiVLConfig = KimiVLConfig()
    decode: DecodeConfig = DecodeConfig(beam_size=5, maxlen=30,
                                        length_norm=0.6, decode_batch=16)
