"""Configuration of the port: its own copy of the JAX package's config.

The dataclasses, field names and defaults are those of ``stvd/config.py``
so a config written by either package (``Config.to_json``) loads in the
other, and ``preset(name)`` gives the same five reference-scale configs.
The port reads these fields and ignores those that only the JAX package
acts on (meshes, AOT export, TPU-era kernel knobs it has no path for).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

# METEOR parameter profiles that ``TrainConfig.meteor_profile`` may name
METEOR_PROFILES = ("meteor2005", "meteor15-en")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (reference option keys)."""

    n_words: int = 13010            # vocab size
    dim_word: int = 468             # word-embedding dim
    dim: int = 512                  # LSTM hidden dim
    ctx_dim: int = 1024             # frame-feature dim
    n_frames: int = 28              # K: frames per video after subsampling
    use_spatial: bool = False       # region-level spatial attention
    n_regions: int = 49             # R: regions per frame
    region_dim: int = 1024          # Dr: region-feature dim
    use_motion: bool = False        # second (motion) feature stream
    motion_dim: int = 2048
    encoder: str = "none"           # 'none' | 'lstm' (frame-level LSTM)
    selector: bool = True           # gating scalar beta on the context
    use_dropout: bool = True        # dropout before the logit projection
    dropout_rate: float = 0.5
    prev_word_logit: bool = True    # add the previous word's embedding
    alpha_c: float = 0.0            # attention-coverage regularizer weight
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"  # matmul operand dtype (f32 sums)
    scan_unroll: int = 1            # JAX scan unroll (no effect here)
    decode_quant: str = "none"      # 'none' | 'int8': W8A8 decode gates
    fused_seq_grad: bool = True     # hand-derived sequence VJP in training
    wgrad_dtype: str = "float32"    # JAX-only scan-accumulator knob
    spatial_wgrad_dtype: str = "bfloat16"  # dtype of the spatial VJP's
    # pregion-cotangent accumulator (float32 whenever compute is float32)
    spatial_bwd_kernel: str = "auto"  # spatial backward-step and dWs_att
    # GEMM kernels of the spatial VJP: 'auto'/'on' = the kernels for CUDA
    # tensors
    train_fwd_kernel: str = "off"   # attention-core kernel in the train
    # forward scan: 'auto'/'on' = the kernel for CUDA tensors
    train_tail_kernel: str = "off"  # train-scan tail kernel (Wc product
    # + LSTM pointwise): 'auto'/'on' = the kernel for CUDA tensors
    gates_kernel: str = "off"       # fused gates+LSTM decode kernel
    beam_gather: str = "flat"       # JAX beam-reorder lowering
    beam_buf: str = "reorder"       # JAX beam token bookkeeping
    remat: bool = False             # JAX scan rematerialization

    @property
    def attn_dim(self) -> int:
        """Width of the temporal-attention MLP (== ctx_dim)."""
        return self.ctx_dim


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop hyperparameters (reference option keys)."""

    batch_size: int = 64
    valid_batch_size: int = 200
    maxlen: int = 30                # max caption length incl. EOS
    optimizer: str = "adadelta"     # adadelta | rmsprop | sgd | adam
    lr: float = 1.0
    clip_c: float = 10.0            # global-norm gradient clip
    patience: int = 20              # early-stop patience (rounds)
    max_epochs: int = 500
    disp_freq: int = 10
    sample_freq: int = 200
    valid_freq: int = 2000
    save_freq: int = 2000
    metric: str = "meteor"          # meteor|bleu4|cider|rouge|nll
    length_buckets: str = ""        # e.g. "10,20,30"
    opt_slot_dtype: str = "float32"  # adadelta/rmsprop slot storage dtype
    meteor_profile: str = "meteor2005"
    grad_accum: int = 1             # microbatches per optimizer step
    ss_prob: float = 0.0            # scheduled-sampling probability
    seed: int = 1234
    reload_: bool = False           # resume from save_dir's checkpoint
    save_dir: str = "runs/default"
    tensorboard: bool = False
    profile_dir: str = ""
    profile_start: int = 5
    profile_steps: int = 5
    data_parallel: bool = False
    use_shard_map: bool = False
    per_device_batch: int = 0
    model_parallel: int = 1
    donate_state: bool = True
    debug_nans: bool = False


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Decoding hyperparameters."""

    beam_size: int = 5              # 1 == greedy
    maxlen: int = 30
    length_norm: float = 0.6        # GNMT length-norm alpha (0 = off)
    decode_batch: int = 64


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset paths and shapes."""

    dataset: str = "synthetic"      # synthetic | youtube2text | msrvtt
    data_dir: str = "data"
    feature_file: Optional[str] = None
    region_feature_file: Optional[str] = None
    motion_feature_file: Optional[str] = None
    vocab_file: Optional[str] = None
    captions_file: Optional[str] = None
    synthetic_videos: int = 64
    synthetic_captions_per_video: int = 2


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    decode: DecodeConfig = dataclasses.field(default_factory=DecodeConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "Config":
        d = json.loads(s)
        return Config(
            model=ModelConfig(**d.get("model", {})),
            train=TrainConfig(**d.get("train", {})),
            decode=DecodeConfig(**d.get("decode", {})),
            data=DataConfig(**d.get("data", {})),
        )


def _one_of(value, name: str, allowed) -> None:
    if value not in allowed:
        raise ValueError(f"unknown {name} {value!r}")


def validate(cfg: Config) -> Config:
    """The JAX package's sanity checks of a config."""
    m, t = cfg.model, cfg.train
    if m.n_words < 4:
        raise ValueError("n_words must be >= 4 (eos/unk/bos + >=1 real word)")
    if m.use_spatial and m.n_regions < 1:
        raise ValueError("use_spatial requires n_regions >= 1")
    if cfg.decode.beam_size < 1:
        raise ValueError("beam_size must be >= 1")
    _one_of(t.optimizer, "optimizer", ("adadelta", "rmsprop", "sgd", "adam"))
    _one_of(t.opt_slot_dtype, "opt_slot_dtype", ("float32", "bfloat16"))
    if t.opt_slot_dtype == "bfloat16" and t.optimizer != "adadelta":
        raise ValueError("opt_slot_dtype=bfloat16 is implemented for "
                         "the adadelta optimizer only")
    _one_of(m.encoder, "encoder", ("none", "lstm"))
    _one_of(m.decode_quant, "decode_quant", ("none", "int8"))
    if t.meteor_profile not in METEOR_PROFILES:
        raise ValueError(f"unknown meteor_profile {t.meteor_profile!r}; "
                         f"available: {sorted(METEOR_PROFILES)}")
    for name in ("wgrad_dtype", "spatial_wgrad_dtype"):
        _one_of(getattr(m, name), name, ("float32", "bfloat16"))
    for name in ("spatial_bwd_kernel", "train_fwd_kernel", "gates_kernel",
                 "train_tail_kernel"):
        _one_of(getattr(m, name), name, ("auto", "on", "off"))
    _one_of(m.beam_gather, "beam_gather", ("take", "flat", "onehot"))
    _one_of(m.beam_buf, "beam_buf", ("reorder", "backptr"))
    if not 0.0 <= t.ss_prob <= 1.0:
        raise ValueError("ss_prob must be in [0, 1]")
    if t.grad_accum < 1:
        raise ValueError("grad_accum must be >= 1")
    if t.batch_size % t.grad_accum:
        raise ValueError(
            f"batch_size {t.batch_size} must be divisible by "
            f"grad_accum {t.grad_accum} (static microbatch shapes)")
    if t.grad_accum > 1 and (t.data_parallel or t.model_parallel > 1):
        raise ValueError("grad_accum is the single-device memory lever; "
                         "with a mesh, shard the batch instead")
    if t.model_parallel < 1:
        raise ValueError("model_parallel must be >= 1")
    if t.model_parallel > 1 and t.use_shard_map:
        raise ValueError("use_shard_map is the explicit DP path; "
                         "model_parallel > 1 uses pjit shardings")
    if t.length_buckets:
        try:
            bs = parse_buckets(t.length_buckets)
        except ValueError:
            raise ValueError(
                f"length_buckets must be comma-separated ints, got "
                f"{t.length_buckets!r}")
        if not bs:
            raise ValueError(
                f"length_buckets is non-empty but parses to no buckets: "
                f"{t.length_buckets!r}")
        if any(b < 1 for b in bs):
            raise ValueError("length_buckets entries must be >= 1")
    return cfg


def parse_buckets(spec: str) -> tuple:
    """'10,20,30' -> (10, 20, 30)."""
    return tuple(int(x) for x in spec.split(",") if x.strip())


# reference-scale widths: dim 3584, dim_word 512, vocab 13056, K 28
_REF_MODEL = dict(n_words=13056, dim_word=512, dim=3584, ctx_dim=1024,
                  n_frames=28, compute_dtype="bfloat16", scan_unroll=1)


def preset(name: str) -> Config:
    """A named preset, as the JAX package defines them:
      msvd-temporal (1) temporal attention, greedy, decode batch 1024
      msvd-spatial  (2) spatial-temporal attention, R 49, Dr 1024
      msvd-beam     (3) beam 5 + length norm
      msrvtt-fused  (4) appearance + motion streams, ctx 2048
      msvd-dp       (5) data-parallel training
    """
    base = Config()
    model = dataclasses.replace(base.model, **_REF_MODEL)
    decode = dataclasses.replace(base.decode, beam_size=5, maxlen=30,
                                 length_norm=0.6, decode_batch=256)
    base = base.replace(model=model, decode=decode)
    if name in ("msvd-temporal", "1"):
        return base.replace(
            decode=dataclasses.replace(base.decode, beam_size=1,
                                       decode_batch=1024))
    if name in ("msvd-spatial", "2"):
        return base.replace(
            model=dataclasses.replace(base.model, use_spatial=True,
                                      n_regions=49, region_dim=1024))
    if name in ("msvd-beam", "3"):
        return base
    if name in ("msrvtt-fused", "4"):
        return base.replace(
            model=dataclasses.replace(
                base.model, use_motion=True, motion_dim=2048,
                ctx_dim=2048, n_words=20096),
            data=dataclasses.replace(base.data, dataset="msrvtt"))
    if name in ("msvd-dp", "5"):
        return base.replace(
            train=dataclasses.replace(base.train, data_parallel=True,
                                      use_shard_map=True,
                                      per_device_batch=64))
    raise KeyError(f"unknown preset {name!r}")
