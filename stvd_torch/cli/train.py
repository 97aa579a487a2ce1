"""Training entry point (counterpart of stvd/cli/train.py): build the
config, write ``config.json`` and ``vocab.pkl`` into ``train.save_dir``
and run ``train.loop.fit`` there.

Usage:
    python -m stvd_torch.cli.train --config cfg.json [--preset msvd-beam]
        [--set train.max_epochs=3] [--max-updates N] [--device cpu]

Scheduled sampling takes ``--set train.ss_prob=0.25``, the autodiff
train scan ``--set model.fused_seq_grad=false`` (with ``--set
model.remat=true`` to recompute each step in the backward); both run
the kernel step on a CUDA device (``--no-kernel``: the plain step).

Runs on the card unless ``--device cpu``.  Data parallelism
(``--data-parallel``, or a config with ``train.data_parallel`` such as
preset 5, ``msvd-dp``) runs over every rank that ``torchrun`` starts:

    torchrun --nproc-per-node N -m stvd_torch.cli.train --preset msvd-dp
    torchrun --nproc-per-node 2 -m stvd_torch.cli.train --preset msvd-dp \
        --device cpu --set ...          # gloo on the CPU

Each rank joins the process group from ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` (NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU), and
``fit`` trains over the 1-D data mesh (``--shard-map`` /
``--no-shard-map`` name the JAX package's two spellings of the update,
which make the same update); rank 0 writes the run directory.  One
process (no ``WORLD_SIZE`` above 1) is a single-device run.
``--model-parallel`` above 1 raises ``NotImplementedError`` (ROADMAP.md
Queue 1 item 8b).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

from . import device as cli_device
from ..config import Config, preset, validate
from ..data.corpus import load_splits
from ..model.kernel import get_step_fn
from ..train import parallel
from ..train.loop import fit
from ..utils.logging import MetricsLogger


def apply_overrides(cfg: Config, sets) -> Config:
    """--set section.key=value overrides (typed via the dataclass)."""
    for s in sets or []:
        path, _, raw = s.partition("=")
        section, _, key = path.partition(".")
        sub = getattr(cfg, section)
        old = getattr(sub, key)
        if isinstance(old, bool):
            val = raw.lower() in ("1", "true", "yes")
        elif isinstance(old, int):
            val = int(raw)
        elif isinstance(old, float):
            val = float(raw)
        else:
            val = raw
        cfg = dataclasses.replace(
            cfg, **{section: dataclasses.replace(sub, **{key: val})})
    return cfg


def build_config(args) -> Config:
    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    elif args.preset:
        cfg = preset(args.preset)
    else:
        cfg = Config()
    return validate(apply_overrides(cfg, args.set))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", help="config json path")
    ap.add_argument("--preset",
                    help="named preset (see stvd_torch.config.preset)")
    ap.add_argument("--set", action="append",
                    help="override: section.key=value")
    ap.add_argument("--max-updates", type=int, default=None)
    ap.add_argument("--use-kernel", action="store_true", default=None,
                    help="force the kernel step for validation and the "
                         "autograd train scans (default: auto, the "
                         "kernels on a CUDA device)")
    ap.add_argument("--no-kernel", dest="use_kernel",
                    action="store_false", help="force the plain step")
    ap.add_argument("--data-parallel", action="store_true", default=None,
                    help="shard the batch over the ranks torchrun starts "
                         "(default: cfg.train.data_parallel; one process "
                         "is a single-device run)")
    ap.add_argument("--no-data-parallel", dest="data_parallel",
                    action="store_false", help="force single-device")
    ap.add_argument("--shard-map", action="store_true", default=None,
                    help="the JAX package's shard_map spelling of the "
                         "data-parallel update (default: "
                         "cfg.train.use_shard_map); both spellings make "
                         "the same update: gradients of the summed "
                         "objective reduced, then divided")
    ap.add_argument("--no-shard-map", dest="shard_map",
                    action="store_false",
                    help="the JAX package's pjit spelling (the same "
                         "update)")
    ap.add_argument("--model-parallel", type=int, default=None,
                    metavar="N",
                    help="tensor parallelism over N devices (default: "
                         "cfg.train.model_parallel; only 1 is ported)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a CPU run)")
    args = ap.parse_args(argv)

    cfg = build_config(args)
    device = cli_device(args.device)
    dp = (cfg.train.data_parallel if args.data_parallel is None
          else args.data_parallel)
    mp = (cfg.train.model_parallel if args.model_parallel is None
          else args.model_parallel)
    if mp > 1:
        raise NotImplementedError(
            "model parallelism is not ported yet (ROADMAP.md Queue 1 "
            "item 8b)")
    mesh = None
    if dp and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        mesh = parallel.make_mesh(device.type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
    writer = parallel.axis_rank(mesh) == 0
    os.makedirs(cfg.train.save_dir, exist_ok=True)
    if writer:
        with open(os.path.join(cfg.train.save_dir, "config.json"),
                  "w") as f:
            f.write(cfg.to_json())

    splits = load_splits(cfg)
    if writer:
        # persist the vocab next to checkpoints (Captioner.from_run_dir)
        splits["train"].vocab.save_pickle(
            os.path.join(cfg.train.save_dir, "vocab.pkl"))
    step_fn = get_step_fn(args.use_kernel, device)
    logger = (MetricsLogger(cfg.train.save_dir,
                            tensorboard=cfg.train.tensorboard)
              if writer else None)
    try:
        result = fit(cfg, splits["train"], splits.get("valid"),
                     step_fn=step_fn, mesh=mesh, logger=logger,
                     max_updates=args.max_updates,
                     use_shard_map=args.shard_map,
                     test_ds=splits.get("test"), device=device)
        if writer:
            logger.log("done", best_metric=result.best_metric,
                       best_step=result.best_step)
    finally:
        if writer:
            logger.close()
    return 0


def run() -> int:
    try:
        return main()
    except (ValueError, FileNotFoundError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(run())
