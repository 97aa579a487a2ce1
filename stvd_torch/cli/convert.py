"""Legacy-artifact converters (counterpart of stvd/cli/convert.py).

Feature banks — legacy pickles -> packed .npz:
    python -m stvd_torch.cli.convert --features FEAT.pkl [--regions REG.pkl]
        [--motion C3D.pkl] --frames 28 --out bank.npz

Reference checkpoints — a Theano ``model_best_so_far.npz``, or the
``.npz`` that either package's ``save_reference_npz`` writes -> a run
directory of the port (``config.json``, ``ckpt.pt`` and ``ckpt_best.pt``
[, ``vocab.pkl``]) that ``cli.sample --run-dir`` and
``api.Captioner.from_run_dir`` load; the model's dimensions come from
the weight shapes.  This is how a model crosses between the JAX
package's run directories (Orbax) and the port's (``torch.save``):
    python -m stvd_torch.cli.convert --ref-model model_best_so_far.npz \
        [--worddict worddict.pkl] --run-dir runs/imported [--device cpu]

Vocabulary — a reference-format worddict from a caption corpus (CAP.pkl
or .json), ranked by frequency (ids 0/1 reserved for <eos>/UNK):
    python -m stvd_torch.cli.convert --build-vocab CAP.pkl \
        --out worddict.pkl [--max-words 20000]
"""

from __future__ import annotations

import argparse
import os
import sys

from . import device as cli_device
from ..data.bank import load_legacy_pickle, pack_bank


def _convert_model(args) -> int:
    from ..config import Config
    from ..model.importer import infer_model_config, load_reference_npz
    from ..train.loop import init_train_state, save_checkpoint

    mcfg = infer_model_config(args.ref_model)
    params, report = load_reference_npz(args.ref_model, mcfg)
    cfg = Config(model=mcfg)
    os.makedirs(args.run_dir, exist_ok=True)
    with open(os.path.join(args.run_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    # optimizer slots and the dropout generator of a fresh run on the
    # device that resumes it; the imported weights in place of its own
    state = init_train_state(0, mcfg, cfg.train, args.device)
    state["params"] = params
    for name in ("ckpt", "ckpt_best"):
        save_checkpoint(os.path.join(args.run_dir, name + ".pt"), state, {})
    if args.worddict:
        from ..data.text import Vocab
        Vocab.load_pickle(args.worddict).save_pickle(
            os.path.join(args.run_dir, "vocab.pkl"))
    print(f"imported reference model -> {args.run_dir} "
          f"(dim={mcfg.dim} ctx={mcfg.ctx_dim} vocab={mcfg.n_words} "
          f"spatial={mcfg.use_spatial}); {report}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--features",
                    help="legacy pkl: vid -> (F, D) frame features")
    ap.add_argument("--regions", help="legacy pkl: vid -> (F, R, Dr)")
    ap.add_argument("--motion", help="legacy pkl: vid -> (F, Dm)")
    ap.add_argument("--frames", type=int, default=28,
                    help="K frames to subsample/pad to")
    ap.add_argument("--out", help="output .npz path (feature mode)")
    ap.add_argument("--ref-model",
                    help="reference Theano .npz checkpoint to import")
    ap.add_argument("--run-dir",
                    help="output run dir for --ref-model")
    ap.add_argument("--worddict",
                    help="legacy worddict.pkl -> run-dir vocab.pkl")
    ap.add_argument("--build-vocab",
                    help="caption corpus (CAP.pkl or .json) -> "
                         "frequency-ranked worddict at --out")
    ap.add_argument("--max-words", type=int, default=20000,
                    help="vocab cap for --build-vocab (incl. <eos>/UNK)")
    ap.add_argument("--device", default="cuda",
                    help="--ref-model: the device whose training state "
                         "the checkpoints hold (default cuda; cpu for a "
                         "run dir that trains on the CPU)")
    args = ap.parse_args(argv)

    if args.build_vocab:
        if not args.out:
            ap.error("--build-vocab requires --out")
        from ..data.corpus import load_captions
        from ..data.text import Vocab
        caps = load_captions(args.build_vocab)
        vocab = Vocab.build((toks for c in caps.values() for toks in c),
                            max_words=args.max_words)
        vocab.save_pickle(args.out)
        print(f"built vocab: {len(vocab)} words from "
              f"{sum(len(c) for c in caps.values())} captions "
              f"({len(caps)} videos) -> {args.out}")
        return 0
    if args.ref_model:
        if not args.run_dir:
            ap.error("--ref-model requires --run-dir")
        cli_device(args.device)
        return _convert_model(args)
    if not args.features or not args.out:
        ap.error("feature mode requires --features and --out")

    feats = load_legacy_pickle(args.features)
    regions = load_legacy_pickle(args.regions) if args.regions else None
    motion = load_legacy_pickle(args.motion) if args.motion else None
    bank = pack_bank(feats, args.frames, regions=regions, motion=motion)
    bank.save(args.out)
    print(f"packed {bank.n_videos} videos x {bank.n_frames} frames -> "
          f"{args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
