"""Generate and score captions for a split from a saved checkpoint
(counterpart of stvd/cli/sample.py, with the same flags and files).

Usage:
    python -m stvd_torch.cli.sample --run-dir runs/default [--split test]
        [--beam 5] [--nbest N] [--stochastic N] [--dump-attention N]
        [--nll] [--device cpu]

Writes into the run directory ``{split}_samples.txt``/``.json`` and
``{split}_scores.json`` (scores with the corpus provenance), and with the
flags ``{split}_nbest.json``, ``{split}_sampled.json`` and
``{split}_attention.npz``.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from . import device as cli_device
from ..api import padded_chunks
from ..config import Config, validate
from ..data.bank import to_device
from ..data.corpus import corpus_provenance, load_splits
from ..model.kernel import get_step_fn
from ..model.step import compute_dtype
from ..train.evaluate import evaluate_split


def _split_batch(cfg, ds, n: int, device) -> dict:
    """The split's first ``n`` videos from the bank's cached device copy
    (``evaluate_split`` made it; no second copy of the bank)."""
    dev = to_device(ds.bank, device, compute_dtype(cfg.model))
    return {k: v[:n] for k, v in dev.items()}


def _nbest(args, cfg, params, ds, step_fn, device, qtag) -> None:
    from ..decode.beam import beam_decode
    n = min(args.nbest, ds.bank.n_videos)
    with torch.inference_mode():
        out = beam_decode(params, cfg.model,
                          _split_batch(cfg, ds, n, device),
                          beam_size=max(2, cfg.decode.beam_size),
                          maxlen=cfg.decode.maxlen,
                          length_norm=cfg.decode.length_norm,
                          step_fn=step_fn)
    toks = out.all_tokens.cpu().numpy()
    scrs = out.all_scores.cpu().numpy()
    # ordered by the length-normalized score, the one best-beam selection
    # uses, so beams[0] is the caption the samples files hold
    nrm = out.all_norm_scores.cpu().numpy()
    rows = []
    for i in range(n):
        order = np.argsort(-nrm[i])
        beams = [{"caption": " ".join(ds.vocab.decode(toks[i, j])),
                  "logprob": float(scrs[i, j]),
                  "norm_score": float(nrm[i, j])}
                 for j in order]
        rows.append({"image_id": ds.bank.ids[i], "beams": beams})
    path = os.path.join(args.run_dir, f"{args.split}_nbest{qtag}.json")
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"n-best lists -> {path}")


def _stochastic(args, cfg, params, ds, step_fn, device, qtag) -> None:
    from ..decode.sample import sample_decode
    dev = to_device(ds.bank, device, compute_dtype(cfg.model))
    n_vid = ds.bank.n_videos
    # fixed decode_batch chunks, the last zero-padded
    bsz = cfg.decode.decode_batch
    gen = torch.Generator(device=device).manual_seed(args.seed)
    tok_parts, scr_parts = [], []
    for count, chunk in padded_chunks(dev, bsz):
        with torch.inference_mode():
            out = sample_decode(params, cfg.model, chunk, gen,
                                maxlen=cfg.decode.maxlen,
                                temperature=args.temperature,
                                top_k=args.top_k,
                                n_samples=args.stochastic, step_fn=step_fn)
        tok_parts.append(out.tokens[:count].cpu().numpy())
        scr_parts.append(out.scores[:count].cpu().numpy())
    toks = np.concatenate(tok_parts)
    scrs = np.concatenate(scr_parts)
    rows = []
    for i in range(n_vid):
        samples = [{"caption": " ".join(ds.vocab.decode(toks[i, j])),
                    "logprob": float(scrs[i, j])}
                   for j in range(toks.shape[1])]
        rows.append({"image_id": ds.bank.ids[i], "samples": samples})
    path = os.path.join(args.run_dir, f"{args.split}_sampled{qtag}.json")
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"stochastic samples (T={args.temperature}, "
          f"top_k={args.top_k}) -> {path}")


def _attention(args, cfg, params, ds, step_fn, device, qtag) -> None:
    from ..decode.greedy import greedy_decode
    n = min(args.dump_attention, ds.bank.n_videos)
    b = _split_batch(cfg, ds, n, device)
    with torch.inference_mode():
        out = greedy_decode(params, cfg.model, b, maxlen=cfg.decode.maxlen,
                            step_fn=step_fn, return_alphas=True)
    path = os.path.join(args.run_dir, f"{args.split}_attention{qtag}.npz")
    np.savez_compressed(
        path, ids=np.asarray(ds.bank.ids[:n]),
        tokens=out.tokens.cpu().numpy().astype(np.int32),
        alphas=out.alphas.cpu().numpy(),
        frame_mask=b["frame_mask"].cpu().numpy())
    print(f"attention maps -> {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--split", default="test",
                    choices=["train", "valid", "test"])
    ap.add_argument("--beam", type=int, default=None)
    ap.add_argument("--best", action="store_true",
                    help="load ckpt_best.pt instead of the latest ckpt.pt")
    ap.add_argument("--use-kernel", action="store_true", default=None,
                    help="force the kernel decode step (default: auto, "
                         "the kernels on a CUDA device)")
    ap.add_argument("--no-kernel", dest="use_kernel",
                    action="store_false", help="force the plain step")
    ap.add_argument("--dump-attention", type=int, default=0, metavar="N",
                    help="greedy-decode the first N videos recording the "
                         "temporal attention maps -> {split}_attention.npz")
    ap.add_argument("--nbest", type=int, default=0, metavar="N",
                    help="write all beams with their scores for the "
                         "first N videos -> {split}_nbest.json")
    ap.add_argument("--stochastic", type=int, default=0, metavar="N",
                    help="draw N stochastic samples per video "
                         "-> {split}_sampled.json")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="truncated top-k sampling (0 = full vocab)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nll", action="store_true",
                    help="also report teacher-forced NLL and perplexity "
                         "for the split")
    ap.add_argument("--quant", default=None, choices=["none", "int8"],
                    help="override model.decode_quant for this decode "
                         "(int8 = the W8A8 serving path).  The samples "
                         "and scores files are then not written, and the "
                         "n-best, sampled and attention files get a "
                         "'.{quant}' suffix")
    ap.add_argument("--synonyms", default=None, metavar="TABLE.json",
                    help="JSON {word: [synonyms...]} to activate "
                         "METEOR's stage-2 synonym matching; scores with "
                         "a non-jar table are not jar-comparable")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a CPU run)")
    args = ap.parse_args(argv)

    with open(os.path.join(args.run_dir, "config.json")) as f:
        cfg = Config.from_json(f.read())
    device = cli_device(args.device)
    if args.beam is not None:
        cfg = dataclasses.replace(
            cfg, decode=dataclasses.replace(cfg.decode, beam_size=args.beam))
    if args.quant is not None:
        cfg = validate(dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model,
                                           decode_quant=args.quant)))
    qtag = f".{args.quant}" if args.quant else ""

    if args.synonyms:
        from ..metrics.meteor import load_synonym_table
        n_syn = load_synonym_table(args.synonyms)
        print(f"METEOR synonym table: {n_syn} headwords from "
              f"{args.synonyms} (stage 2 active)")

    splits = load_splits(cfg)
    name = "ckpt_best" if args.best else "ckpt"
    blob = torch.load(os.path.join(args.run_dir, name + ".pt"),
                      map_location="cpu", weights_only=True)
    params = {k: v.to(device, torch.float32)
              for k, v in blob["params"].items()}
    step_fn = get_step_fn(args.use_kernel, device)
    ds = splits[args.split]
    scores = evaluate_split(
        params, cfg, ds, split=args.split,
        save_dir=None if args.quant else args.run_dir, step_fn=step_fn,
        device=device)
    if args.nll:
        from ..train.loop import evaluate_nll_stats, perplexity
        num, ex, tok = evaluate_nll_stats(
            params, cfg.model, ds, cfg.train.valid_batch_size, step_fn,
            device=device)
        scores["nll"] = num / max(ex, 1.0)
        scores["nll_per_token"] = num / max(tok, 1.0)
        scores["perplexity"] = perplexity(num / max(tok, 1.0))
    if args.nbest > 0:
        _nbest(args, cfg, params, ds, step_fn, device, qtag)
    if args.stochastic > 0:
        _stochastic(args, cfg, params, ds, step_fn, device, qtag)
    if args.dump_attention > 0:
        _attention(args, cfg, params, ds, step_fn, device, qtag)
    # the scores beside the samples files, with the corpus provenance, so
    # a synthetic-corpus score is never read as paper quality
    if cfg.data.dataset == "synthetic":
        prov = {"synthetic": True, "generator": "data.batching."
                "synthetic_dataset (in-memory)",
                "note": "fabricated corpus — scores are harness pins, "
                        "NOT paper-comparable quality"}
    else:
        prov = corpus_provenance(cfg.data.data_dir)
    meta = {"split": args.split, "beam": cfg.decode.beam_size,
            "checkpoint": name, "scores": scores, "corpus": prov}
    if prov.get("synthetic"):
        meta["caveat"] = ("synthetic corpus — harness pin, NOT "
                          "paper-comparable quality")
    if not args.quant:
        score_path = os.path.join(args.run_dir,
                                  f"{args.split}_scores.json")
        with open(score_path, "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True)
    print(json.dumps(scores, indent=2, sort_keys=True))
    return 0


def run() -> int:
    try:
        return main()
    except FileNotFoundError as e:
        print(f"error: {e} (is --run-dir a training run directory?)",
              file=sys.stderr)
        return 2
    except (ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(run())
