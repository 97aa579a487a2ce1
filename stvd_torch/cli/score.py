"""Score an existing hypothesis file against references — no model and
no device (counterpart of stvd/cli/score.py; the reference scorer is
routinely driven directly on hypothesis/GT dicts).

Usage:
    python -m stvd_torch.cli.score --hyp runs/default/test_samples.json \
        --refs data/msvd/CAP.pkl [--ids data/msvd/test_ids.txt]

Hypothesis formats (auto-detected):
  * ``*_samples.json`` — ``[{"image_id": ..., "caption": ...}, ...]``
    (the parity artifact ``train/evaluate.py`` writes)
  * ``*.txt``          — ``vid<TAB>caption`` per line (``samples.txt``)
  * plain JSON dict    — ``{vid: "caption"}`` or ``{vid: ["caption"]}``

References: a JSON dict ``{vid: [captions...]}`` or a legacy Py2
``CAP.pkl`` (latin1), via ``data.corpus.load_captions``.  Both sides
are PTB-tokenized at scoring time, exactly like the in-training
pipeline (and the reference, which runs PTBTokenizer on GT and
hypotheses alike).

The scores artifact embeds the reference corpus' ``PROVENANCE.json``
(from the directory holding ``--refs``) so a synthetic-corpus score
can never be over-read as paper quality.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List


def load_hypotheses(path: str) -> Dict[str, List[str]]:
    """Read a hypothesis file into ``{vid: [caption]}``."""
    if path.endswith(".txt"):
        out: Dict[str, List[str]] = {}
        with open(path) as f:
            for ln, line in enumerate(f, 1):
                line = line.rstrip("\n")
                if not line:
                    continue
                if "\t" not in line:
                    raise ValueError(
                        f"{path}:{ln}: expected 'vid<TAB>caption'")
                vid, cap = line.split("\t", 1)
                out[vid] = [cap]
        return out
    with open(path) as f:
        raw = json.load(f)
    if isinstance(raw, list):
        out = {}
        for i, row in enumerate(raw):
            if not isinstance(row, dict) or "image_id" not in row \
                    or "caption" not in row:
                raise ValueError(
                    f"{path}[{i}]: expected {{'image_id', 'caption'}} rows")
            out[str(row["image_id"])] = [str(row["caption"])]
        return out
    if isinstance(raw, dict):
        out = {}
        for vid, cap in raw.items():
            if isinstance(cap, str):
                out[str(vid)] = [cap]
            elif isinstance(cap, list) and cap:
                out[str(vid)] = [str(cap[0])]
            else:
                raise ValueError(f"{path}: id {vid!r} has no caption")
        return out
    raise ValueError(f"{path}: unrecognized hypothesis JSON shape")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--hyp", required=True,
                    help="hypothesis file (samples .json/.txt or a "
                         "{vid: caption} JSON dict)")
    ap.add_argument("--refs", required=True,
                    help="references: {vid: [captions]} JSON or legacy "
                         "CAP.pkl (Py2, latin1)")
    ap.add_argument("--ids", default=None, metavar="IDS.txt",
                    help="score only the video ids listed in this file "
                         "(one per line — a reference split list)")
    ap.add_argument("--intersect", action="store_true",
                    help="score the ids present in BOTH files instead "
                         "of requiring a hypothesis for every reference "
                         "id (default: a missing hypothesis is an error, "
                         "like COCOScorer)")
    ap.add_argument("--meteor-profile", default="meteor2005",
                    choices=["meteor2005", "meteor15-en"])
    ap.add_argument("--synonyms", default=None, metavar="TABLE.json",
                    help="JSON {word: [synonyms...]} to activate "
                         "METEOR's stage-2 synonym matching (see "
                         "cli.sample --synonyms; non-jar tables are not "
                         "jar-comparable)")
    ap.add_argument("--out", default=None, metavar="SCORES.json",
                    help="write the scores artifact here (embeds corpus "
                         "provenance; default: print only)")
    args = ap.parse_args(argv)

    # scoring is host work: it runs without touching the card
    from ..data.corpus import corpus_provenance, load_captions
    from ..metrics.scorer import score_all

    if args.synonyms:
        from ..metrics.meteor import load_synonym_table
        n_syn = load_synonym_table(args.synonyms)
        print(f"METEOR synonym table: {n_syn} headwords from "
              f"{args.synonyms} (stage 2 active)", file=sys.stderr)

    hyps = load_hypotheses(args.hyp)
    refs_tok = load_captions(args.refs)
    # corpus token lists -> raw strings: both sides go through the same
    # PTB tokenization inside score_all (reference scoring pipeline)
    gts = {v: [" ".join(r) for r in caps if r]
           for v, caps in refs_tok.items()}
    gts = {v: caps for v, caps in gts.items() if caps}

    if args.ids:
        with open(args.ids) as f:
            keep = {l.strip() for l in f if l.strip()}
        missing_refs = keep - set(gts)
        if missing_refs:
            raise ValueError(
                f"--ids lists {len(missing_refs)} video(s) with no "
                f"references, e.g. {sorted(missing_refs)[:5]}")
        gts = {v: c for v, c in gts.items() if v in keep}
        hyps = {v: c for v, c in hyps.items() if v in keep}
    if args.intersect:
        common = set(gts) & set(hyps)
        if not common:
            raise ValueError("no common video ids between --hyp and --refs")
        gts = {v: gts[v] for v in common}
        hyps = {v: hyps[v] for v in common}
    if not gts:
        raise ValueError("no scorable videos (empty reference set)")

    scores = score_all(gts, hyps, meteor_profile=args.meteor_profile)
    if args.out:
        prov = corpus_provenance(os.path.dirname(os.path.abspath(args.refs)))
        meta = {"hyp": args.hyp, "refs": args.refs,
                "n_videos": len(gts),
                "meteor_profile": args.meteor_profile,
                "scores": scores, "corpus": prov}
        if args.synonyms:
            meta["synonyms"] = args.synonyms
        if prov.get("synthetic"):
            meta["caveat"] = ("synthetic corpus — harness pin, NOT "
                              "paper-comparable quality")
        with open(args.out, "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True)
    print(json.dumps(scores, indent=2, sort_keys=True))
    return 0


def run() -> int:
    try:
        return main()
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except (ValueError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(run())
