"""Export a trained run as an AOT serving artifact (counterpart of
stvd/cli/export.py; see stvd_torch/export_aot.py).

    python -m stvd_torch.cli.export --run-dir runs/msvd --out artifacts/msvd \
        [--platforms cuda | cpu | cuda,cpu] [--batch 1,256] [--no-kernel] \
        [--quant int8] [--nbest] [--check] [--device cuda]

``--check`` loads the artifact and holds its captions of decode_batch + 1
random videos (a padded chunk) to the live Captioner's on ``--device``
(whose type must be one of the exported platforms); it exits 1 on any
difference.

``--data-parallel N`` exports the graphs of a 1-D data mesh of N ranks
(every batch size divisible by N), ``--model-parallel M`` those of a 2-D
data x model mesh of N x M ranks (N default 1) with the weights sharded
by ``TP_RULES`` (see ``export_aot``).  The export runs on those ranks,
launched by ``torchrun``, each rank on ``cuda:LOCAL_RANK`` (NCCL) or on
the CPU (``--device cpu``, gloo); rank 0 writes the shared files and
prints, and ``--check`` runs on every rank::

    torchrun --nproc-per-node 2 -m stvd_torch.cli.export --run-dir R \
        --out A --data-parallel 2 --batch 2,256 [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--run-dir", required=True,
                    help="training run dir (config.json + ckpt + vocab)")
    ap.add_argument("--out", required=True, help="artifact output dir")
    ap.add_argument("--platforms", default="cuda",
                    help="comma list: cuda | cpu | cuda,cpu (one graph "
                         "file per platform)")
    ap.add_argument("--batch", default="",
                    help="static decode batch size(s); a comma list "
                         "(e.g. '1,64,256') exports one graph per size "
                         "for bucketed serving (default: config "
                         "decode_batch)")
    ap.add_argument("--no-kernel", action="store_true",
                    help="the plain step (no CUDA kernels) even for a "
                         "cuda-only export")
    ap.add_argument("--quant", default=None, choices=["none", "int8"],
                    help="override model.decode_quant in the exported "
                         "graph (int8 = W8A8 gates matmul; weights stay "
                         "float32 call-time inputs, quantized inside the "
                         "graph)")
    ap.add_argument("--nbest", action="store_true",
                    help="also export the full-beam n-best graph per "
                         "batch size (requires beam_size > 1)")
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="export sharded over a 1-D data mesh of N "
                         "ranks (batch sizes must divide by N; launch N "
                         "ranks with torchrun; the loader needs N)")
    ap.add_argument("--model-parallel", type=int, default=0,
                    help="export tensor-parallel over a 2-D data x model "
                         "mesh of N x M ranks (weights sharded per "
                         "TP_RULES; combines with --data-parallel)")
    ap.add_argument("--best", action="store_true", default=True)
    ap.add_argument("--check", action="store_true",
                    help="roundtrip-verify against the live Captioner")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the live Captioner and the "
                         "check (default cuda; cpu for a CPU run)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from . import device
    from ..api import Captioner
    from ..export_aot import load_artifact, save_artifact
    from ..train import parallel

    dev = device(args.device)
    if parallel.visible_ranks() > 1:
        dev = parallel.rank_device(dev)     # cuda:LOCAL_RANK under torchrun
    platforms = tuple(p.strip() for p in args.platforms.split(",")
                      if p.strip())
    cap = Captioner.from_run_dir(args.run_dir, best=args.best,
                                 quant=args.quant, device=dev)
    use_kernel = False if args.no_kernel else None
    sizes = ([int(b) for b in args.batch.split(",") if b.strip()]
             if args.batch else None)
    manifest = save_artifact(args.out, cap.params, cap.cfg, cap.vocab,
                             platforms=platforms,
                             batch_sizes=sizes,
                             use_kernel=use_kernel,
                             nbest=args.nbest,
                             data_parallel=args.data_parallel,
                             model_parallel=args.model_parallel,
                             device=dev)
    first = not dist.is_initialized() or dist.get_rank() == 0
    say = print if first else (lambda *a, **k: None)
    say(f"exported {args.run_dir} -> {args.out} "
          f"(platforms={manifest['platforms']} "
          f"batch_sizes={manifest['batch_sizes']} "
          f"beam={manifest['beam_size']} "
          f"kernel={manifest['use_kernel']} "
          f"ops={manifest['custom_ops']})")

    if args.check:
        import numpy as np
        if dev.type not in platforms:
            say(f"check skipped: device {dev.type!r} not in exported "
                  f"platforms {platforms}")
            return 0
        m = cap.cfg.model
        rng = np.random.RandomState(0)
        n = manifest["decode_batch"] + 1  # exercises the pad path
        feats = rng.randn(n, m.n_frames, m.ctx_dim).astype(np.float32)
        regs = (list(rng.randn(n, m.n_frames, m.n_regions, m.region_dim)
                     .astype(np.float32)) if m.use_spatial else None)
        mots = (list(rng.randn(n, m.n_frames, m.motion_dim)
                     .astype(np.float32)) if m.use_motion else None)
        t0 = time.perf_counter()
        served = load_artifact(args.out, device=dev)
        load_s = time.perf_counter() - t0
        got = served.caption(feats, regs, mots)
        live = cap.caption(feats, regs, mots)
        ok = got == live
        say(f"check: {'OK: artifact captions match live' if ok else 'MISMATCH'}"
              f" ({sum(a == b for a, b in zip(got, live))}/{n} equal; "
              f"load {load_s} s)")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
