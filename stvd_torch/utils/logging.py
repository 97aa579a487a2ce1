"""Structured metrics logging (counterpart of stvd/utils/logging.py).

Each record goes to stdout as ``[kind] key=value ...`` and, with a run
directory, as one JSON line of ``metrics.jsonl``; with ``tensorboard``
its numbers also become scalar curves under ``save_dir/tb``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, save_dir: Optional[str] = None,
                 filename: str = "metrics.jsonl", echo: bool = True,
                 tensorboard: bool = False):
        self.echo = echo
        self._fh = None
        self._tb = None
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            self._fh = open(os.path.join(save_dir, filename), "a")
            if tensorboard:
                # raises ImportError where tensorboard is not installed
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(save_dir, "tb"))
        self._t0 = time.time()

    def log(self, kind: str, **fields: Any) -> None:
        rec: Dict[str, Any] = {"kind": kind,
                               "elapsed_s": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "item") else v)
                    for k, v in fields.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self._tb is not None:
            step = int(rec.get("update", rec.get("step", 0)))
            for k, v in rec.items():
                if k in ("kind", "update", "step", "epoch"):
                    continue
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    self._tb.add_scalar(f"{kind}/{k}", float(v), step)
        if self.echo:
            kv = " ".join(f"{k}={v}" for k, v in rec.items()
                          if k not in ("kind",))
            print(f"[{kind}] {kv}", flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
            self._tb = None
