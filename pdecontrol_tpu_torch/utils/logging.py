"""Metrics sink: JSONL + console status tables, optional wandb.

The reference logs exclusively to wandb (SURVEY §5).  Here the primary sink
is a local JSONL stream (one merged record per commit) plus the tabulated
console status report (reference ``summarize``, mbrl.py:604-608); wandb is
used transparently when available and enabled.

A copy of ``pdecontrol_tpu.utils.logging`` (plain Python), kept in the port
so that importing it never runs the JAX package's ``__init__``; both
packages write the same ``metrics.jsonl`` records.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


class MetricsLogger:
    def __init__(self, run_dir: str, use_wandb: bool = False,
                 project: Optional[str] = None, name: Optional[str] = None,
                 config: Optional[Dict] = None, append: bool = False,
                 enabled: bool = True):
        # enabled=False (non-primary processes of a multi-process run):
        # keep the in-memory summary (status tables still work) but never
        # touch the filesystem or wandb — file I/O is primary-only
        # (parallel/distributed.py host-boundary rules).
        self.enabled = enabled
        self._pending: Dict = {}
        self.summary: Dict = {}
        self._step = 0
        self.wandb = None
        self._file = None
        if not enabled:
            return
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")
        # Fresh runs truncate so a re-run into the same run_dir never mixes
        # two runs' records; the controller passes append=True only when a
        # checkpoint was actually restored.  A fresh run into a dir with an
        # existing stream backs the old file up instead of destroying it.
        if not append and os.path.exists(self.path) and os.path.getsize(self.path):
            backup = self.path + f".bak-{int(time.time())}"
            os.replace(self.path, backup)
            print(f"[logger] existing metrics stream moved to {backup}")
        if append and os.path.exists(self.path):
            # A resumed run goes on numbering its records where the stream ends.
            with open(self.path) as f:
                self._step = sum(1 for _ in f)
        self._file = open(self.path, "a" if append else "w", buffering=1)
        if use_wandb:
            try:
                import wandb

                wandb.init(project=project, name=name, config=config or {})
                self.wandb = wandb
            except Exception:
                self.wandb = None

        if config is not None:
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                json.dump(config, f, indent=2, default=str)

    def log(self, metrics: Dict, commit: bool = True) -> None:
        clean = {k: _to_py(v) for k, v in metrics.items()}
        self._pending.update(clean)
        self.summary.update(clean)
        if commit:
            record = dict(self._pending)
            record["_step"] = self._step
            record["_time"] = time.time()
            if self._file is not None:
                self._file.write(json.dumps(record, default=str) + "\n")
            if self.wandb is not None:
                self.wandb.log(self._pending)
            self._pending = {}
            self._step += 1

    def table(self, headers: List[str]) -> str:
        """Console status table over summary values (mbrl.py:604-608)."""
        values = [self.summary.get(h, "-X-") for h in headers]
        cells = [
            f"{v:.4g}" if isinstance(v, float) else str(v) for v in values
        ]
        widths = [max(len(h), len(c)) for h, c in zip(headers, cells)]
        head = "  ".join(h.ljust(w) for h, w in zip(headers, widths))
        rule = "  ".join("-" * w for w in widths)
        row = "  ".join(c.ljust(w) for c, w in zip(cells, widths))
        return "\n".join([head, rule, row])

    def finish(self) -> None:
        if self._file is not None:
            self._file.close()
        if self.wandb is not None:
            self.wandb.finish()


def _to_py(v):
    try:
        import numpy as np

        if hasattr(v, "item") and getattr(v, "size", None) == 1:
            return v.item()
        if isinstance(v, (np.ndarray,)):
            return v.tolist()
    except Exception:
        pass
    return v
