"""Structured metric logging (the port's own copy of the JAX ``utils/logging.py``).

The reference logs with print() and a blocking matplotlib preview every 12
batches (train_cnn.py:337-357). Here: one line per event on stderr, and an
append-only JSONL stream (``metrics.jsonl``) that holds every event,
including the per-batch records that skip stderr.
"""

from __future__ import annotations

import json
import os
import sys
import time


class MetricLogger:
    def __init__(self, jsonl_path: str | None = None, stdout: bool = True):
        self.jsonl_path = jsonl_path
        self.stdout = stdout
        self._start = time.time()
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._f = open(jsonl_path, "a", buffering=1)
        else:
            self._f = None

    def log(self, event: str, stdout: bool | None = None, **fields) -> None:
        """Log one event. ``stdout=False`` writes only to the JSONL stream
        (used for high-rate per-batch records)."""
        rec = {"event": event, "t": round(time.time() - self._start, 3), **fields}
        if self._f:
            self._f.write(json.dumps(rec, default=float) + "\n")
        if self.stdout and stdout is not False:
            kv = "\t".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in fields.items()
            )
            print(f"[{event}] {kv}", file=sys.stderr)

    def close(self) -> None:
        if self._f:
            self._f.close()
