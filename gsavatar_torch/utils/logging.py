"""JSONL metric logger.

The port's copy of `gsavatar/utils/logging.py:MetricLogger`: one JSON
object per `log` call, `{"step": ..., "time": ..., **metrics}`, appended to
`path` and kept in `history`."""
from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricLogger:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.history: list = []
        self._f = None
        if path:
            os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
            self._f = open(path, 'a')

    def log(self, step: int, metrics: dict):
        rec = {'step': int(step), 'time': time.time(), **metrics}
        self.history.append(rec)
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
