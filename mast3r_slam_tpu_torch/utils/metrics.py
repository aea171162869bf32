"""Structured run metrics: events (tracked frames, failed relocalizations,
re-initializations) collected as plain dicts and, with a path, appended as
JSONL. A copy of ``mast3r_slam_tpu/utils/metrics.py``."""

from __future__ import annotations

import json
import pathlib
import time
from collections import defaultdict


class Metrics:
    def __init__(self, path=None):
        self.path = pathlib.Path(path) if path else None
        self.rows = []
        self.counters = defaultdict(float)
        self._t_start = time.time()

    def log(self, **kv):
        row = {"t": round(time.time() - self._t_start, 3), **kv}
        self.rows.append(row)
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(row) + "\n")

    def bump(self, name, amount=1.0):
        self.counters[name] += amount

    def summary(self):
        out = dict(self.counters)
        out["elapsed_s"] = round(time.time() - self._t_start, 3)
        return out
