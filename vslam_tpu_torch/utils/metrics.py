"""Structured per-frame metrics + stage timing.

The reference's observability is std::cout prose + Ceres reports + GUI
overlays (SURVEY.md section 5); here every frame emits a structured record
(JSONL) and hot stages are timed with a lightweight scoped timer whose
summaries surface in the run log.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Optional


class StageTimer:
    """Accumulates wall-clock per named stage."""

    def __init__(self):
        self.total: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            self.count[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {
            k: {"total_s": round(self.total[k], 4),
                "count": self.count[k],
                "mean_ms": round(1000 * self.total[k] / max(self.count[k], 1),
                                 3)}
            for k in sorted(self.total)
        }


class MetricsLogger:
    """JSONL writer for per-frame records; no-op when path is None."""

    def __init__(self, path: Optional[str] = None):
        self._f = open(path, "w") if path else None

    def log(self, record: dict) -> None:
        if self._f:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
