"""Stage timing.

The reference's observability is std::cout prose + Ceres reports + GUI
overlays (SURVEY.md section 5); here hot stages are timed with a
lightweight scoped timer whose summaries surface in the run log (the
command line writes its per-frame JSONL records itself).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


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
