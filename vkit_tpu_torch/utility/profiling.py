"""Step-level timing.

Counterpart of vkit_tpu/utility/profiling.py: its ``StepTimer``, which a
caller wraps around pipeline stages.  The reference's jax trace and
compile-cache helpers have no counterpart here.
"""
import contextlib
import json
import logging
import time
from collections import defaultdict
from typing import Dict

logger = logging.getLogger(__name__)


class StepTimer:
    """Accumulates wall-clock per named stage; cheap enough to leave on."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def measure(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            self.totals[name] += elapsed
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                'total_sec': round(self.totals[name], 4),
                'count': self.counts[name],
                'mean_ms': round(self.totals[name] / self.counts[name] * 1e3, 3),
            }
            for name in sorted(self.totals, key=self.totals.get, reverse=True)
        }

    def log_summary(self, header: str = 'step timings'):
        logger.info('%s: %s', header, json.dumps(self.summary()))

    def reset(self):
        self.totals.clear()
        self.counts.clear()
