"""Step-level timing + device trace capture.

Counterpart of vkit_tpu/utility/profiling.py: its ``StepTimer``, which a
caller wraps around pipeline stages, and ``device_trace``, here a
``torch.profiler`` trace of the host and the card written as a Chrome
trace (the reference writes a jax profiler trace).  The reference's
compile-cache and host-allocator helpers have no counterpart here.
"""
import contextlib
import json
import logging
import os
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


@contextlib.contextmanager
def device_trace(log_dir: str, enabled: bool = True, host: bool = True):
    """torch.profiler trace of the CPU and, where there is one, the CUDA
    device, written into ``log_dir`` as a Chrome trace
    (``trace_<pid>_<ns>.json``, viewable in Perfetto); no-op when disabled.
    Yields the profiler (None when disabled).  ``host=False`` leaves out
    the host's operator events when there is a card (its kernels, copies
    and the runtime calls that issue them remain): a window of 1e5 small
    operators would write a trace of gigabytes."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] if host or not cuda else []
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f'trace_{os.getpid()}_{time.time_ns()}.json'))
