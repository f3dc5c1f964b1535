"""Step-level timing + device trace capture.

Counterpart of vkit_tpu/utility/profiling.py: its ``StepTimer``, which a
caller wraps around pipeline stages, and ``device_trace``, here a
``torch.profiler`` trace of the host and the card written as a Chrome
trace (the reference writes a jax profiler trace).  The reference's
compile-cache and host-allocator helpers have no counterpart here.

The port's own addition: program spans and counters.  Library code marks
its phases with ``span(name)`` and counts what it routes with
``count(name, n)``; both write to the active ``Recording`` and do nothing
when none is active (``recording()`` activates one; ``device_trace``
opens one for its session when none is active).  A recording keeps every
span in memory, stamped on ``time.perf_counter()``, with its id, its
parent's and the id of the top-level span it runs under; nothing is
written out.  ``last_recording()`` is the recording that closed last.
"""
import contextlib
import itertools
import json
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

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
    Yields the profiler (None when disabled).  Program spans and counters
    go to the active recording, or to one opened for the session and left
    as ``last_recording()`` (``Recording.trace_us`` places a span on the
    trace's clock).  ``host=False`` leaves out
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
    session = recording() if _active is None else contextlib.nullcontext()
    with session, profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f'trace_{os.getpid()}_{time.time_ns()}.json'))


# Spans a recording keeps (~30 MB of records); past it, it counts them.
SPAN_LIMIT = 250_000


class SpanRecord(NamedTuple):
    """One closed span: ``begin`` and ``end`` on ``time.perf_counter()``;
    ``parent`` is None for a top-level span, and ``request`` is the id of
    the top-level span it runs under (its own id for a top-level one)."""
    name: str
    begin: float
    end: float
    span_id: int
    parent: Optional[int]
    request: int
    thread: int


class Recording(StepTimer):
    """A StepTimer that also keeps each span as a ``SpanRecord`` and named
    counters.  Spans nest per thread; at most ``SPAN_LIMIT`` are kept and
    ``dropped`` counts the rest (their totals still count).  ``clock`` is
    (``perf_counter_ns``, ``time_ns``) read together when it opens."""

    def __init__(self):
        super().__init__()
        self.spans: List[SpanRecord] = []
        self.counters: Dict[str, int] = defaultdict(int)
        self.dropped = 0
        self.clock = (time.perf_counter_ns(), time.time_ns())
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def measure(self, name: str):
        return _OpenSpan(self, name)

    def count(self, name: str, n: int = 1):
        with self._lock:
            self.counters[name] += n

    def trace_us(self, seconds: float, base_time_ns: int) -> float:
        """A ``perf_counter`` reading on the clock of a Chrome trace that
        ``torch.profiler`` exported: microseconds after its
        ``baseTimeNanoseconds``."""
        wall_ns = self.clock[1] + seconds * 1e9 - self.clock[0]
        return (wall_ns - base_time_ns) / 1e3

    def _stack(self) -> list:
        stack = getattr(self._local, 'stack', None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _close(self, span: SpanRecord):
        with self._lock:
            self.totals[span.name] += span.end - span.begin
            self.counts[span.name] += 1
            if len(self.spans) < SPAN_LIMIT:
                self.spans.append(span)
            else:
                self.dropped += 1


class _OpenSpan:
    """The context of one span of a recording."""
    __slots__ = ('_recording', '_name', '_id', '_parent', '_request',
                 '_begin')

    def __init__(self, recording: Recording, name: str):
        self._recording = recording
        self._name = name

    def __enter__(self):
        stack = self._recording._stack()
        self._id = next(self._recording._ids)
        self._parent, self._request = stack[-1] if stack else (None, self._id)
        stack.append((self._id, self._request))
        self._begin = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        self._recording._stack().pop()
        self._recording._close(SpanRecord(
            self._name, self._begin, end, self._id, self._parent,
            self._request, threading.get_ident()))
        return False


_NO_SPAN = contextlib.nullcontext()
_active: Optional[Recording] = None
_last: Optional[Recording] = None


def span(name: str):
    """A span of the active recording; without one, a shared no-op."""
    active = _active
    return _NO_SPAN if active is None else active.measure(name)


def count(name: str, n: int = 1):
    """Add ``n`` to a counter of the active recording, if there is one."""
    active = _active
    if active is not None:
        active.count(name, n)


@contextlib.contextmanager
def recording():
    """Make a new ``Recording`` the active one for the block, and yield
    it; on exit it becomes ``last_recording()``.  One is active at a
    time."""
    global _active, _last
    if _active is not None:
        raise RuntimeError('a recording is already active')
    _active = Recording()
    try:
        yield _active
    finally:
        _last, _active = _active, None


def last_recording() -> Optional[Recording]:
    """The recording that closed last, or None."""
    return _last
