"""Readings of the program's own spans and counters.

The port records spans and counters into the recording that
``vkit_tpu_torch.utility.profiling.device_trace`` opens for its session;
a ``--trace 1`` run enters it for the profiled half of the window, so
these readings are of that half, where the profiler's CUPTI tracing slows
every launch.  Spans are stamped on ``time.perf_counter()``, the clock of
the harness's own spans, and are placed on the trace's clock by the
harness's anchor, as ``trace.name_gaps`` places the harness's spans.  A
program without that recording (a commit before it) or a recording
without a ``plan_warp`` span gives None.
"""
from typing import Dict, Iterable, List, Optional, Tuple

from .readers import complete_trace

STEP = 'plan_warp'
PLANNING = ('plan_warp.route', 'plan_warp.nodes', 'plan_warp.band_plan')
ENQUEUE = ('plan_warp.enqueue',)
ROUTES = ('affine', 'banded', 'half', 'gather')


def last_recording():
    """The program's last closed recording, or None where the program
    keeps none."""
    from vkit_tpu_torch.utility import profiling

    last = getattr(profiling, 'last_recording', None)
    return last() if last is not None else None


def _whole(recording) -> bool:
    """A recording that kept every span and holds at least one step."""
    return (recording is not None and not recording.dropped
            and any(s.name == STEP for s in recording.spans))


def self_seconds(spans, name: str) -> float:
    """Summed self time of the spans named ``name``: each one's duration
    less the durations of its direct children."""
    children: Dict[int, float] = {}
    for s in spans:
        if s.parent is not None:
            children[s.parent] = children.get(s.parent, 0.0) \
                + (s.end - s.begin)
    return sum(s.end - s.begin - children.get(s.span_id, 0.0)
               for s in spans if s.name == name)


def per_step(recording, name: str) -> Optional[float]:
    """Self seconds of the spans named ``name`` per ``plan_warp`` span."""
    if not _whole(recording):
        return None
    steps = sum(s.name == STEP for s in recording.spans)
    return self_seconds(recording.spans, name) / steps


def innermost(spans) -> List[Tuple[float, float, str]]:
    """Disjoint, sorted (begin, end, name) pieces of the time that the
    spans of one thread cover, each named by the innermost span open over
    it (spans of one thread nest)."""
    pieces = []
    stack: List[Tuple[float, str]] = []       # (end, name), innermost last
    cursor = 0.0
    for s in sorted(spans, key=lambda s: (s.begin, -s.end)):
        while stack and stack[-1][0] <= s.begin:
            end, name = stack.pop()
            pieces.append((cursor, end, name))
            cursor = end
        if stack:
            pieces.append((cursor, s.begin, stack[-1][1]))
        stack.append((s.end, s.name))
        cursor = s.begin
    while stack:
        end, name = stack.pop()
        pieces.append((cursor, end, name))
        cursor = end
    return [p for p in pieces if p[1] > p[0]]


def overlap(a: Iterable[Tuple[float, float]],
            b: Iterable[Tuple[float, float]]) -> float:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    a, b = list(a), list(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_percent(gaps, spans, names, anchor_us: float, anchor_host: float,
                 window_us: float) -> float:
    """Percent of ``window_us`` in which the device was idle (``gaps``, on
    the trace's clock) while the innermost of ``spans`` (one thread, on the
    host's clock) was one of ``names``; ``anchor_us`` on the trace's clock
    is ``anchor_host`` on the host's."""
    def to_trace(t):
        return anchor_us + (t - anchor_host) * 1e6

    inside = [(to_trace(b), to_trace(e)) for b, e, name in innermost(spans)
              if name in names]
    return 100.0 * overlap(sorted(gaps), inside) / window_us


def idle_share(run, recording, names) -> Optional[float]:
    """``idle_percent`` of a run's complete trace and the program spans
    of its main thread."""
    reading = complete_trace(run)
    if reading is None or reading['anchor_us'] is None \
            or not _whole(recording):
        return None
    spans = [s for s in recording.spans if s.thread == run._main]
    return idle_percent(reading['gaps'], spans, names, reading['anchor_us'],
                        run._anchor_host, reading['window_us'])


def fallback_share(recording) -> Optional[float]:
    """Percent of the samples that took the 2x-downscale tail or the
    gather route, of all that ``plan_warp`` routed."""
    if not _whole(recording):
        return None
    served = {r: recording.counters.get(f'plan_warp.samples.{r}', 0)
              for r in ROUTES}
    total = sum(served.values())
    if total <= 0:
        return None
    return 100.0 * (served['half'] + served['gather']) / total
