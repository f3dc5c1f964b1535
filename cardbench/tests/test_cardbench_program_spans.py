"""The readers of the program's spans and counters (``program_spans.py``)
on synthetic spans, gaps and counters."""
from types import SimpleNamespace
from typing import NamedTuple, Optional

import pytest

from cardbench import program_spans as P

MAIN = 7


class Span(NamedTuple):
    name: str
    begin: float
    end: float
    span_id: int
    parent: Optional[int]
    request: int
    thread: int = MAIN


def recording(spans, counters=None, dropped=0):
    return SimpleNamespace(spans=spans, counters=counters or {},
                           dropped=dropped)


# Two steps on the host's clock (seconds): each a plan_warp with route,
# nodes (holding an enqueue), band_plan and enqueue children.
STEPS = [
    Span('plan_warp', 10.0, 10.1, 1, None, 1),
    Span('plan_warp.route', 10.0, 10.01, 2, 1, 1),
    Span('plan_warp.nodes', 10.01, 10.05, 3, 1, 1),
    Span('plan_warp.enqueue', 10.02, 10.03, 4, 3, 1),
    Span('plan_warp.band_plan', 10.05, 10.07, 5, 1, 1),
    Span('plan_warp.enqueue', 10.07, 10.09, 6, 1, 1),
    Span('plan_warp', 11.0, 11.1, 7, None, 7),
    Span('plan_warp.nodes', 11.0, 11.06, 8, 7, 7),
    Span('plan_warp.enqueue', 11.06, 11.1, 9, 7, 7),
]


def test_self_time_per_step():
    rec = recording(STEPS)
    # nodes: 0.04 - 0.01 (its enqueue child) + 0.06, over two steps.
    assert P.per_step(rec, 'plan_warp.nodes') == pytest.approx(0.045)
    assert P.per_step(rec, 'plan_warp.enqueue') == pytest.approx(0.035)
    assert P.per_step(rec, 'plan_warp.route') == pytest.approx(0.005)
    # plan_warp's own remainder: 0.01 of the first step, none of the
    # second.
    assert P.per_step(rec, 'plan_warp') == pytest.approx(0.005)
    assert P.per_step(rec, 'plan_warp.missing') == 0.0


def test_innermost_span_names_each_piece():
    pieces = P.innermost(STEPS[:6])
    assert [(round(b, 3), round(e, 3), n) for b, e, n in pieces] == [
        (10.0, 10.01, 'plan_warp.route'),
        (10.01, 10.02, 'plan_warp.nodes'),
        (10.02, 10.03, 'plan_warp.enqueue'),
        (10.03, 10.05, 'plan_warp.nodes'),
        (10.05, 10.07, 'plan_warp.band_plan'),
        (10.07, 10.09, 'plan_warp.enqueue'),
        (10.09, 10.1, 'plan_warp'),
    ]


def test_overlap_of_sorted_intervals():
    assert P.overlap([(0, 2), (5, 9)], [(1, 6), (8, 20)]) == 1 + 1 + 1
    assert P.overlap([], [(0, 1)]) == 0


def run_with(gaps, anchor_us=1000.0, anchor_host=9.0, missing=None,
             window_us=3e6):
    reading = {'gaps': gaps, 'anchor_us': anchor_us, 'window_us': window_us,
               'missing': missing or {}}
    return SimpleNamespace(trace_reading=reading, _main=MAIN,
                           _anchor_host=anchor_host)


def to_trace(t, anchor_us=1000.0, anchor_host=9.0):
    return anchor_us + (t - anchor_host) * 1e6


def test_idle_share_maps_by_the_anchor_and_takes_the_innermost_span():
    # Idle over the whole first step and over 11.05-11.08 of the second.
    gaps = [(to_trace(10.0), to_trace(10.1)),
            (to_trace(11.05), to_trace(11.08))]
    rec = recording(STEPS)
    run = run_with(gaps)
    planning = P.idle_share(run, rec, P.PLANNING)
    enqueue = P.idle_share(run, rec, P.ENQUEUE)
    # Planning: route 0.01 + nodes 0.03 + band_plan 0.02 + nodes 0.01.
    assert planning == pytest.approx(100 * 0.07e6 / 3e6)
    # Enqueue: 0.01 (inside nodes) + 0.02 + 0.02 of the second step.
    assert enqueue == pytest.approx(100 * 0.05e6 / 3e6)
    busy_gaps = sum(e - b for b, e in gaps)
    assert planning + enqueue <= 100 * busy_gaps / 3e6


def test_idle_share_moves_with_the_anchor():
    gaps = [(to_trace(10.0), to_trace(10.01))]       # the first route span
    rec = recording(STEPS)
    assert P.idle_share(run_with(gaps), rec, P.PLANNING) == pytest.approx(
        100 * 1e4 / 3e6)
    # With the anchor 0.05 s later on the host's clock the gap falls in
    # the first step's band_plan; 1 s earlier, outside every span.
    late = run_with(gaps, anchor_host=9.05)
    assert P.idle_share(late, rec, P.PLANNING) == pytest.approx(
        100 * 1e4 / 3e6)
    assert P.idle_share(late, rec, P.ENQUEUE) == 0.0
    assert P.idle_share(run_with(gaps, anchor_host=8.0), rec,
                        P.PLANNING) == 0.0


def test_spans_of_other_threads_are_left_out():
    other = [s._replace(thread=MAIN + 1) for s in STEPS]
    gaps = [(to_trace(10.0), to_trace(10.1))]
    assert P.idle_share(run_with(gaps), recording(STEPS + other),
                        P.PLANNING) == pytest.approx(100 * 0.06e6 / 3e6)


def test_fallback_share_of_the_route_counters():
    counters = {'plan_warp.samples.affine': 2, 'plan_warp.samples.banded': 5,
                'plan_warp.samples.half': 2, 'plan_warp.samples.gather': 1}
    assert P.fallback_share(recording(STEPS, counters)) == pytest.approx(30)
    assert P.fallback_share(recording(STEPS, {})) is None


def test_nothing_to_read_gives_none(monkeypatch):
    gaps = [(to_trace(10.0), to_trace(10.1))]
    assert P.per_step(None, 'plan_warp.nodes') is None
    assert P.idle_share(run_with(gaps), None, P.PLANNING) is None
    assert P.fallback_share(None) is None
    # A recording without a step, or one that dropped spans.
    assert P.per_step(recording(STEPS[1:6]), 'plan_warp.nodes') is None
    assert P.per_step(recording(STEPS, dropped=3), 'plan_warp.nodes') is None
    # A program without the recording at all (an older commit).
    from vkit_tpu_torch.utility import profiling

    monkeypatch.delattr(profiling, 'last_recording', raising=False)
    assert P.last_recording() is None


def test_an_incomplete_trace_gives_none():
    gaps = [(to_trace(10.0), to_trace(10.1))]
    rec = recording(STEPS)
    run = run_with(gaps, missing={'cudaLaunchKernel': 2})
    assert P.idle_share(run, rec, P.PLANNING) is None
    assert P.idle_share(run_with(gaps, anchor_us=None), rec,
                        P.ENQUEUE) is None
    run.trace_reading = None
    assert P.idle_share(run, rec, P.PLANNING) is None
