"""The readers of the synthesis program's spans (``synth_spans.py``) on
synthetic spans and gaps."""
from types import SimpleNamespace
from typing import NamedTuple, Optional

import pytest

from cardbench import program_spans
from cardbench import synth_spans as S

MAIN, PREP = 7, 8


class Span(NamedTuple):
    name: str
    begin: float
    end: float
    span_id: int
    parent: Optional[int]
    request: int
    thread: int = MAIN


# Two batches on the host's clock (seconds).  The first waits 0.1 s for
# its pages, assembles for 0.5, warps (a plan_warp inside), then runs the
# region stream with a flatten part; the second only waits and assembles.
# The prep thread's span overlaps them.
BATCHES = [
    Span('synth.prep_wait', 10.0, 10.1, 1, None, 1),
    Span('synth.assemble', 10.1, 10.6, 2, None, 2),
    Span('synth.plan-host', 10.6, 10.65, 3, None, 3),
    Span('synth.warp', 10.65, 10.85, 4, None, 4),
    Span('plan_warp', 10.7, 10.8, 5, 4, 4),
    Span('synth.region', 10.9, 11.9, 6, None, 6),
    Span('synth.region.gather+flatten', 11.0, 11.4, 7, 6, 6),
    Span('synth.prep_wait', 12.0, 12.3, 8, None, 8),
    Span('synth.assemble', 12.3, 12.8, 9, None, 9),
    Span('synth.prep', 10.0, 12.2, 10, None, 10, PREP),
]


def recording(spans, dropped=0):
    return SimpleNamespace(spans=spans, counters={}, dropped=dropped)


@pytest.fixture
def recorded(monkeypatch):
    def use(spans, dropped=0):
        monkeypatch.setattr(program_spans, 'last_recording',
                            lambda: recording(spans, dropped))
    return use


def test_times_a_batch(recorded):
    recorded(BATCHES)
    assert S.whole_per_batch(['synth.prep_wait']) == pytest.approx(0.2)
    assert S.whole_per_batch(['synth.assemble']) == pytest.approx(0.5)
    # plan-host 0.05 and the whole warp 0.2, plan_warp in it.
    assert S.whole_per_batch(['synth.plan-host', 'synth.warp']) \
        == pytest.approx(0.125)
    # The region stream's 1.0 s less its flatten part's 0.4.
    assert S.self_per_batch('synth.region') == pytest.approx(0.3)


def test_a_program_without_synth_spans_reads_nothing(recorded):
    recorded([s for s in BATCHES if not s.name.startswith('synth.')])
    assert S.whole_per_batch(['synth.assemble']) is None
    assert S.self_per_batch('synth.region') is None
    assert S.idle(SimpleNamespace()) is None
    recorded(BATCHES, dropped=1)
    assert S.whole_per_batch(['synth.assemble']) is None


def test_idle_while_assembling_and_in_the_region_stream(recorded):
    recorded(BATCHES)
    # The trace's clock is the host's in microseconds from 10 s.
    reading = {'gaps': [(0.0, 1e6), (1.2e6, 1.6e6)], 'anchor_us': 0.0,
               'window_us': 4e6, 'missing': {}}
    run = SimpleNamespace(trace_reading=reading, _main=MAIN,
                          _anchor_host=10.0)
    # Idle 10.0-11.0: assembling 10.1-10.6; idle 11.2-11.6: the flatten
    # part 11.2-11.4 and the region stream's own 11.4-11.6.
    assert S.idle(run, ['synth.assemble']) == pytest.approx(100 * 0.5 / 4)
    assert S.idle(run) == pytest.approx(100 * (0.1 + 0.4) / 4)
