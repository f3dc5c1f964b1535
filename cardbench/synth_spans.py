"""Readings of the synthesis program's spans (``synth.*``,
``vkit_tpu_torch/synth/device.py``) in the recording of a ``--trace 1``
run's profiled half, as ``program_spans`` reads ``batched_plan_warp``'s.
A batch is one ``synth.assemble`` span; a program without these spans (a
commit before them) or a recording without a batch gives None."""
from typing import Iterable, Optional

from cardbench import program_spans

BATCH = 'synth.assemble'
REGION = 'synth.region'


def recording():
    """The program's last recording where it holds every span and at
    least one batch, else None."""
    rec = program_spans.last_recording()
    if rec is None or rec.dropped \
            or not any(s.name == BATCH for s in rec.spans):
        return None
    return rec


def _batches(rec) -> int:
    return sum(s.name == BATCH for s in rec.spans)


def whole_per_batch(names: Iterable[str]) -> Optional[float]:
    """Seconds a batch in the spans named ``names``, each span whole (its
    children in it)."""
    rec = recording()
    if rec is None:
        return None
    names = set(names)
    return sum(s.end - s.begin for s in rec.spans
               if s.name in names) / _batches(rec)


def self_per_batch(name: str) -> Optional[float]:
    """Self seconds a batch of the spans named ``name``: each one's
    duration less its direct children's."""
    rec = recording()
    if rec is None:
        return None
    return program_spans.self_seconds(rec.spans, name) / _batches(rec)


def region_names(rec) -> set:
    """``synth.region`` and the names of its parts in ``rec``."""
    return {s.name for s in rec.spans
            if s.name == REGION or s.name.startswith(REGION + '.')}


def idle(run, names=None) -> Optional[float]:
    """Percent of the profiled window with the device idle while the main
    thread's innermost program span was one of ``names`` (None: the
    region stream and its parts)."""
    rec = recording()
    if rec is None:
        return None
    return program_spans.idle_share(
        run, rec, region_names(rec) if names is None else set(names))
