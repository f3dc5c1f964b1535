"""Seconds a batch in the photometric stage: the ``synth.photometric``
spans."""
from cardbench import synth_spans


def read(run):
    return synth_spans.whole_per_batch(['synth.photometric'])
