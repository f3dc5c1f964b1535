"""Seconds a batch in page assembly (glyphs, then the above-text layers):
the ``synth.assemble`` spans."""
from cardbench import synth_spans


def read(run):
    return synth_spans.whole_per_batch(['synth.assemble'])
