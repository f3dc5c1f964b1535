"""Seconds a batch that the consumer of ``synthesize_stream`` waits for the
host's page prep (the prep thread's queue): its ``synth.prep_wait``
spans."""
from cardbench import synth_spans


def read(run):
    return synth_spans.whole_per_batch(['synth.prep_wait'])
