"""Seconds a batch in the text-region stream outside its spanned parts
(collect, gather and flatten, composite, gaussians, regression): the self
time of the ``synth.region`` spans, the stream's host loops."""
from cardbench import synth_spans


def read(run):
    return synth_spans.self_per_batch('synth.region')
