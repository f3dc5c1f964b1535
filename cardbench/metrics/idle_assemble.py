"""Percent of the traced window in which the device was idle while the
main thread assembled pages: its innermost program span was
``synth.assemble``."""
from cardbench import synth_spans


def read(run):
    return synth_spans.idle(run, ['synth.assemble'])
