"""Percent of the traced window in which the device was idle while the
main thread ran the text-region stream: its innermost program span was
``synth.region`` or one of its parts."""
from cardbench import synth_spans


def read(run):
    return synth_spans.idle(run)
