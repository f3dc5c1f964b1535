"""Percent of the traced window in which the device was idle while the
host enqueued the warp's device work: the innermost program span was
``plan_warp.enqueue``."""
from cardbench import program_spans


def read(run):
    return program_spans.idle_share(run, program_spans.last_recording(),
                                    program_spans.ENQUEUE)
