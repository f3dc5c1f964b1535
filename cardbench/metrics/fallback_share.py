"""Percent of the samples that ``batched_plan_warp`` sent to the
2x-downscale tail or the gather route: its route counters."""
from cardbench import program_spans


def read(run):
    return program_spans.fallback_share(program_spans.last_recording())
