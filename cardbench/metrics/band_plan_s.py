"""Seconds a step that ``batched_plan_warp`` spends in banded planning
(``plan_banded_warp``, the tail's re-plan included): the self time of its
``plan_warp.band_plan`` spans over its ``plan_warp`` spans."""
from cardbench import program_spans


def read(run):
    return program_spans.per_step(program_spans.last_recording(),
                                  'plan_warp.band_plan')
