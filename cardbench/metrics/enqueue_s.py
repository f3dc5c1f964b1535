"""Seconds a step that ``batched_plan_warp`` spends issuing device work
(uploads, sub-batch gathers, warps, scatters, casts): the self time of
its ``plan_warp.enqueue`` spans over its ``plan_warp`` spans."""
from cardbench import program_spans


def read(run):
    return program_spans.per_step(program_spans.last_recording(),
                                  'plan_warp.enqueue')
