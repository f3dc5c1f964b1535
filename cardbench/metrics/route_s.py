"""Seconds a step that ``batched_plan_warp`` spends routing samples and
planning the affine route: the self time of its ``plan_warp.route`` spans
over its ``plan_warp`` spans."""
from cardbench import program_spans


def read(run):
    return program_spans.per_step(program_spans.last_recording(),
                                  'plan_warp.route')
