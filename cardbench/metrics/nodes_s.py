"""Seconds a step that ``batched_plan_warp`` spends building coarse node
maps (``_build_coarse_nodes``): the self time of its ``plan_warp.nodes``
spans over its ``plan_warp`` spans."""
from cardbench import program_spans


def read(run):
    return program_spans.per_step(program_spans.last_recording(),
                                  'plan_warp.nodes')
