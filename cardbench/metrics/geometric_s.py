"""Seconds a batch in the geometric stage: the ``synth.plan-host`` and
``synth.warp`` spans, whole (``batched_plan_warp``'s own spans run inside
``synth.warp``)."""
from cardbench import synth_spans


def read(run):
    return synth_spans.whole_per_batch(['synth.plan-host', 'synth.warp'])
