"""Pipeline layer: the step interface and the text-detection steps that the
host page planner (synth/prep.py) runs.

Counterpart of vkit_tpu/pipeline, trimmed to those steps: the registry and
the process pool stay with the reference.
"""
