"""The host layers the port shares with vkit_tpu, in one place.

Page prep (``SynthPlanner``), warp plans, the distortion policies and their
samplers, the stage timer, and the native C++ geometry library are numpy
/ C++ host code that both packages run unchanged; the port's device modules
import them from vkit_tpu directly.  Scripts that drive the port
(chip_smoke.py) take them from here.
"""
from vkit_tpu.mechanism.batched_random import (  # noqa: F401
    _static_signature as static_signature,
)
from vkit_tpu.mechanism.batched_random import (  # noqa: F401
    sample_geometric_plans,
)
from vkit_tpu.mechanism.distortion.warp_plan import (  # noqa: F401
    WarpPlan,
    matrix_plan,
    plan_content_box,
    rescale_plan_to,
    warp_active_mask,
)
from vkit_tpu.mechanism.distortion_policy.random_distortion import (  # noqa: F401
    random_distortion_factory,
)
from vkit_tpu.synth.prep import (  # noqa: F401
    HostPage,
    SynthPlanner,
    SynthPlannerConfig,
)
from vkit_tpu.utility.profiling import StepTimer  # noqa: F401


def native_geometry_loaded() -> bool:
    """Whether vkit_tpu's C++ geometry library built and loaded (the host
    planners fall back to numpy without it)."""
    from vkit_tpu.native import load_library

    return load_library() is not None
