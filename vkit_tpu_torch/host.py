"""The port's host layers, in one place.

Page prep (``SynthPlanner``), warp plans, the distortion policies and their
samplers, the stage timer, and the native C++ geometry library are numpy /
C++ host code, the port's own copies of vkit_tpu's.  Scripts that drive the
port (chip_smoke.py) take them from here.
"""
from .mechanism.batched_random import (  # noqa: F401
    _static_signature as static_signature,
)
from .mechanism.batched_random import sample_geometric_plans  # noqa: F401
from .mechanism.distortion.warp_plan import (  # noqa: F401
    WarpPlan,
    matrix_plan,
    plan_content_box,
    rescale_plan_to,
    warp_active_mask,
)
from .mechanism.distortion_policy.random_distortion import (  # noqa: F401
    random_distortion_factory,
)
from .synth.prep import (  # noqa: F401
    HostPage,
    SynthPlanner,
    SynthPlannerConfig,
)
from .utility.profiling import StepTimer  # noqa: F401


def native_geometry_loaded() -> bool:
    """Whether the port's C++ geometry library built and loaded (the host
    planners fall back to numpy without it)."""
    from .native import load_library

    return load_library() is not None
