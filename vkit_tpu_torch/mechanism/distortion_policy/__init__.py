from .type import (
    DistortionPolicy,
    DistortionPolicyFactory,
    policy_factory,
)
from .random_distortion import (
    RandomDistortion,
    RandomDistortionDebug,
    RandomDistortionFactory,
    RandomDistortionFactoryConfig,
    RandomDistortionStageConfig,
    random_distortion_factory,
)
from . import geometric, photometric
