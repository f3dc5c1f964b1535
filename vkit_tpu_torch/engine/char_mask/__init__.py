from ..interface import EngineExecutorAggregatorFactory
from .default import (
    CharMaskDefaultEngine,
    CharMaskDefaultEngineInitConfig,
    char_mask_default_engine_executor_factory,
)
from .external_ellipse import (
    CharMaskExternalEllipseEngine,
    CharMaskExternalEllipseEngineInitConfig,
    char_mask_external_ellipse_engine_executor_factory,
)
from .type import CharMask, CharMaskEngineRunConfig

char_mask_engine_executor_aggregator_factory = EngineExecutorAggregatorFactory([
    char_mask_default_engine_executor_factory,
    char_mask_external_ellipse_engine_executor_factory,
])
