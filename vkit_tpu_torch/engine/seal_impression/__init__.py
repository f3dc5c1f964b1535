from ..interface import EngineExecutorAggregatorFactory
from .ellipse import (
    SealImpressionEllipseEngine,
    SealImpressionEllipseEngineInitConfig,
    seal_impression_ellipse_engine_executor_factory,
)
from .text_line_slot_filler import fill_text_line_to_seal_impression
from .type import (
    CharSlot,
    SealImpression,
    SealImpressionEngineRunConfig,
    TextLineSlot,
)

seal_impression_engine_executor_aggregator_factory = EngineExecutorAggregatorFactory([
    seal_impression_ellipse_engine_executor_factory,
])
