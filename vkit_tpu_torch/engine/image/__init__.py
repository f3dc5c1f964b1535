from ..interface import EngineExecutorAggregatorFactory
from .combiner import (
    ImageCombinerEngine,
    ImageCombinerEngineInitConfig,
    image_combiner_engine_executor_factory,
)
from .selector import (
    ImageSelectorEngine,
    ImageSelectorEngineInitConfig,
    image_selector_engine_executor_factory,
)
from .type import ImageEngineRunConfig

image_engine_executor_aggregator_factory = EngineExecutorAggregatorFactory([
    image_combiner_engine_executor_factory,
    image_selector_engine_executor_factory,
])
