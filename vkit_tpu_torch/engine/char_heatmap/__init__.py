from ..interface import EngineExecutorAggregatorFactory
from .default import (
    CharHeatmapDefaultEngine,
    CharHeatmapDefaultEngineInitConfig,
    char_heatmap_default_engine_executor_factory,
)
from .type import CharHeatmap, CharHeatmapEngineRunConfig

char_heatmap_engine_executor_aggregator_factory = EngineExecutorAggregatorFactory([
    char_heatmap_default_engine_executor_factory,
])
