"""Batched page synthesis: host page prep, then the device program."""
from .device import (
    CropConfig,
    SynthBatchResult,
    synthesize_page_batch,
    synthesize_stream,
)
from .prep import HostPage, SynthPlanner, SynthPlannerConfig
from .region import (
    CharRegression,
    RegionBatchResult,
    RegionStreamConfig,
    stack_text_regions,
)

__all__ = ['CharRegression', 'CropConfig', 'HostPage', 'RegionBatchResult',
           'RegionStreamConfig', 'SynthBatchResult', 'SynthPlanner',
           'SynthPlannerConfig', 'stack_text_regions',
           'synthesize_page_batch', 'synthesize_stream']
