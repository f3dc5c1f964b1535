"""Batched page synthesis: host page prep, then the device program."""
from .device import (
    CropConfig,
    SynthBatchResult,
    synthesize_page_batch,
    synthesize_stream,
)
from .prep import HostPage, SynthPlanner, SynthPlannerConfig

__all__ = ['CropConfig', 'HostPage', 'SynthBatchResult', 'SynthPlanner',
           'SynthPlannerConfig', 'synthesize_page_batch', 'synthesize_stream']
