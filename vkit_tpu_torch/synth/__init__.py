"""Batched page synthesis on the device."""
from .device import (
    CropConfig,
    SynthBatchResult,
    synthesize_page_batch,
    synthesize_stream,
)

__all__ = ['CropConfig', 'SynthBatchResult', 'synthesize_page_batch',
           'synthesize_stream']
