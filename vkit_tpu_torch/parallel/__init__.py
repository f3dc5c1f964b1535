"""Parallel layer: the one-program distortion chain and the prefetch pump.

Port of vkit_tpu/parallel: ``batch`` and ``prefetch``.  The reference's
device mesh (``mesh``) has no counterpart yet; it comes with the
multi-device work.
"""
from .batch import (
    SynthesisParams,
    sample_synthesis_params,
    synthesize_batch,
    transform_label_points,
)
from .prefetch import DevicePrefetcher, prefetch_map

__all__ = [
    'SynthesisParams',
    'sample_synthesis_params',
    'synthesize_batch',
    'transform_label_points',
    'DevicePrefetcher',
    'prefetch_map',
]
