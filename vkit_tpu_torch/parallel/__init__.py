"""Parallel layer: the one-program distortion chain, the prefetch pump,
and the device mesh with its sharding helpers.

Port of vkit_tpu/parallel: ``batch``, ``prefetch`` and ``mesh``; ``layers``
holds the collectives that XLA would insert into the reference's sharded
program.
"""
from .batch import (
    SynthesisParams,
    sample_synthesis_params,
    synthesize_batch,
    transform_label_points,
)
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    SPATIAL_AXIS,
    Mesh,
    Sharding,
    batch_sharding,
    data_sharding,
    factor_devices,
    gather,
    initialize_distributed,
    make_mesh,
    make_multihost_mesh,
    put,
    replicated,
    shard_params_for_tp,
)
from .prefetch import DevicePrefetcher, prefetch_map

__all__ = [
    'SynthesisParams',
    'sample_synthesis_params',
    'synthesize_batch',
    'transform_label_points',
    'DevicePrefetcher',
    'prefetch_map',
    'DATA_AXIS',
    'MODEL_AXIS',
    'SPATIAL_AXIS',
    'Mesh',
    'Sharding',
    'batch_sharding',
    'data_sharding',
    'factor_devices',
    'gather',
    'initialize_distributed',
    'make_mesh',
    'make_multihost_mesh',
    'put',
    'replicated',
    'shard_params_for_tp',
]
