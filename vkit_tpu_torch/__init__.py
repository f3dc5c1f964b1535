"""PyTorch + CUDA port of vkit_tpu for NVIDIA Hopper GPUs.

The port reuses vkit_tpu's numpy host layers (page prep, fonts and atlases,
WarpPlan and the geometric policies, the warp planners), whose packages
load jax as they are imported.  jax is pinned to the CPU here, before
anything imports vkit_tpu, so a CUDA build of jax never claims GPU memory:
``JAX_PLATFORMS`` is set to ``cpu`` even where the environment names a GPU
platform (a CUDA jax preallocates most of the card on first use).  A
process that imported jax before this package keeps its own setting.  No
module of this package imports jax itself.
"""
import os
import sys

from ._host_deps import ensure_sklearn_importable

if 'jax' not in sys.modules:
    os.environ['JAX_PLATFORMS'] = 'cpu'
ensure_sklearn_importable()
