"""PyTorch + CUDA port of vkit_tpu for NVIDIA Hopper GPUs.

The host layers (page prep, fonts and atlases, elements and geometry,
WarpPlan and the distortion policies, the warp planners, the native C++
geometry library) are the port's own copies of vkit_tpu's numpy / C++ code,
at the same relative paths, so both packages draw the same pages and plans
from the same seed.  The device layers run on torch tensors.  The package
imports neither jax nor vkit_tpu.
"""
