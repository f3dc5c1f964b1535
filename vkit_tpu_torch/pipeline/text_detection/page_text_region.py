"""The stacking background of the page text-region step.

Counterpart of vkit_tpu/pipeline/text_detection/page_text_region.py, of
which the text-region stream (synth/region.py) uses one function:
``build_background_image_for_stacking``.  The step itself (precise text
polygons, the flattener, KD-tree angle propagation) has no counterpart
here yet.
"""
import numpy as np

from ...element import Image


def build_background_image_for_stacking(height: int, width: int) -> Image:
    """RGB pinwheel pattern: row r, column c gets channel (r + c) % 3."""
    rows = np.arange(height)[:, None]
    cols = np.arange(width)[None, :]
    phase = (rows + cols) % 3
    np_image = np.zeros((height, width, 3), dtype=np.uint8)
    for channel in range(3):
        np_image[..., channel] = np.where(phase == channel, 255, 0)
    return Image(mat=np_image)
