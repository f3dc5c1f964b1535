"""Shared crop/downsample geometry for the two cropping steps."""
from typing import Tuple

from ...element import Box, Interpolation, Mask, ScoreMap
from ...mechanism.cropper import Cropper


class DownsampleGeometry:
    """Downsampled crop frame: core box + canvas shape at 1/factor scale."""

    def __init__(self, cropper: Cropper, core_size: int, pad_size: int,
                 factor: int):
        assert cropper.crop_size % factor == 0
        assert pad_size % factor == 0 and core_size % factor == 0
        assert cropper.target_core_box.shape == (core_size, core_size)
        self.factor = factor
        self.core_size = core_size // factor
        pad = pad_size // factor
        self.shape: Tuple[int, int] = (cropper.crop_size // factor,) * 2
        self.target_core_box = Box(pad, pad + self.core_size - 1,
                                   pad, pad + self.core_size - 1)

    def shrink(self, raster):
        """AREA-downsample a core-attached raster to the reduced core."""
        detached = raster.to_box_detached()
        if isinstance(raster, Mask):
            return detached.to_resized_mask(
                self.core_size, self.core_size, Interpolation.AREA
            )
        assert isinstance(raster, ScoreMap)
        return detached.to_resized_score_map(
            self.core_size, self.core_size, Interpolation.AREA
        )
