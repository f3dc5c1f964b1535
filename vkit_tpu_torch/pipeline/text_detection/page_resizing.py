"""Page resizing step: scale the page so the smallest (outlier-filtered)
text-line height lands in a target pixel range.

Behavioral spec: vkit/pipeline/text_detection/page_resizing.py:29-193.
"""
import logging
from typing import Sequence

import attr
import numpy as np
from numpy.random import Generator as RandomGenerator

from ...element import Image, Mask, ScoreMap
from ...utility import sample_resize_interpolation
from ..interface import PipelineStep, PipelineStepFactory
from .page_distortion import PageDistortionStepOutput

logger = logging.getLogger(__name__)


@attr.define
class PageResizingStepConfig:
    resized_text_line_height_min: float = 3.0
    resized_text_line_height_max: float = 10.0
    text_line_heights_filtering_thr: float = 1.0


@attr.define
class PageResizingStepInput:
    page_distortion_step_output: PageDistortionStepOutput


@attr.define
class PageResizingStepOutput:
    page_image: Image
    page_active_mask: Mask
    page_char_mask: Mask
    page_seal_impression_char_mask: Mask
    page_char_height_score_map: ScoreMap
    page_text_line_mask: Mask
    page_text_line_height_score_map: ScoreMap


def robust_min_height(heights: Sequence[float], noise_floor: float) -> float:
    """Smallest height surviving modified-z-score (MAD) outlier rejection."""
    kept = np.asarray([h for h in heights if h > noise_floor])
    assert kept.size
    deviation = np.abs(kept - np.median(kept))
    scale = np.median(deviation) or 1.0
    inliers = kept[deviation / scale < 3.5]
    return float(inliers.min())


class PageResizingStep(
    PipelineStep[PageResizingStepConfig, PageResizingStepInput, PageResizingStepOutput]
):

    def run(self, input: PageResizingStepInput, rng: RandomGenerator):
        src = input.page_distortion_step_output
        assert src.page_char_mask and src.page_seal_impression_char_mask
        assert src.page_char_height_score_map and src.page_text_line_mask
        assert src.page_text_line_height_score_map and src.page_text_line_heights

        floor = robust_min_height(
            src.page_text_line_heights, self.config.text_line_heights_filtering_thr
        )
        target = rng.uniform(self.config.resized_text_line_height_min,
                             self.config.resized_text_line_height_max)
        ratio = target / floor
        logger.debug(f'min text line height {floor:.2f}, resize ratio {ratio:.3f}')

        height, width = src.page_image.shape
        rh, rw = round(ratio * height), round(ratio * width)
        interpolation = sample_resize_interpolation(rng, include_area=(ratio < 1.0))

        def resize(raster):
            if isinstance(raster, Image):
                return raster.to_resized_image(rh, rw, interpolation)
            if isinstance(raster, Mask):
                return raster.to_resized_mask(rh, rw, interpolation)
            return raster.to_resized_score_map(rh, rw, interpolation)

        def resize_heights(score_map: ScoreMap) -> ScoreMap:
            # Height values shrink/grow with the canvas.
            out = resize(score_map)
            out.assign_mat(out.mat * ratio)
            return out

        return PageResizingStepOutput(
            page_image=resize(src.page_image),
            page_active_mask=resize(src.page_active_mask),
            page_char_mask=resize(src.page_char_mask),
            page_seal_impression_char_mask=resize(src.page_seal_impression_char_mask),
            page_char_height_score_map=resize_heights(src.page_char_height_score_map),
            page_text_line_mask=resize(src.page_text_line_mask),
            page_text_line_height_score_map=resize_heights(
                src.page_text_line_height_score_map
            ),
        )


page_resizing_step_factory = PipelineStepFactory(PageResizingStep)
