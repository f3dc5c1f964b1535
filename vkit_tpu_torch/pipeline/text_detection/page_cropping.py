"""Page cropping step: one centered crop plus random crops, filtered by
text/active coverage, with an optional downsampled label set.

Behavioral spec: vkit/pipeline/text_detection/page_cropping.py:27-290.
"""
from typing import List, Optional, Sequence, Tuple

import attr
import numpy as np
from numpy.random import Generator as RandomGenerator

from ...element import Box, Image, Mask, ScoreMap
from ...mechanism.cropper import Cropper
from ..interface import PipelineStep, PipelineStepFactory
from .crop_common import DownsampleGeometry
from .page_resizing import PageResizingStepOutput


@attr.define
class PageCroppingStepConfig:
    core_size: int
    pad_size: int
    num_samples: Optional[int] = None
    num_samples_max: Optional[int] = None
    num_samples_estimation_factor: float = 1.5
    pad_value: int = 0
    drop_cropped_page_with_small_text_ratio: bool = True
    text_ratio_min: float = 0.025
    drop_cropped_page_with_small_active_region: bool = True
    active_region_ratio_min: float = 0.4
    enable_downsample_labeling: bool = True
    downsample_labeling_factor: int = 2


@attr.define
class PageCroppingStepInput:
    page_resizing_step_output: PageResizingStepOutput


@attr.define
class DownsampledLabel:
    shape: Tuple[int, int]
    page_char_mask: Mask
    page_seal_impression_char_mask: Mask
    page_char_height_score_map: ScoreMap
    page_text_line_mask: Mask
    page_text_line_height_score_map: ScoreMap
    target_core_box: Box


@attr.define
class CroppedPage:
    page_image: Image
    page_char_mask: Mask
    page_seal_impression_char_mask: Mask
    page_char_height_score_map: ScoreMap
    page_text_line_mask: Mask
    page_text_line_height_score_map: ScoreMap
    target_core_box: Box
    downsampled_label: Optional[DownsampledLabel]


@attr.define
class PageCroppingStepOutput:
    cropped_pages: Sequence[CroppedPage]


class PageCroppingStep(
    PipelineStep[PageCroppingStepConfig, PageCroppingStepInput, PageCroppingStepOutput]
):

    def _make_cropper(self, shape, rng: RandomGenerator, centered: bool) -> Cropper:
        cfg = self.config
        if centered:
            return Cropper.create_from_center_point(
                shape=shape,
                core_size=cfg.core_size,
                pad_size=cfg.pad_size,
                pad_value=cfg.pad_value,
                center_point=Box.from_shape(shape).get_center_point(),
            )
        return Cropper.create_from_random_proposal(
            shape=shape,
            core_size=cfg.core_size,
            pad_size=cfg.pad_size,
            pad_value=cfg.pad_value,
            rng=rng,
        )

    def _passes_filters(self, cropper: Cropper, char_mask: Mask,
                        active_mask: Mask, crop_area: int) -> bool:
        cfg = self.config
        if cfg.drop_cropped_page_with_small_text_ratio:
            text_pixels = int((char_mask.mat > 0).sum())
            if text_pixels / cropper.target_core_box.area < cfg.text_ratio_min:
                return False
        if cfg.drop_cropped_page_with_small_active_region:
            active_pixels = int(active_mask.np_mask.sum())
            if active_pixels / crop_area < cfg.active_region_ratio_min:
                return False
        return True

    def _downsample(self, cropper: Cropper, char_mask, seal_mask,
                    char_heights, line_mask, line_heights) -> DownsampledLabel:
        cfg = self.config
        geometry = DownsampleGeometry(
            cropper, cfg.core_size, cfg.pad_size, cfg.downsample_labeling_factor
        )
        return DownsampledLabel(
            shape=geometry.shape,
            page_char_mask=geometry.shrink(char_mask),
            page_seal_impression_char_mask=geometry.shrink(seal_mask),
            page_char_height_score_map=geometry.shrink(char_heights),
            page_text_line_mask=geometry.shrink(line_mask),
            page_text_line_height_score_map=geometry.shrink(line_heights),
            target_core_box=geometry.target_core_box,
        )

    def sample_cropped_page(self, src: PageResizingStepOutput,
                            rng: RandomGenerator,
                            force_crop_center: bool = False
                            ) -> Optional[CroppedPage]:
        cropper = self._make_cropper(src.page_image.shape, rng, force_crop_center)

        page_image = cropper.crop_image(src.page_image)
        active_mask = cropper.crop_mask(src.page_active_mask)
        char_mask = cropper.crop_mask(src.page_char_mask, core_only=True)
        seal_mask = cropper.crop_mask(
            src.page_seal_impression_char_mask, core_only=True
        )
        char_heights = cropper.crop_score_map(
            src.page_char_height_score_map, core_only=True
        )
        line_mask = cropper.crop_mask(src.page_text_line_mask, core_only=True)
        line_heights = cropper.crop_score_map(
            src.page_text_line_height_score_map, core_only=True
        )

        if not self._passes_filters(cropper, char_mask, active_mask, page_image.area):
            return None

        downsampled = None
        if self.config.enable_downsample_labeling:
            downsampled = self._downsample(
                cropper, char_mask, seal_mask, char_heights, line_mask, line_heights
            )

        return CroppedPage(
            page_image=page_image,
            page_char_mask=char_mask,
            page_seal_impression_char_mask=seal_mask,
            page_char_height_score_map=char_heights,
            page_text_line_mask=line_mask,
            page_text_line_height_score_map=line_heights,
            target_core_box=cropper.target_core_box,
            downsampled_label=downsampled,
        )

    def _estimate_num_samples(self, page_image: Image) -> int:
        cfg = self.config
        count = cfg.num_samples
        if count is None:
            lit_area = int((page_image.mat.max(axis=2) > 0).sum())
            count = max(1, round(
                lit_area / cfg.core_size**2 * cfg.num_samples_estimation_factor
            ))
        if cfg.num_samples_max:
            count = min(count, cfg.num_samples_max)
        return count

    def run(self, input: PageCroppingStepInput, rng: RandomGenerator):
        src = input.page_resizing_step_output
        num_samples = self._estimate_num_samples(src.page_image)

        cropped_pages: List[CroppedPage] = []
        attempts_max = max(3, 2 * num_samples)
        for attempt in range(attempts_max):
            if len(cropped_pages) >= num_samples:
                break
            page = self.sample_cropped_page(
                src, rng, force_crop_center=(attempt == 0)
            )
            if page:
                cropped_pages.append(page)

        return PageCroppingStepOutput(cropped_pages=cropped_pages)


page_cropping_step_factory = PipelineStepFactory(PageCroppingStep)
