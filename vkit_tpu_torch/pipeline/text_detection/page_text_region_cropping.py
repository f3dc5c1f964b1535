"""Text-region cropping step: crops of the stacked text-region page with the
regression labels filtered into each window.

Behavioral spec: vkit/pipeline/text_detection/page_text_region_cropping.py:
36-383 (re-derived; the shapely point STRtree is a vectorized point-in-box
filter over label coordinates).
"""
from typing import List, Optional, Sequence, Tuple

import attr
import numpy as np
from numpy.random import Generator as RandomGenerator

from ...element import Box, Image, Mask, ScoreMap
from ...mechanism.cropper import Cropper
from ...mechanism.distortion import rotate
from ..interface import PipelineStep, PipelineStepFactory
from .crop_common import DownsampleGeometry
from .page_cropping import PageCroppingStepOutput
from .page_text_region import PageTextRegionStepOutput
from .page_text_region_label import (
    PageCharRegressionLabel,
    PageCharRegressionLabelTag,
    PageTextRegionLabelStepOutput,
)


@attr.define
class PageTextRegionCroppingStepConfig:
    core_size: int
    pad_size: int
    num_samples_factor_relative_to_num_cropped_pages: float = 1.0
    num_centroid_points_min: int = 10
    num_deviate_points_min: int = 10
    pad_value: int = 0
    enable_downsample_labeling: bool = True
    downsample_labeling_factor: int = 2


@attr.define
class PageTextRegionCroppingStepInput:
    page_cropping_step_output: PageCroppingStepOutput
    page_text_region_step_output: PageTextRegionStepOutput
    page_text_region_label_step_output: PageTextRegionLabelStepOutput


@attr.define
class DownsampledLabel:
    shape: Tuple[int, int]
    page_char_mask: Mask
    page_char_height_score_map: ScoreMap
    page_char_gaussian_score_map: ScoreMap
    page_char_regression_labels: Sequence[PageCharRegressionLabel]
    page_char_bounding_box_mask: Mask
    target_core_box: Box


@attr.define
class CroppedPageTextRegion:
    page_image: Image
    page_char_mask: Mask
    page_char_height_score_map: ScoreMap
    page_char_gaussian_score_map: ScoreMap
    page_char_regression_labels: Sequence[PageCharRegressionLabel]
    page_char_bounding_box_mask: Mask
    target_core_box: Box
    downsampled_label: Optional[DownsampledLabel]


@attr.define
class PageTextRegionCroppingStepOutput:
    cropped_page_text_regions: Sequence[CroppedPageTextRegion]


class LabelPointIndex:
    """Vectorized point-in-box queries over regression label points."""

    def __init__(self, labels: Sequence[PageCharRegressionLabel]):
        self.labels = tuple(labels)
        self.np_points = np.asarray(
            [
                (label.downsampled_label_point_y, label.downsampled_label_point_x)
                for label in self.labels
            ],
            dtype=np.int64,
        ).reshape(-1, 2)

    def labels_in_box(self, box: Box) -> List[PageCharRegressionLabel]:
        if not self.labels:
            return []
        ys, xs = self.np_points[:, 0], self.np_points[:, 1]
        hit = (box.up <= ys) & (ys <= box.down) \
            & (box.left <= xs) & (xs <= box.right)
        return [self.labels[int(i)] for i in np.nonzero(hit)[0]]


class PageTextRegionCroppingStep(
    PipelineStep[PageTextRegionCroppingStepConfig, PageTextRegionCroppingStepInput, PageTextRegionCroppingStepOutput]
):

    def _propose_cropper(self, page_shape, shape_before_rotate,
                         rotate_angle: int, rng: RandomGenerator) -> Cropper:
        cfg = self.config
        if rotate_angle == 0:
            return Cropper.create_from_random_proposal(
                shape=page_shape, core_size=cfg.core_size,
                pad_size=cfg.pad_size, pad_value=cfg.pad_value, rng=rng,
            )
        # Propose in the pre-rotation frame, then carry the window center
        # through the rotation so crops stay well covered.
        proposal = Cropper.create_from_random_proposal(
            shape=shape_before_rotate, core_size=cfg.core_size,
            pad_size=cfg.pad_size, pad_value=cfg.pad_value, rng=rng,
        )
        spun = rotate.distort(
            {'angle': rotate_angle},
            shapable_or_shape=shape_before_rotate,
            point=proposal.original_box.get_center_point(),
        )
        assert spun.shape == page_shape and spun.point
        return Cropper.create_from_center_point(
            shape=page_shape, core_size=cfg.core_size,
            pad_size=cfg.pad_size, pad_value=cfg.pad_value,
            center_point=spun.point,
        )

    def _gather_window_labels(self, cropper: Cropper,
                              centroid_index: LabelPointIndex,
                              deviate_index: LabelPointIndex):
        centroids = centroid_index.labels_in_box(cropper.original_core_box)
        surviving_chars = {label.char_idx for label in centroids}
        deviates = [
            label for label in deviate_index.labels_in_box(cropper.original_core_box)
            # A deviate label is meaningless once its centroid is gone.
            if label.char_idx in surviving_chars
        ]
        return centroids, deviates

    def sample_cropped_page_text_regions(
        self,
        page_image: Image,
        shape_before_rotate: Tuple[int, int],
        rotate_angle: int,
        label_out: PageTextRegionLabelStepOutput,
        centroid_index: LabelPointIndex,
        deviate_index: LabelPointIndex,
        rng: RandomGenerator,
    ) -> Optional[CroppedPageTextRegion]:
        cfg = self.config
        cropper = self._propose_cropper(
            page_image.shape, shape_before_rotate, rotate_angle, rng
        )

        centroids, deviates = self._gather_window_labels(
            cropper, centroid_index, deviate_index
        )
        if len(centroids) < cfg.num_centroid_points_min \
                or len(deviates) < cfg.num_deviate_points_min:
            return None

        dy = cropper.target_box.up - cropper.original_box.up
        dx = cropper.target_box.left - cropper.original_box.left
        labels = [
            label.to_shifted_page_char_regression_label(offset_y=dy, offset_x=dx)
            for label in centroids + deviates
        ]

        page_image = cropper.crop_image(page_image)
        char_mask = cropper.crop_mask(label_out.page_char_mask, core_only=True)
        char_heights = cropper.crop_score_map(
            label_out.page_char_height_score_map, core_only=True
        )
        gaussian = cropper.crop_score_map(
            label_out.page_char_gaussian_score_map, core_only=True
        )
        bounding_mask = cropper.crop_mask(
            label_out.page_char_bounding_box_mask, core_only=True
        )

        downsampled = None
        if cfg.enable_downsample_labeling:
            geometry = DownsampleGeometry(
                cropper, cfg.core_size, cfg.pad_size,
                cfg.downsample_labeling_factor,
            )
            downsampled = DownsampledLabel(
                shape=geometry.shape,
                page_char_mask=geometry.shrink(char_mask),
                page_char_height_score_map=geometry.shrink(char_heights),
                page_char_gaussian_score_map=geometry.shrink(gaussian),
                page_char_regression_labels=[
                    label.to_downsampled_page_char_regression_label(geometry.factor)
                    for label in labels
                ],
                page_char_bounding_box_mask=geometry.shrink(bounding_mask),
                target_core_box=geometry.target_core_box,
            )

        return CroppedPageTextRegion(
            page_image=page_image,
            page_char_mask=char_mask,
            page_char_height_score_map=char_heights,
            page_char_gaussian_score_map=gaussian,
            page_char_regression_labels=labels,
            page_char_bounding_box_mask=bounding_mask,
            target_core_box=cropper.target_core_box,
            downsampled_label=downsampled,
        )

    def run(self, input: PageTextRegionCroppingStepInput, rng: RandomGenerator):
        region_out = input.page_text_region_step_output
        label_out = input.page_text_region_label_step_output

        by_tag = {
            tag: LabelPointIndex([
                label for label in label_out.page_char_regression_labels
                if label.tag == tag
            ])
            for tag in (PageCharRegressionLabelTag.CENTROID,
                        PageCharRegressionLabelTag.DEVIATE)
        }

        num_samples = round(
            self.config.num_samples_factor_relative_to_num_cropped_pages
            * len(input.page_cropping_step_output.cropped_pages)
        )
        crops: List[CroppedPageTextRegion] = []
        for _ in range(max(3, 2 * num_samples)):
            if len(crops) >= num_samples:
                break
            crop = self.sample_cropped_page_text_regions(
                page_image=region_out.page_image,
                shape_before_rotate=region_out.shape_before_rotate,
                rotate_angle=region_out.rotate_angle,
                label_out=label_out,
                centroid_index=by_tag[PageCharRegressionLabelTag.CENTROID],
                deviate_index=by_tag[PageCharRegressionLabelTag.DEVIATE],
                rng=rng,
            )
            if crop:
                crops.append(crop)

        return PageTextRegionCroppingStepOutput(cropped_page_text_regions=crops)


page_text_region_cropping_step_factory = PipelineStepFactory(PageTextRegionCroppingStep)
