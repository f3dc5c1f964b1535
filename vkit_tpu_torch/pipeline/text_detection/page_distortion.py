"""Page distortion step: one RandomDistortion pass co-transforms the page
image with every label (polygons + height points), then the raster labels
(masks, height score maps) regenerate in the distorted frame.

Behavioral spec: vkit/pipeline/text_detection/page_distortion.py:52-484
(re-derived; label groups travel through the distortion as one named
bundle, and height-map painting is shared between chars and text lines).
"""
from typing import (
    Any,
    Dict,
    List,
    Mapping,
    Optional,
    Sequence,
    Union,
)

import attr
import numpy as np
from numpy.random import Generator as RandomGenerator

from ...element import Image, Mask, PointList, Polygon, ScoreMap
from ...engine.char_mask import (
    CharMaskEngineRunConfig,
    char_mask_engine_executor_aggregator_factory,
)
from ...mechanism.distortion_policy import (
    RandomDistortionDebug,
    random_distortion_factory,
)
from ...mechanism.painter import Painter
from ...utility import PathType
from ..interface import PipelineStep, PipelineStepFactory
from .page_assembler import (
    PageAssemblerStepOutput,
    PageDisconnectedTextRegionCollection,
    PageNonTextRegionCollection,
    PageSealImpressionCharPolygonCollection,
)
from .page_layout import DisconnectedTextRegion, NonTextRegion
from .page_text_line_label import (
    PageCharPolygonCollection,
    PageTextLinePolygonCollection,
)


@attr.define
class PageDistortionStepConfig:
    random_distortion_factory_config: Optional[
        Union[Mapping[str, Any], PathType]
    ] = attr.field(
        factory=lambda: {
            # defocus/zoom-in blur spread ink across label boundaries.
            'disabled_policy_names': ['defocus_blur', 'zoom_in_blur'],
        }
    )
    enable_debug_random_distortion: bool = False
    enable_distorted_char_mask: bool = True
    enable_distorted_seal_impression_char_mask: bool = True
    char_mask_engine_config: Mapping[str, Any] = attr.field(
        factory=lambda: {'type': 'default'}
    )
    enable_distorted_char_height_score_map: bool = True
    enable_debug_distorted_char_heights: bool = False
    enable_distorted_text_line_mask: bool = True
    enable_distorted_text_line_height_score_map: bool = True
    enable_debug_distorted_text_line_heights: bool = False


@attr.define
class PageDistortionStepInput:
    page_assembler_step_output: PageAssemblerStepOutput


@attr.define
class PageDistortionStepOutput:
    page_image: Image
    page_random_distortion_debug: Optional[RandomDistortionDebug]
    page_active_mask: Mask
    page_char_polygon_collection: PageCharPolygonCollection
    page_char_mask: Optional[Mask]
    page_seal_impression_char_mask: Optional[Mask]
    page_char_height_score_map: Optional[ScoreMap]
    page_char_heights: Optional[Sequence[float]]
    page_char_heights_debug_image: Optional[Image]
    page_text_line_polygon_collection: PageTextLinePolygonCollection
    page_text_line_mask: Optional[Mask]
    page_text_line_height_score_map: Optional[ScoreMap]
    page_text_line_heights: Optional[Sequence[float]]
    page_text_line_heights_debug_image: Optional[Image]
    page_disconnected_text_region_collection: PageDisconnectedTextRegionCollection
    page_non_text_region_collection: PageNonTextRegionCollection
    page_seal_impression_char_polygon_collection: PageSealImpressionCharPolygonCollection


class NamedGroups:
    """Named element groups that flatten to one sequence and restore by name.

    One distortion call then co-transforms every label kind at once.
    """

    def __init__(self, groups: Mapping[str, Sequence]):
        self.names = list(groups)
        self.sizes = [len(groups[name]) for name in self.names]
        self.flattened = [
            element for name in self.names for element in groups[name]
        ]

    def restore(self, transformed: Sequence) -> Dict[str, List]:
        assert len(transformed) == sum(self.sizes)
        out: Dict[str, List] = {}
        cursor = 0
        for name, size in zip(self.names, self.sizes):
            out[name] = list(transformed[cursor:cursor + size])
            cursor += size
        return out


def _segment_lengths(ups: PointList, downs: PointList) -> np.ndarray:
    """Per-pair distance + 1 — the height measure used for both labels."""
    np_up = ups.to_smooth_np_array()
    np_down = downs.to_smooth_np_array()
    return np.linalg.norm(np_down - np_up, axis=1) + 1


def _heights_debug_image(image: Image, polygons: Sequence[Polygon],
                         heights: Sequence[float]) -> Image:
    painter = Painter.create(image)
    painter.paint_polygons(polygons)
    painter.paint_texts(
        [f'{height:.1f}' for height in heights],
        PointList(polygon.get_center_point() for polygon in polygons),
        alpha=1.0,
    )
    return painter.image


def _edge_zeroed_active_mask(image: Image) -> Mask:
    """All-ones active mask with a zeroed 1-px border.

    The reference does this to dodge a cv.remap border artifact; our warp
    kernel is border-exact but the semantics (losing the 1-px border from
    the active region) are preserved.
    """
    active = Mask.from_shapable(image, value=1)
    with active.writable_context:
        active.mat[[0, -1]] = 0
        active.mat[:, [0, -1]] = 0
    return active


class PageDistortionStep(
    PipelineStep[PageDistortionStepConfig, PageDistortionStepInput, PageDistortionStepOutput]
):

    def __init__(self, config: PageDistortionStepConfig):
        super().__init__(config)
        self.random_distortion = random_distortion_factory.create(
            config.random_distortion_factory_config
        )
        self.char_mask_engine = (
            char_mask_engine_executor_aggregator_factory.create_engine_executor(
                config.char_mask_engine_config
            )
        )

    @classmethod
    def fill_page_inactive_region(cls, page_image: Image, page_active_mask: Mask,
                                  page_bottom_layer_image: Image) -> None:
        assert page_image.shape == page_active_mask.shape
        if page_bottom_layer_image.shape != page_image.shape:
            page_bottom_layer_image = page_bottom_layer_image.to_resized_image(
                resized_height=page_image.height,
                resized_width=page_image.width,
            )
        page_active_mask.to_inverted_mask().fill_image(
            page_image, page_bottom_layer_image
        )

    def _label_text_lines(self, image: Image, polygons: Sequence[Polygon],
                          ups: PointList, downs: PointList,
                          group_sizes: Sequence[int]):
        cfg = self.config
        mask = None
        if cfg.enable_distorted_text_line_mask:
            mask = Mask.from_shapable(image)
            for polygon in polygons:
                polygon.fill_mask(mask)

        score_map = heights = debug_image = None
        if cfg.enable_distorted_text_line_height_score_map:
            lengths = _segment_lengths(ups, downs)
            assert sum(group_sizes) == lengths.shape[0]

            heights = []
            score_map = ScoreMap.from_shapable(image, is_prob=False)
            cursor = 0
            for polygon, size in zip(polygons, group_sizes):
                height = float(lengths[cursor:cursor + size].mean())
                heights.append(height)
                polygon.fill_score_map(score_map=score_map, value=height)
                cursor += size

            if cfg.enable_debug_distorted_text_line_heights:
                debug_image = _heights_debug_image(image, polygons, heights)

        return mask, score_map, heights, debug_image

    def _char_mask_for(self, image: Image, polygons: Sequence[Polygon]):
        return self.char_mask_engine.run(CharMaskEngineRunConfig(
            height=image.height, width=image.width, char_polygons=polygons,
        ))

    def _label_chars(self, image: Image, char_polygons: Sequence[Polygon],
                     seal_char_polygons: Sequence[Polygon],
                     ups: PointList, downs: PointList):
        cfg = self.config
        char_mask = per_char_masks = None
        if cfg.enable_distorted_char_mask:
            result = self._char_mask_for(image, char_polygons)
            char_mask = result.combined_chars_mask
            per_char_masks = result.char_masks

        seal_char_mask = None
        if cfg.enable_distorted_seal_impression_char_mask:
            seal_char_mask = self._char_mask_for(
                image, seal_char_polygons
            ).combined_chars_mask

        score_map = heights = debug_image = None
        if cfg.enable_distorted_char_height_score_map:
            lengths = _segment_lengths(ups, downs)
            heights = [0.0] * len(char_polygons)
            score_map = ScoreMap.from_shapable(image, is_prob=False)

            # Tall chars first, so overlapped small chars keep their label.
            for idx in np.argsort(lengths)[::-1]:
                idx = int(idx)
                heights[idx] = float(lengths[idx])
                source = (char_polygons[idx] if per_char_masks is None
                          else per_char_masks[idx])
                source.fill_score_map(score_map=score_map, value=heights[idx])

            if cfg.enable_debug_distorted_char_heights:
                debug_image = _heights_debug_image(image, char_polygons, heights)

        return char_mask, seal_char_mask, score_map, heights, debug_image

    def run(self, input: PageDistortionStepInput, rng: RandomGenerator):
        page = input.page_assembler_step_output.page
        char_labels = page.page_char_polygon_collection
        line_labels = page.page_text_line_polygon_collection

        polygon_groups = NamedGroups({
            'chars': char_labels.char_polygons,
            'adjusted_chars': char_labels.adjusted_char_polygons,
            'text_lines': line_labels.polygons,
            'disconnected': tuple(
                page.page_disconnected_text_region_collection.to_polygons()
            ),
            'non_text': tuple(page.page_non_text_region_collection.to_polygons()),
            'seal_chars': (
                page.page_seal_impression_char_polygon_collection.char_polygons
            ),
        })
        point_groups = NamedGroups({
            'char_ups': char_labels.height_points_up,
            'char_downs': char_labels.height_points_down,
            'line_ups': line_labels.height_points_up,
            'line_downs': line_labels.height_points_down,
        })

        debug = RandomDistortionDebug() \
            if self.config.enable_debug_random_distortion else None

        result = self.random_distortion.distort(
            image=page.image,
            mask=_edge_zeroed_active_mask(page.image),
            polygons=polygon_groups.flattened,
            points=PointList(point_groups.flattened),
            rng=rng,
            debug=debug,
        )
        assert result.image and result.mask and result.polygons and result.points

        self.fill_page_inactive_region(
            page_image=result.image,
            page_active_mask=result.mask,
            page_bottom_layer_image=page.page_bottom_layer_image,
        )

        polygons = polygon_groups.restore(result.polygons)
        points = {
            name: PointList(group)
            for name, group in point_groups.restore(result.points).items()
        }

        group_sizes = line_labels.height_points_group_sizes
        assert len(polygons['text_lines']) == len(group_sizes)
        assert len(points['line_ups']) == len(points['line_downs'])

        line_mask, line_score_map, line_heights, line_debug = (
            self._label_text_lines(
                result.image, polygons['text_lines'],
                points['line_ups'], points['line_downs'], group_sizes,
            )
        )
        char_mask, seal_char_mask, char_score_map, char_heights, char_debug = (
            self._label_chars(
                result.image, polygons['chars'], polygons['seal_chars'],
                points['char_ups'], points['char_downs'],
            )
        )

        return PageDistortionStepOutput(
            page_image=result.image,
            page_random_distortion_debug=debug,
            page_active_mask=result.mask,
            page_char_polygon_collection=PageCharPolygonCollection(
                height=result.image.height,
                width=result.image.width,
                char_polygons=polygons['chars'],
                adjusted_char_polygons=polygons['adjusted_chars'],
                height_points_up=points['char_ups'],
                height_points_down=points['char_downs'],
            ),
            page_char_mask=char_mask,
            page_seal_impression_char_mask=seal_char_mask,
            page_char_height_score_map=char_score_map,
            page_char_heights=char_heights,
            page_char_heights_debug_image=char_debug,
            page_text_line_polygon_collection=PageTextLinePolygonCollection(
                height=result.image.height,
                width=result.image.width,
                polygons=polygons['text_lines'],
                height_points_group_sizes=group_sizes,
                height_points_up=points['line_ups'],
                height_points_down=points['line_downs'],
            ),
            page_text_line_mask=line_mask,
            page_text_line_height_score_map=line_score_map,
            page_text_line_heights=line_heights,
            page_text_line_heights_debug_image=line_debug,
            page_disconnected_text_region_collection=(
                PageDisconnectedTextRegionCollection(
                    disconnected_text_regions=[
                        DisconnectedTextRegion(polygon)
                        for polygon in polygons['disconnected']
                    ],
                )
            ),
            page_non_text_region_collection=PageNonTextRegionCollection(
                non_text_regions=[
                    NonTextRegion(polygon) for polygon in polygons['non_text']
                ],
            ),
            page_seal_impression_char_polygon_collection=(
                PageSealImpressionCharPolygonCollection(
                    char_polygons=polygons['seal_chars'],
                )
            ),
        )


page_distortion_step_factory = PipelineStepFactory(PageDistortionStep)
