"""Text-line label step: char / text-line polygons, height anchor points,
and the optional boundary masks + gradient score map.

Behavioral spec: vkit/pipeline/text_detection/page_text_line_label.py:25-360
(re-derived; the four directional boundary quads come from one ring-walk
table instead of four hand-written blocks).
"""
from typing import List, Optional, Sequence, Tuple

import attr
from numpy.random import Generator as RandomGenerator

from ...element import Box, Mask, Point, PointList, Polygon, ScoreMap
from ..interface import PipelineStep, PipelineStepFactory
from .page_text_line import PageTextLineCollection, PageTextLineStepOutput


@attr.define
class PageTextLineLabelStepConfig:
    num_sample_height_points: int = 3
    enable_text_line_mask: bool = False
    enable_boundary_mask: bool = False
    boundary_dilate_ratio: float = 0.5
    enable_boundary_score_map: bool = False
    adjusted_ref_char_height_ratio: float = 0.6
    adjusted_ref_char_width_ratio: float = 0.6


@attr.define
class PageTextLineLabelStepInput:
    page_text_line_step_output: PageTextLineStepOutput


@attr.define
class PageTextLinePolygonCollection:
    height: int
    width: int
    polygons: Sequence[Polygon]
    height_points_group_sizes: Sequence[int]
    height_points_up: PointList
    height_points_down: PointList


@attr.define
class PageCharPolygonCollection:
    height: int
    width: int
    char_polygons: Sequence[Polygon]
    adjusted_char_polygons: Sequence[Polygon]
    height_points_up: PointList
    height_points_down: PointList


@attr.define
class PageTextLineLabelStepOutput:
    page_char_polygon_collection: PageCharPolygonCollection
    page_text_line_polygon_collection: PageTextLinePolygonCollection
    page_text_line_mask: Optional[Mask]
    page_text_line_boundary_mask: Optional[Mask]
    page_text_line_and_boundary_mask: Optional[Mask]
    page_text_line_boundary_score_map: Optional[ScoreMap]


def _margin_boxes(box: Box, dilated: Box) -> Tuple[Optional[Box], ...]:
    """The four dilation margins (up, down, left, right), None when empty.

    Up/down margins span the dilated width; left/right only the box height.
    """
    candidates = (
        dilated._replace(down=box.up - 1),
        dilated._replace(up=box.down + 1),
        box._replace(left=dilated.left, right=box.left - 1),
        box._replace(left=box.right + 1, right=dilated.right),
    )
    return tuple(
        c if c.up <= c.down and c.left <= c.right else None for c in candidates
    )


def _margin_quads(box: Box, dilated: Box):
    """Gradient quads per margin: (p0, p1) on the box edge, (p2, p3) on the
    dilated edge, so v runs 0 at the text line to 1 at the dilation rim."""
    return (
        ((box.up, box.right), (box.up, box.left),
         (dilated.up, dilated.left), (dilated.up, dilated.right)),
        ((box.down, box.left), (box.down, box.right),
         (dilated.down, dilated.right), (dilated.down, dilated.left)),
        ((box.up, box.left), (box.down, box.left),
         (dilated.down, dilated.left), (dilated.up, dilated.left)),
        ((box.down, box.right), (box.up, box.right),
         (dilated.up, dilated.right), (dilated.down, dilated.right)),
    )


class PageTextLineLabelStep(
    PipelineStep[PageTextLineLabelStepConfig, PageTextLineLabelStepInput, PageTextLineLabelStepOutput]
):

    def _char_labels(self, collection: PageTextLineCollection
                     ) -> PageCharPolygonCollection:
        cfg = self.config
        char_polygons: List[Polygon] = []
        adjusted: List[Polygon] = []
        ups = PointList()
        downs = PointList()
        for text_line in collection.text_lines:
            char_polygons.extend(text_line.to_char_polygons(
                page_height=collection.height, page_width=collection.width,
            ))
            adjusted.extend(text_line.to_char_polygons(
                page_height=collection.height, page_width=collection.width,
                ref_char_height_ratio=cfg.adjusted_ref_char_height_ratio,
                ref_char_width_ratio=cfg.adjusted_ref_char_width_ratio,
            ))
            ups.extend(text_line.get_char_level_height_points(is_up=True))
            downs.extend(text_line.get_char_level_height_points(is_up=False))
        assert len(char_polygons) == len(adjusted) == len(ups) == len(downs)
        return PageCharPolygonCollection(
            height=collection.height,
            width=collection.width,
            char_polygons=char_polygons,
            adjusted_char_polygons=adjusted,
            height_points_up=ups,
            height_points_down=downs,
        )

    def _text_line_labels(self, collection: PageTextLineCollection
                          ) -> PageTextLinePolygonCollection:
        polygons: List[Polygon] = []
        group_sizes: List[int] = []
        ups = PointList()
        downs = PointList()
        for text_line in collection.text_lines:
            polygons.append(text_line.to_polygon())
            line_ups = text_line.get_height_points(
                num_points=self.config.num_sample_height_points, is_up=True
            )
            line_downs = text_line.get_height_points(
                num_points=self.config.num_sample_height_points, is_up=False
            )
            assert len(line_ups) == len(line_downs) > 0
            group_sizes.append(len(line_ups))
            ups.extend(line_ups)
            downs.extend(line_downs)
        return PageTextLinePolygonCollection(
            height=collection.height,
            width=collection.width,
            polygons=polygons,
            height_points_group_sizes=group_sizes,
            height_points_up=ups,
            height_points_down=downs,
        )

    def _boxes_by_font_size(self, collection: PageTextLineCollection):
        """(box, clipped dilated box) pairs, largest fonts first."""
        ordered = sorted(collection.text_lines,
                         key=lambda tl: tl.font_size, reverse=True)
        pairs = []
        for text_line in ordered:
            dilated = text_line.box.to_dilated_box(
                self.config.boundary_dilate_ratio, clip_long_side=True
            ).to_clipped_box(collection.shape)
            pairs.append((text_line.box, dilated))
        return pairs

    def _boundary_masks(self, shape, box_pairs, text_line_mask: Mask):
        boundary = Mask.from_shape(shape)
        for box, dilated in box_pairs:
            for margin in _margin_boxes(box, dilated):
                if margin:
                    margin.fill_mask(boundary)
        # Boundary excludes the text lines themselves.
        text_line_mask.fill_mask(boundary, 0)

        combined = boundary.copy()
        text_line_mask.fill_mask(combined)
        return boundary, combined

    def _boundary_score_map(self, shape, box_pairs,
                            boundary_mask: Mask) -> ScoreMap:
        score_map = ScoreMap.from_shape(shape, value=1.0)
        for box, dilated in box_pairs:
            margins = _margin_boxes(box, dilated)
            quads = _margin_quads(box, dilated)
            for margin, quad in zip(margins, quads):
                if margin is None:
                    continue
                points = [Point.create(y=y, x=x) for y, x in quad]
                score_map.fill_by_quad_interpolation(
                    point0=points[0], point1=points[1],
                    point2=points[2], point3=points[3],
                    func_np_uv_to_mat=lambda np_uv: np_uv[:, :, 1],
                    keep_min_value=True,
                )
        boundary_mask.to_inverted_mask().fill_score_map(score_map, 0.0)
        return score_map

    def run(self, input: PageTextLineLabelStepInput, rng: RandomGenerator):
        collection = input.page_text_line_step_output.page_text_line_collection

        text_line_mask = None
        boundary_mask = None
        combined_mask = None
        boundary_score_map = None
        if self.config.enable_text_line_mask:
            text_line_mask = Mask.from_shape(collection.shape)
            for text_line in collection.text_lines:
                text_line.box.fill_mask(text_line_mask)
            box_pairs = self._boxes_by_font_size(collection)
            if self.config.enable_boundary_mask:
                boundary_mask, combined_mask = self._boundary_masks(
                    collection.shape, box_pairs, text_line_mask
                )
                if self.config.enable_boundary_score_map:
                    boundary_score_map = self._boundary_score_map(
                        collection.shape, box_pairs, boundary_mask
                    )

        return PageTextLineLabelStepOutput(
            page_char_polygon_collection=self._char_labels(collection),
            page_text_line_polygon_collection=self._text_line_labels(collection),
            page_text_line_mask=text_line_mask,
            page_text_line_boundary_mask=boundary_mask,
            page_text_line_and_boundary_mask=combined_mask,
            page_text_line_boundary_score_map=boundary_score_map,
        )


page_text_line_label_step_factory = PipelineStepFactory(PageTextLineLabelStep)
