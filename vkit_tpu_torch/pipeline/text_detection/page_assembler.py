"""Page assembler: composite every generated layer onto the background.

Layer order: background <- photos <- barcodes <- decorative boxes <- text
lines <- symbols <- seal impressions.  Behavioral spec:
vkit/pipeline/text_detection/page_assembler.py:45-277.
"""
from typing import List, Sequence

import attr
from numpy.random import Generator as RandomGenerator

from ...element import Box, Image, Polygon, Shapable
from ...engine.seal_impression import fill_text_line_to_seal_impression
from ...mechanism.distortion import rotate
from ..interface import PipelineStep, PipelineStepFactory
from .page_background import PageBackgroundStepOutput
from .page_barcode import PageBarcodeStepOutput
from .page_image import PageImageCollection, PageImageStepOutput
from .page_layout import DisconnectedTextRegion, NonTextRegion, PageLayoutStepOutput
from .page_non_text_symbol import PageNonTextSymbolStepOutput
from .page_text_line import (
    PageSealImpressionTextLineCollection,
    PageTextLineCollection,
    PageTextLineStepOutput,
)
from .page_text_line_bounding_box import PageTextLineBoundingBoxStepOutput
from .page_text_line_label import (
    PageCharPolygonCollection,
    PageTextLineLabelStepOutput,
    PageTextLinePolygonCollection,
)


@attr.define
class PageAssemblerStepConfig:
    pass


@attr.define
class PageAssemblerStepInput:
    page_layout_step_output: PageLayoutStepOutput
    page_background_step_output: PageBackgroundStepOutput
    page_image_step_output: PageImageStepOutput
    page_barcode_step_output: PageBarcodeStepOutput
    page_text_line_step_output: PageTextLineStepOutput
    page_non_text_symbol_step_output: PageNonTextSymbolStepOutput
    page_text_line_bounding_box_step_output: PageTextLineBoundingBoxStepOutput
    page_text_line_label_step_output: PageTextLineLabelStepOutput


@attr.define
class PageDisconnectedTextRegionCollection:
    disconnected_text_regions: Sequence[DisconnectedTextRegion]

    def to_polygons(self):
        return (region.polygon for region in self.disconnected_text_regions)


@attr.define
class PageNonTextRegionCollection:
    non_text_regions: Sequence[NonTextRegion]

    def to_polygons(self):
        return (region.polygon for region in self.non_text_regions)


@attr.define
class PageSealImpressionCharPolygonCollection:
    char_polygons: Sequence[Polygon]


@attr.define
class Page(Shapable):
    image: Image
    page_image_collection: PageImageCollection
    page_bottom_layer_image: Image
    page_text_line_collection: PageTextLineCollection
    page_seal_impression_text_line_collection: PageSealImpressionTextLineCollection
    page_char_polygon_collection: PageCharPolygonCollection
    page_text_line_polygon_collection: PageTextLinePolygonCollection
    page_disconnected_text_region_collection: PageDisconnectedTextRegionCollection
    page_non_text_region_collection: PageNonTextRegionCollection
    page_seal_impression_char_polygon_collection: PageSealImpressionCharPolygonCollection

    @property
    def height(self) -> int:
        return self.image.height

    @property
    def width(self) -> int:
        return self.image.width


@attr.define
class PageAssemblerStepOutput:
    page: Page


def _stamp_seal(canvas: Image, seal_impression, resource,
                collected_char_polygons: List[Polygon]) -> None:
    """Render one seal: fill its text slots, rotate, and blend in place."""
    filled_score_map, char_polygons = fill_text_line_to_seal_impression(
        seal_impression,
        resource.text_line_slot_indices,
        resource.text_lines,
        resource.internal_text_line,
    )
    spun = rotate.distort(
        {'angle': resource.angle},
        mask=seal_impression.background_mask,
        score_map=filled_score_map,
        polygons=char_polygons,
    )
    assert spun.mask and spun.score_map and spun.polygons
    assert spun.mask.shape == spun.score_map.shape

    center = resource.box.get_center_point()
    up = center.y - spun.mask.height // 2
    left = center.x - spun.mask.width // 2
    target = Box(up, up + spun.mask.height - 1, left, left + spun.mask.width - 1)
    if not (target.valid and target.down < canvas.height
            and target.right < canvas.width):
        return  # Out of bounds after rotation: skip the stamp.

    target.fill_image(canvas, value=seal_impression.color,
                      image_mask=spun.mask, alpha=seal_impression.alpha)
    target.fill_image(canvas, value=seal_impression.color, alpha=spun.score_map)
    collected_char_polygons.extend(
        polygon.to_shifted_polygon(offset_y=up, offset_x=left)
        for polygon in spun.polygons
    )


class PageAssemblerStep(
    PipelineStep[PageAssemblerStepConfig, PageAssemblerStepInput, PageAssemblerStepOutput]
):

    def run(self, input: PageAssemblerStepInput, rng: RandomGenerator):
        layout = input.page_layout_step_output.page_layout
        background = input.page_background_step_output.background_image
        photos = input.page_image_step_output.page_image_collection
        barcodes = input.page_barcode_step_output
        text_lines = input.page_text_line_step_output.page_text_line_collection
        seal_lines = (
            input.page_text_line_step_output.page_seal_impression_text_line_collection
        )
        symbols = input.page_non_text_symbol_step_output
        frames = input.page_text_line_bounding_box_step_output
        labels = input.page_text_line_label_step_output

        assert background.mat.shape == (layout.height, layout.width, 3)
        canvas = background.copy()

        for photo in photos.page_images:
            photo.box.fill_image(canvas, photo.image, alpha=photo.alpha)

        # Barcode activations print as black ink.
        for score_map in (*barcodes.barcode_qr_score_maps,
                          *barcodes.barcode_code39_score_maps):
            canvas[score_map] = (0, 0, 0)

        for score_map, color in zip(frames.score_maps, frames.colors):
            canvas[score_map] = color

        for text_line in text_lines.text_lines:
            if text_line.score_map:
                text_line.score_map.fill_image(canvas, text_line.glyph_color)
            else:
                text_line.mask.fill_image(canvas, text_line.image)

        for image, box, alpha in zip(symbols.images, symbols.boxes, symbols.alphas):
            box.fill_image(canvas, value=image, alpha=alpha)

        seal_char_polygons: List[Polygon] = []
        for seal_impression, resource in zip(
            seal_lines.seal_impressions, seal_lines.seal_impression_resources
        ):
            _stamp_seal(canvas, seal_impression, resource, seal_char_polygons)

        page = Page(
            image=canvas,
            page_image_collection=photos,
            page_bottom_layer_image=input.page_image_step_output.page_bottom_layer_image,
            page_text_line_collection=text_lines,
            page_seal_impression_text_line_collection=seal_lines,
            page_char_polygon_collection=labels.page_char_polygon_collection,
            page_text_line_polygon_collection=labels.page_text_line_polygon_collection,
            page_disconnected_text_region_collection=(
                PageDisconnectedTextRegionCollection(layout.disconnected_text_regions)
            ),
            page_non_text_region_collection=(
                PageNonTextRegionCollection(layout.non_text_regions)
            ),
            page_seal_impression_char_polygon_collection=(
                PageSealImpressionCharPolygonCollection(
                    char_polygons=seal_char_polygons
                )
            ),
        )
        return PageAssemblerStepOutput(page=page)


page_assembler_step_factory = PipelineStepFactory(PageAssemblerStep)
