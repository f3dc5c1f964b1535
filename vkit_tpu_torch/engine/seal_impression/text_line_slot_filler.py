"""Fill rendered text lines into seal-impression char slots.

Per char: width-adjusted alpha patch, rotated to the slot angle, anchored
by the slot's point_up; the internal text line pastes directly.  Behavioral
spec: vkit/engine/seal_impression/text_line_slot_filler.py:28-205
(re-derived around three per-char helpers).
"""
import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ...element import Box, Point, Polygon, ScoreMap
from ...mechanism.distortion import rotate
from ..font import TextLine
from .type import SealImpression, TextLineSlot

logger = logging.getLogger(__name__)


def _dominant_char_aspect(text_line: TextLine) -> float:
    """width/height of the tallest glyph's reference char metrics."""
    best_h = best_w = 0
    for glyph in text_line.char_glyphs:
        if glyph.ref_char_height > best_h:
            best_h = glyph.ref_char_height
            best_w = glyph.ref_char_width
    assert best_h > 0 and best_w > 0
    return best_w / best_h


def _char_alpha_patch(text_line: TextLine, char_box, char_glyph,
                      width_factor: float) -> Tuple[ScoreMap, Box]:
    """The char's alpha raster, width-scaled by the slot aspect ratio."""
    resized_width = max(1, round(width_factor * char_glyph.width))
    footprint = char_box.box._replace(left=0, right=resized_width - 1)
    patch = ScoreMap.from_shape((text_line.box.height, resized_width))

    if char_glyph.score_map:
        alpha = char_glyph.score_map
        if alpha.shape != footprint.shape:
            alpha = alpha.to_resized_score_map(
                resized_height=footprint.height,
                resized_width=footprint.width,
                interpolation=text_line.resize_interpolation,
            )
        footprint.fill_score_map(patch, alpha)
    else:
        # LCD-rendered glyph: only a coverage mask exists.
        glyph_mask = char_glyph.get_glyph_mask(
            box=char_box.box, interpolation=text_line.resize_interpolation
        )
        if glyph_mask.shape != footprint.shape:
            glyph_mask = glyph_mask.to_resized_mask(
                resized_height=footprint.height,
                resized_width=footprint.width,
                interpolation=text_line.resize_interpolation,
            )
        footprint.fill_score_map(patch, glyph_mask.mat.astype(np.float32))
    return patch, footprint


def _expanded_char_quad(footprint: Box, char_glyph, width_factor: float) -> Polygon:
    """Char label quad grown to the reference metrics."""
    up, down = float(footprint.up), float(footprint.down)
    if footprint.height < char_glyph.ref_char_height:
        grow = (char_glyph.ref_char_height - footprint.height) / 2
        up -= grow
        down += grow
    left, right = float(footprint.left), float(footprint.right)
    ref_width = width_factor * char_glyph.ref_char_width
    if footprint.width < ref_width:
        grow = (ref_width - footprint.width) / 2
        left -= grow
        right += grow
    return Polygon.from_xy_pairs(
        [(left, up), (right, up), (right, down), (left, down)]
    )


def _fill_slot_chars(score_map: ScoreMap, slot: TextLineSlot,
                     text_line: TextLine, char_polygons: List[Polygon]) -> None:
    width_factor = slot.char_aspect_ratio / _dominant_char_aspect(text_line)

    for idx, (char_box, char_glyph) in enumerate(
        zip(text_line.char_boxes, text_line.char_glyphs)
    ):
        if idx >= len(slot.char_slots):
            logger.error('more chars than slots; truncating')
            break
        char_slot = slot.char_slots[idx]

        patch, footprint = _char_alpha_patch(
            text_line, char_box, char_glyph, width_factor
        )
        quad = _expanded_char_quad(footprint, char_glyph, width_factor)
        anchor = Point.create(y=0, x=patch.width / 2)

        # A horizontal line reads at angle 270; rotate the difference.
        spun = rotate.distort(
            {'angle': char_slot.angle - 270},
            score_map=patch,
            point=anchor,
            polygon=quad,
            disable_clip_result_elements=True,
        )
        assert spun.score_map and spun.point and spun.polygon

        up = char_slot.point_up.y - spun.point.y
        left = char_slot.point_up.x - spun.point.x
        target = Box(up, up + spun.score_map.height - 1,
                     left, left + spun.score_map.width - 1)
        if not (0 <= target.up and target.down < score_map.height
                and 0 <= target.left and target.right < score_map.width):
            logger.error('char lands outside the seal; skipping')
            continue

        target.fill_score_map(score_map, spun.score_map, keep_max_value=True)
        char_polygons.append(spun.polygon.to_shifted_polygon(up, left))


def fill_text_line_to_seal_impression(
    seal_impression: SealImpression,
    text_line_slot_indices: Sequence[int],
    text_lines: Sequence[TextLine],
    internal_text_line: Optional[TextLine],
) -> Tuple[ScoreMap, List[Polygon]]:
    score_map = ScoreMap.from_shape(seal_impression.shape)
    char_polygons: List[Polygon] = []
    assert len(text_line_slot_indices) == len(text_lines)

    for slot_idx, text_line in zip(text_line_slot_indices, text_lines):
        if slot_idx >= len(seal_impression.text_line_slots):
            logger.error('text line slot index out of range')
            break
        assert text_line.is_hori and not text_line.shifted
        _fill_slot_chars(
            score_map, seal_impression.text_line_slots[slot_idx],
            text_line, char_polygons,
        )

    if internal_text_line:
        box = seal_impression.internal_text_line_box
        assert box
        placed = internal_text_line.to_shifted_text_line(
            offset_y=box.up, offset_x=box.left
        )
        if placed.score_map:
            placed.box.fill_score_map(score_map, placed.score_map)
        else:
            placed.box.fill_score_map(
                score_map, placed.mask.mat.astype(np.float32)
            )
        char_polygons.extend(
            placed.to_char_polygons(
                page_height=score_map.height, page_width=score_map.width
            )
        )

    # Normalize so the strongest activation carries the seal alpha.
    peak = float(score_map.mat.max())
    if peak > 0:
        score_map.assign_mat(score_map.mat * seal_impression.alpha / peak)
    return score_map, char_polygons
