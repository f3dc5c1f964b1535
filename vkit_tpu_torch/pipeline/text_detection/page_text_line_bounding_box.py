"""Decorative text-line bounding-box step: hollow rectangles drawn around a
random subset of text lines.

Behavioral spec: vkit/pipeline/text_detection/page_text_line_bounding_box.py:
25-202.
"""
from typing import List, Optional, Sequence, Tuple

import attr
from numpy.random import Generator as RandomGenerator

from ...element import Box, ScoreMap
from ...engine.font import TextLine
from ..interface import PipelineStep, PipelineStepFactory
from .page_text_line import PageTextLineStepOutput


@attr.define
class PageTextLineBoundingBoxStepConfig:
    prob_non_short_text_line: float = 0.05
    prob_short_text_line: float = 0.3
    offset_ratio_min: float = 0.1
    offset_ratio_max: float = 2.0
    border_thickness_ratio_min: float = 0.0
    border_thickness_ratio_max: float = 0.125
    border_thickness_min: int = 1
    alpha_min: float = 0.9
    alpha_max: float = 1.0


@attr.define
class PageTextLineBoundingBoxStepInput:
    page_text_line_step_output: PageTextLineStepOutput


@attr.define
class PageTextLineBoundingBoxStepOutput:
    score_maps: Sequence[ScoreMap]
    colors: Sequence[Tuple[int, int, int]]


def _hollow_frame(height: int, width: int, thickness: int, alpha: float
                  ) -> ScoreMap:
    """A rectangle outline as an alpha score map."""
    frame = ScoreMap.from_shape((height, width), value=alpha)
    hole = Box(thickness, height - thickness - 1,
               thickness, width - thickness - 1)
    assert hole.up < hole.down and hole.left < hole.right
    hole.fill_score_map(frame, 0.0)
    return frame


class PageTextLineBoundingBoxStep(
    PipelineStep[PageTextLineBoundingBoxStepConfig, PageTextLineBoundingBoxStepInput, PageTextLineBoundingBoxStepOutput]
):

    def _frame_for(self, height: int, width: int, text_line: TextLine,
                   rng: RandomGenerator) -> Optional[ScoreMap]:
        cfg = self.config
        ref_height = max(g.ref_char_height for g in text_line.char_glyphs)

        def offset() -> int:
            return round(
                rng.uniform(cfg.offset_ratio_min, cfg.offset_ratio_max) * ref_height
            )

        off_up, off_down, off_left, off_right = (
            offset(), offset(), offset(), offset()
        )
        frame_h = text_line.box.height + off_up + off_down
        frame_w = text_line.box.width + off_left + off_right
        thickness = max(
            round(rng.uniform(cfg.border_thickness_ratio_min,
                              cfg.border_thickness_ratio_max) * ref_height),
            cfg.border_thickness_min,
        )
        alpha = float(rng.uniform(cfg.alpha_min, cfg.alpha_max))
        frame = _hollow_frame(frame_h, frame_w, thickness, alpha)

        # Place on the page, trimming whatever sticks out.
        raw = Box(
            text_line.box.up - off_up,
            text_line.box.down + off_down,
            text_line.box.left - off_left,
            text_line.box.right + off_right,
        )
        window = Box(
            max(0, -raw.up),
            frame_h - 1 - max(0, raw.down - height + 1),
            max(0, -raw.left),
            frame_w - 1 - max(0, raw.right - width + 1),
        )
        if window.shape != (frame_h, frame_w):
            frame = window.extract_score_map(frame)
        return frame.to_box_attached(raw.to_clipped_box((height, width)))

    def run(self, input: PageTextLineBoundingBoxStepInput, rng: RandomGenerator):
        collection = input.page_text_line_step_output.page_text_line_collection

        score_maps: List[ScoreMap] = []
        colors: List[Tuple[int, int, int]] = []
        for text_line, is_short in zip(collection.text_lines,
                                       collection.short_text_line_flags):
            prob = (self.config.prob_short_text_line if is_short
                    else self.config.prob_non_short_text_line)
            if rng.random() >= prob:
                continue
            frame = self._frame_for(
                collection.height, collection.width, text_line, rng
            )
            if frame is not None:
                score_maps.append(frame)
                colors.append(text_line.glyph_color)

        return PageTextLineBoundingBoxStepOutput(
            score_maps=score_maps, colors=colors
        )


page_text_line_bounding_box_step_factory = PipelineStepFactory(PageTextLineBoundingBoxStep)
