"""Page text-line step: render layout text lines and seal-slot text lines.

Behavioral spec: vkit/pipeline/text_detection/page_text_line.py:43-424
(re-derived; the three retry loops share one helper).
"""
import logging
from typing import Any, List, Mapping, Optional, Sequence, Tuple, Union

import attr
from numpy.random import Generator as RandomGenerator

from ...element import Box, LexiconCollection
from ...engine.char_and_font_sampler import (
    CharAndFont,
    char_and_font_sampler_engine_executor_factory,
)
from ...engine.char_sampler import char_sampler_engine_executor_aggregator_factory
from ...engine.font import (
    FontCollection,
    FontEngineRunConfigStyle,
    TextLine,
    font_engine_executor_aggregator_factory,
)
from ...engine.seal_impression import SealImpression
from ...utility import PathType, normalize_to_keys_and_probs, rng_choice
from ..interface import PipelineStep, PipelineStepFactory
from .page_layout import PageLayoutStepOutput
from .page_seal_impression import PageSealImpresssionStepOutput

logger = logging.getLogger(__name__)

# Unbounded width for seal arc lines.
_NO_WIDTH_LIMIT = 2**32 - 1

_GLYPH_COLOR_GATES = {
    'grayscale': None,
    'red': (1, 0, 0),
    'green': (0, 1, 0),
    'blue': (0, 0, 1),
}


@attr.define
class PageTextLineStepConfig:
    lexicon_collection_json: str
    font_collection_folder: str
    char_sampler_configs: Union[Sequence[Mapping[str, Any]], PathType]
    font_configs: Union[Sequence[Mapping[str, Any]], PathType]
    font_style: FontEngineRunConfigStyle = attr.field(factory=FontEngineRunConfigStyle)
    weight_font_style_glyph_color_grayscale: float = 0.9
    font_style_glyph_color_grayscale_min: int = 0
    font_style_glyph_color_grayscale_max: int = 100
    weight_font_style_glyph_color_red: float = 0.06
    weight_font_style_glyph_color_green: float = 0.01
    weight_font_style_glyph_color_blue: float = 0.03
    font_style_glyph_color_rgb_min: int = 100
    font_style_glyph_color_rgb_max: int = 255
    return_font_variant: bool = False
    short_text_line_char_sampler_configs: Optional[
        Union[Sequence[Mapping[str, Any]], PathType]
    ] = None
    prob_short_text_line: float = 0.2
    short_text_line_num_chars_max: int = 2


@attr.define
class PageTextLineStepInput:
    page_layout_step_output: PageLayoutStepOutput
    page_seal_impresssion_step_output: PageSealImpresssionStepOutput


@attr.define
class PageTextLineCollection:
    height: int
    width: int
    text_lines: Sequence[TextLine]
    short_text_line_flags: Sequence[bool]

    @property
    def shape(self):
        return self.height, self.width


@attr.define
class SealImpressionResource:
    box: Box
    angle: int
    text_line_slot_indices: Sequence[int]
    text_lines: Sequence[TextLine]
    internal_text_line: Optional[TextLine]


@attr.define
class PageSealImpressionTextLineCollection:
    height: int
    width: int
    seal_impressions: Sequence[SealImpression]
    seal_impression_resources: Sequence[SealImpressionResource]


@attr.define
class PageTextLineStepOutput:
    page_text_line_collection: PageTextLineCollection
    page_seal_impression_text_line_collection: PageSealImpressionTextLineCollection


def _sample_with_retries(sampler, run_config, rng,
                         what: str) -> Optional[CharAndFont]:
    for _ in range(3):
        char_and_font = sampler.run(run_config=run_config, rng=rng)
        if char_and_font:
            return char_and_font
    logger.warning(f'could not sample char_and_font for {what}')
    return None


class PageTextLineStep(
    PipelineStep[PageTextLineStepConfig, PageTextLineStepInput, PageTextLineStepOutput]
):

    def __init__(self, config: PageTextLineStepConfig):
        super().__init__(config)

        lexicon_collection = LexiconCollection.from_file(config.lexicon_collection_json)
        font_collection = FontCollection.from_folder(config.font_collection_folder)

        def build_sampler(char_sampler_configs):
            aggregator = (
                char_sampler_engine_executor_aggregator_factory
                .create_with_repeated_init_resource(
                    char_sampler_configs,
                    {'lexicon_collection': lexicon_collection},
                )
            )
            return char_and_font_sampler_engine_executor_factory.create(
                {},
                {
                    'lexicon_collection': lexicon_collection,
                    'font_collection': font_collection,
                    'char_sampler_engine_executor_aggregator': aggregator,
                },
            )

        self.char_and_font_sampler = build_sampler(config.char_sampler_configs)
        self.short_char_and_font_sampler = self.char_and_font_sampler
        if config.short_text_line_char_sampler_configs is not None:
            self.short_char_and_font_sampler = build_sampler(
                config.short_text_line_char_sampler_configs
            )

        self.color_keys, self.color_probs = normalize_to_keys_and_probs([
            ('grayscale', config.weight_font_style_glyph_color_grayscale),
            ('red', config.weight_font_style_glyph_color_red),
            ('green', config.weight_font_style_glyph_color_green),
            ('blue', config.weight_font_style_glyph_color_blue),
        ])
        self.font_aggregator = font_engine_executor_aggregator_factory.create(
            config.font_configs
        )

    def _sample_glyph_color(self, rng: RandomGenerator) -> Tuple[int, int, int]:
        cfg = self.config
        gate = _GLYPH_COLOR_GATES[
            rng_choice(rng, self.color_keys, probs=self.color_probs)
        ]
        if gate is None:
            tone = int(rng.integers(cfg.font_style_glyph_color_grayscale_min,
                                    cfg.font_style_glyph_color_grayscale_max + 1))
            return (tone, tone, tone)
        value = int(rng.integers(cfg.font_style_glyph_color_rgb_min,
                                 cfg.font_style_glyph_color_rgb_max + 1))
        return tuple(value * g for g in gate)  # type: ignore[return-value]

    def _truncate_for_short_line(self, char_and_font: CharAndFont,
                                 rng: RandomGenerator) -> CharAndFont:
        limit = int(rng.integers(1, self.config.short_text_line_num_chars_max + 1))
        chars = [c for c in char_and_font.chars if not c.isspace()]
        if len(chars) > limit:
            begin = int(rng.integers(0, len(chars) - limit + 1))
            chars = chars[begin:begin + limit]
        return attr.evolve(char_and_font, chars=chars)

    def _render_layout_text_line(self, layout_text_line,
                                 rng: RandomGenerator
                                 ) -> Tuple[List[TextLine], bool]:
        box = layout_text_line.box
        is_short = rng.random() < self.config.prob_short_text_line
        sampler = (self.short_char_and_font_sampler if is_short
                   else self.char_and_font_sampler)
        char_and_font = _sample_with_retries(
            sampler, {'height': box.height, 'width': box.width}, rng,
            f'layout_text_line={layout_text_line}',
        )
        if char_and_font is None:
            return [], is_short
        if is_short:
            char_and_font = self._truncate_for_short_line(char_and_font, rng)

        text_line = self.font_aggregator.run(
            run_config={
                'height': box.height,
                'width': box.width,
                'chars': char_and_font.chars,
                'font_variant': char_and_font.font_variant,
                'glyph_sequence': layout_text_line.glyph_sequence,
                'style': attr.evolve(
                    self.config.font_style,
                    glyph_color=self._sample_glyph_color(rng),
                ),
                'return_font_variant': self.config.return_font_variant,
            },
            rng=rng,
        )
        if not text_line:
            return [], is_short
        placed = text_line.to_shifted_text_line(offset_y=box.up, offset_x=box.left)
        return placed.split(), is_short

    def _render_fixed_box_line(self, height: int, width: int,
                               rng: RandomGenerator,
                               num_chars: Optional[int] = None,
                               what: str = 'seal slot') -> Optional[TextLine]:
        run_config = {'height': height, 'width': width}
        if num_chars is not None:
            run_config['num_chars'] = num_chars
        char_and_font = _sample_with_retries(
            self.char_and_font_sampler, run_config, rng, what
        )
        if char_and_font is None:
            return None
        return self.font_aggregator.run(
            run_config={
                'height': height,
                'width': width,
                'chars': char_and_font.chars,
                'font_variant': char_and_font.font_variant,
            },
            rng=rng,
        )

    def _collect_seal_resource(self, seal_impression: SealImpression, box: Box,
                               angle: int, rng: RandomGenerator
                               ) -> Optional[SealImpressionResource]:
        slot_indices: List[int] = []
        slot_lines: List[TextLine] = []
        for slot_idx, slot in enumerate(seal_impression.text_line_slots):
            line = self._render_fixed_box_line(
                slot.text_line_height, _NO_WIDTH_LIMIT, rng,
                num_chars=len(slot.char_slots),
            )
            if line:
                slot_indices.append(slot_idx)
                slot_lines.append(line)

        internal_text_line = None
        internal_box = seal_impression.internal_text_line_box
        if internal_box:
            internal_text_line = self._render_fixed_box_line(
                internal_box.height, internal_box.width, rng,
                what='internal text line',
            )

        if not slot_lines:
            return None
        return SealImpressionResource(
            box=box,
            angle=angle,
            text_line_slot_indices=slot_indices,
            text_lines=slot_lines,
            internal_text_line=internal_text_line,
        )

    def run(self, input: PageTextLineStepInput, rng: RandomGenerator):
        layout = input.page_layout_step_output.page_layout

        text_lines: List[TextLine] = []
        short_flags: List[bool] = []
        for layout_text_line in layout.layout_text_lines:
            lines, is_short = self._render_layout_text_line(layout_text_line, rng)
            text_lines.extend(lines)
            short_flags.extend([is_short] * len(lines))
        assert text_lines and len(text_lines) == len(short_flags)

        seal_out = input.page_seal_impresssion_step_output
        seal_impressions: List[SealImpression] = []
        seal_resources: List[SealImpressionResource] = []
        for seal_impression, box, angle in zip(
            seal_out.seal_impressions, seal_out.boxes, seal_out.angles
        ):
            resource = self._collect_seal_resource(seal_impression, box, angle, rng)
            if resource:
                seal_impressions.append(seal_impression)
                seal_resources.append(resource)

        return PageTextLineStepOutput(
            page_text_line_collection=PageTextLineCollection(
                height=layout.height,
                width=layout.width,
                text_lines=text_lines,
                short_text_line_flags=short_flags,
            ),
            page_seal_impression_text_line_collection=(
                PageSealImpressionTextLineCollection(
                    height=layout.height,
                    width=layout.width,
                    seal_impressions=seal_impressions,
                    seal_impression_resources=seal_resources,
                )
            ),
        )


page_text_line_step_factory = PipelineStepFactory(PageTextLineStep)
