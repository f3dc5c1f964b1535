"""Char + font sampling: draw a char sequence sized to the target box, then
pick a font variant that covers every char.

Behavioral spec: vkit/engine/char_and_font_sampler/__init__.py:39-137
(re-derived).
"""
import logging
import math
from typing import Optional, Sequence

import attr
from numpy.random import Generator as RandomGenerator

from ...element import LexiconCollection
from ...utility import rng_choice
from ..char_sampler.type import CharSamplerEngineRunConfig
from ..font.type import (
    FontCollection,
    FontEngineRunConfigGlyphSequence,
    FontVariant,
)
from ..interface import (
    Engine,
    EngineExecutorAggregator,
    EngineExecutorFactory,
    NoneTypeEngineInitConfig,
)

logger = logging.getLogger(__name__)

# Chars per box ~ long side / char side, by layout direction.
_ASPECT_BY_SEQUENCE = {
    FontEngineRunConfigGlyphSequence.HORI_DEFAULT: lambda h, w: w / h,
    FontEngineRunConfigGlyphSequence.VERT_DEFAULT: lambda h, w: h / w,
}


@attr.define
class CharAndFontSamplerEngineRunConfig:
    height: int
    width: int
    glyph_sequence: FontEngineRunConfigGlyphSequence = (
        FontEngineRunConfigGlyphSequence.HORI_DEFAULT
    )
    num_chars_factor: float = 1.1
    num_chars: Optional[int] = None


@attr.define
class CharAndFontSamplerEngineInitResource:
    lexicon_collection: LexiconCollection
    font_collection: FontCollection
    char_sampler_engine_executor_aggregator: EngineExecutorAggregator


@attr.define
class CharAndFont:
    chars: Sequence[str]
    font_variant: FontVariant


class CharAndFontSamplerEngine(
    Engine[NoneTypeEngineInitConfig, CharAndFontSamplerEngineInitResource, CharAndFontSamplerEngineRunConfig, Optional[CharAndFont]]
):

    @classmethod
    def get_type_name(cls) -> str:
        return 'default'

    def __init__(self, init_config, init_resource=None):
        super().__init__(init_config, init_resource)
        assert init_resource
        self.resource = init_resource

    @classmethod
    def estimate_num_chars(cls, run_config: CharAndFontSamplerEngineRunConfig) -> int:
        if run_config.num_chars:
            return run_config.num_chars
        aspect = _ASPECT_BY_SEQUENCE[run_config.glyph_sequence]
        return math.ceil(
            aspect(run_config.height, run_config.width) * run_config.num_chars_factor
        )

    def run(self, run_config: CharAndFontSamplerEngineRunConfig,
            rng: Optional[RandomGenerator] = None) -> Optional[CharAndFont]:
        assert rng is not None
        chars = self.resource.char_sampler_engine_executor_aggregator.run(
            CharSamplerEngineRunConfig(
                num_chars=self.estimate_num_chars(run_config),
                enable_aggregator_mode=True,
            ),
            rng,
        )

        # Only fonts whose glyph set covers every sampled char qualify.
        candidates = self.resource.font_collection.filter_font_metas(chars)
        if not candidates:
            logger.warning(f'no font covers chars={chars!r}')
            return None
        font_meta = rng_choice(rng, candidates)
        variant = font_meta.get_font_variant(
            int(rng.integers(0, font_meta.num_font_variants))
        )
        return CharAndFont(chars=chars, font_variant=variant)


char_and_font_sampler_engine_executor_factory = EngineExecutorFactory(
    CharAndFontSamplerEngine
)
