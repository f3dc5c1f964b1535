"""Default char-mask engine: the union of all char polygon footprints.

Behavioral spec: vkit/engine/char_mask/default.py:31-54 (re-derived on the
set-op rasterizer).
"""
from typing import Optional

import attr
from numpy.random import Generator as RandomGenerator

from ...element import mask_from_elements
from ..interface import Engine, EngineExecutorFactory, NoneTypeEngineInitResource
from .type import CharMask, CharMaskEngineRunConfig


@attr.define
class CharMaskDefaultEngineInitConfig:
    pass


class CharMaskDefaultEngine(
    Engine[CharMaskDefaultEngineInitConfig, NoneTypeEngineInitResource, CharMaskEngineRunConfig, CharMask]
):

    @classmethod
    def get_type_name(cls) -> str:
        return 'default'

    def run(self, run_config: CharMaskEngineRunConfig,
            rng: Optional[RandomGenerator] = None) -> CharMask:
        return CharMask(
            combined_chars_mask=mask_from_elements(
                (run_config.height, run_config.width), run_config.char_polygons
            )
        )


char_mask_default_engine_executor_factory = EngineExecutorFactory(CharMaskDefaultEngine)
