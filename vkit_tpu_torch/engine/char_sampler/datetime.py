"""Datetime char sampler: strftime with random timezone / format /
delimiter substitution.

Behavioral spec: vkit/engine/char_sampler/datetime.py:28-127 (re-derived;
stdlib zoneinfo instead of pytz).
"""
import time
from datetime import date, datetime
from typing import Optional, Sequence, Tuple
from zoneinfo import ZoneInfo

import attr
from numpy.random import Generator as RandomGenerator

from ...utility import rng_choice
from ..interface import Engine, EngineExecutorFactory
from .type import (
    CharSamplerEngineInitResource,
    CharSamplerEngineRunConfig,
    fill_chars_to_num,
)

_CANDIDATE_DELIMITERS = ('/', ':', '-', ',', '.', '*')


@attr.define
class CharSamplerDatetimeEngineInitConfig:
    datetime_formats: Sequence[str]
    timezones: Sequence[str]
    datetime_begin: Tuple[int, int, int] = (1991, 12, 25)
    datetime_end: Tuple[int, int, int] = (2050, 12, 31)


CharSamplerDatetimeEngineInitResource = CharSamplerEngineInitResource


class CharSamplerDatetimeEngine(
    Engine[CharSamplerDatetimeEngineInitConfig, CharSamplerDatetimeEngineInitResource, CharSamplerEngineRunConfig, Sequence[str]]
):

    @classmethod
    def get_type_name(cls) -> str:
        return 'datetime'

    def __init__(self, init_config, init_resource=None):
        super().__init__(init_config, init_resource)
        assert init_resource
        self.lexicon_collection = init_resource.lexicon_collection
        self.delimiters = [
            d for d in _CANDIDATE_DELIMITERS
            if self.lexicon_collection.has_char(d)
        ]

        def to_ticks(ymd: Tuple[int, int, int]) -> int:
            return int(time.mktime(date(*ymd).timetuple()))

        self.ticks_begin = to_ticks(init_config.datetime_begin)
        self.ticks_end = to_ticks(init_config.datetime_end)

    def _randomize_format(self, fmt: str, rng: RandomGenerator) -> str:
        present = [d for d in self.delimiters if d in fmt]
        if not present:
            return fmt
        victim = rng_choice(rng, present)
        replacements = [d for d in self.delimiters if d != victim] + [' ']
        return fmt.replace(victim, rng_choice(rng, replacements))

    def sample_datetime_text(self, rng: RandomGenerator) -> str:
        stamp = datetime.fromtimestamp(
            int(rng.integers(self.ticks_begin, self.ticks_end + 1))
        ).replace(tzinfo=ZoneInfo(rng_choice(rng, self.init_config.timezones)))
        fmt = self._randomize_format(
            rng_choice(rng, self.init_config.datetime_formats), rng
        )
        rendered = stamp.strftime(fmt)
        kept = ''.join(
            c for c in rendered
            if c.isspace() or self.lexicon_collection.has_char(c)
        )
        return kept.strip()

    def run(self, run_config: CharSamplerEngineRunConfig,
            rng: Optional[RandomGenerator] = None) -> Sequence[str]:
        assert rng is not None
        if run_config.enable_aggregator_mode:
            return self.sample_datetime_text(rng)
        return fill_chars_to_num(self.sample_datetime_text, run_config.num_chars, rng)


char_sampler_datetime_engine_executor_factory = EngineExecutorFactory(
    CharSamplerDatetimeEngine
)
