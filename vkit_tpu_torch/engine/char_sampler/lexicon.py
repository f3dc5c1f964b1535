"""Lexicon char sampler: per-char tag-weighted draws with optional spaces.

Behavioral spec: vkit/engine/char_sampler/lexicon.py:25-116 (re-derived).
"""
from typing import List, Mapping, Optional, Sequence

import attr
from numpy.random import Generator as RandomGenerator

from ...utility import normalize_to_probs, rng_choice
from ..interface import Engine, EngineExecutorFactory
from .type import CharSamplerEngineInitResource, CharSamplerEngineRunConfig

_SPACE_TAG = '__space'


@attr.define
class CharSamplerLexiconEngineInitConfig:
    tag_to_weight: Optional[Mapping[str, float]] = None
    prob_space: float = 0.0


CharSamplerLexiconEngineInitResource = CharSamplerEngineInitResource


class CharSamplerLexiconEngine(
    Engine[CharSamplerLexiconEngineInitConfig, CharSamplerLexiconEngineInitResource, CharSamplerEngineRunConfig, Sequence[str]]
):

    KEY_SPACE = _SPACE_TAG

    @classmethod
    def get_type_name(cls) -> str:
        return 'lexicon'

    def __init__(self, init_config, init_resource=None):
        super().__init__(init_config, init_resource)
        assert init_resource
        collection = init_resource.lexicon_collection
        self.lexicon_collection = collection
        self.tags = collection.tags

        def weight_of(tag: str) -> float:
            if init_config.tag_to_weight is None:
                # Default: proportional to the tag's lexicon count.
                return len(collection.tag_to_lexicons[tag])
            if tag not in init_config.tag_to_weight:
                raise RuntimeError(f'tag {tag!r} missing from tag_to_weight')
            return init_config.tag_to_weight[tag]

        self.tag_probs = normalize_to_probs([weight_of(t) for t in self.tags])

        # Space participates as a pseudo-tag with odds p / (1 - p).
        if init_config.prob_space > 0.0:
            self.tags_or_space = (*self.tags, _SPACE_TAG)
            self.tags_or_space_probs = normalize_to_probs(
                (*self.tag_probs,
                 init_config.prob_space / (1 - init_config.prob_space))
            )
        else:
            self.tags_or_space = self.tags
            self.tags_or_space_probs = self.tag_probs

    def _draw_tag(self, rng: RandomGenerator, allow_space: bool) -> str:
        tag = rng_choice(rng, self.tags_or_space, probs=self.tags_or_space_probs)
        if tag == _SPACE_TAG and not allow_space:
            tag = rng_choice(rng, self.tags, probs=self.tag_probs)
        return tag

    def run(self, run_config: CharSamplerEngineRunConfig,
            rng: Optional[RandomGenerator] = None) -> Sequence[str]:
        assert rng is not None
        count = run_config.num_chars
        if run_config.enable_aggregator_mode:
            count = int(rng.integers(1, run_config.num_chars + 1))

        chars: List[str] = []
        for idx in range(count):
            # No leading / trailing / consecutive spaces.
            allow_space = 0 < idx < count - 1 and not chars[idx - 1].isspace()
            tag = self._draw_tag(rng, allow_space)
            if tag == _SPACE_TAG:
                chars.append(' ')
            else:
                lexicon = rng_choice(rng, self.lexicon_collection.tag_to_lexicons[tag])
                chars.append(rng_choice(rng, lexicon.char_and_aliases))
        return chars


char_sampler_lexicon_engine_executor_factory = EngineExecutorFactory(
    CharSamplerLexiconEngine
)
