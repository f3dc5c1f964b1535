"""Faker-style char sampler with a first-party fake-text provider.

Capability parity: vkit/engine/char_sampler/faker.py:27-134.  The third-party
``faker`` package is not part of this stack; a compact built-in provider
generates the same method families (address / ascii_email / dga / uri / word /
name / country_calling_code / phone_number), deterministically from the
numpy rng.
"""
from typing import List, Mapping, Optional, Sequence

import attr
from numpy.random import Generator as RandomGenerator

from ...utility import normalize_to_probs, rng_choice
from ..interface import Engine, EngineExecutorFactory
from .type import (
    CharSamplerEngineInitResource,
    CharSamplerEngineRunConfig,
    fill_chars_to_num,
)

_FIRST_NAMES = (
    'James', 'Mary', 'Robert', 'Patricia', 'John', 'Jennifer', 'Michael',
    'Linda', 'David', 'Elizabeth', 'William', 'Barbara', 'Wei', 'Fang',
    'Ming', 'Hua', 'Jing', 'Li', 'Yan', 'Lei',
)
_LAST_NAMES = (
    'Smith', 'Johnson', 'Williams', 'Brown', 'Jones', 'Garcia', 'Miller',
    'Davis', 'Wang', 'Li', 'Zhang', 'Liu', 'Chen', 'Yang', 'Huang', 'Zhao',
)
_WORDS = (
    'time', 'year', 'people', 'way', 'day', 'man', 'thing', 'woman', 'life',
    'child', 'world', 'school', 'state', 'family', 'student', 'group',
    'country', 'problem', 'hand', 'part', 'place', 'case', 'week', 'company',
    'system', 'program', 'question', 'work', 'government', 'number', 'night',
    'point', 'home', 'water', 'room', 'mother', 'area', 'money', 'story',
    'fact', 'month', 'lot', 'right', 'study', 'book', 'eye', 'job', 'word',
    'business', 'issue', 'side', 'kind', 'head', 'house', 'service', 'friend',
    'father', 'power', 'hour', 'game', 'line', 'end', 'member', 'law', 'car',
    'city', 'community', 'name', 'president', 'team', 'minute', 'idea', 'kid',
    'body', 'information', 'back', 'parent', 'face', 'others', 'level',
    'office', 'door', 'health', 'person', 'art', 'war', 'history', 'party',
    'result', 'change', 'morning', 'reason', 'research', 'girl', 'guy',
    'moment', 'air', 'teacher', 'force', 'education',
)
_STREET_SUFFIXES = ('Street', 'Avenue', 'Road', 'Lane', 'Drive', 'Court', 'Plaza')
_CITIES = (
    'Springfield', 'Riverton', 'Fairview', 'Kingston', 'Georgetown',
    'Salem', 'Madison', 'Clinton', 'Ashland', 'Burlington',
)
_STATES = ('CA', 'NY', 'TX', 'WA', 'IL', 'MA', 'FL', 'OH', 'PA', 'GA')
_TLDS = ('com', 'org', 'net', 'io', 'dev', 'cn', 'co')
_EMAIL_DOMAINS = ('example', 'mail', 'inbox', 'post', 'web')
_CALLING_CODES = ('+1', '+44', '+86', '+81', '+49', '+33', '+61', '+91', '+7')


class FakeTextProvider:
    """Deterministic fake text keyed off the numpy rng."""

    def word(self, rng: RandomGenerator) -> str:
        return rng_choice(rng, _WORDS)

    def name(self, rng: RandomGenerator) -> str:
        return f'{rng_choice(rng, _FIRST_NAMES)} {rng_choice(rng, _LAST_NAMES)}'

    def address(self, rng: RandomGenerator) -> str:
        return (
            f'{int(rng.integers(1, 9999))} '
            f'{rng_choice(rng, _LAST_NAMES)} {rng_choice(rng, _STREET_SUFFIXES)}, '
            f'{rng_choice(rng, _CITIES)}, {rng_choice(rng, _STATES)} '
            f'{int(rng.integers(10000, 99999))}'
        )

    def ascii_email(self, rng: RandomGenerator) -> str:
        user = rng_choice(rng, _FIRST_NAMES).lower()
        if rng.random() < 0.5:
            user += str(int(rng.integers(0, 99)))
        return (
            f'{user}@{rng_choice(rng, _EMAIL_DOMAINS)}.{rng_choice(rng, _TLDS)}'
        )

    def dga(self, rng: RandomGenerator) -> str:
        # Domain-generation-algorithm-looking hostname.
        length = int(rng.integers(8, 20))
        letters = 'abcdefghijklmnopqrstuvwxyz'
        host = ''.join(letters[int(i)] for i in rng.integers(0, 26, length))
        return f'{host}.{rng_choice(rng, _TLDS)}'

    def uri(self, rng: RandomGenerator) -> str:
        host = rng_choice(rng, _WORDS)
        path = '/'.join(rng_choice(rng, _WORDS) for _ in range(int(rng.integers(1, 4))))
        return f'https://www.{host}.{rng_choice(rng, _TLDS)}/{path}'

    def country_calling_code(self, rng: RandomGenerator) -> str:
        return rng_choice(rng, _CALLING_CODES)

    def phone_number(self, rng: RandomGenerator) -> str:
        return (
            f'{int(rng.integers(100, 999))}-{int(rng.integers(100, 999))}-'
            f'{int(rng.integers(1000, 9999))}'
        )


@attr.define
class CharSamplerFakerEngineInitConfig:
    local_to_weight: Mapping[str, float] = attr.field(
        factory=lambda: {'zh_CN': 4, 'zh_TW': 1, 'en_US': 5}
    )
    method_to_weight: Mapping[str, float] = attr.field(
        factory=lambda: {
            'address': 1,
            'ascii_email': 1,
            'dga': 1,
            'uri': 1,
            'word': 10,
            'name': 1,
            'country_calling_code': 1,
            'phone_number': 1,
        }
    )


CharSamplerFakerEngineInitResource = CharSamplerEngineInitResource


class CharSamplerFakerEngine(
    Engine[CharSamplerFakerEngineInitConfig, CharSamplerFakerEngineInitResource, CharSamplerEngineRunConfig, Sequence[str]]
):

    @classmethod
    def get_type_name(cls) -> str:
        return 'faker'

    def __init__(self, init_config, init_resource=None):
        super().__init__(init_config, init_resource)
        assert init_resource
        self.lexicon_collection = init_resource.lexicon_collection
        self.provider = FakeTextProvider()
        self.methods = sorted(init_config.method_to_weight)
        self.methods_probs = normalize_to_probs(
            [init_config.method_to_weight[m] for m in self.methods]
        )

    def sample_from_faker(self, rng: RandomGenerator) -> str:
        while True:
            method = rng_choice(rng, self.methods, probs=self.methods_probs)
            text = getattr(self.provider, method)(rng)
            segments: List[str] = []
            for segment in text.split():
                segment = ''.join(
                    char for char in segment if self.lexicon_collection.has_char(char)
                )
                if segment:
                    segments.append(segment)
            if segments:
                return ' '.join(segments)

    def run(self, run_config: CharSamplerEngineRunConfig,
            rng: Optional[RandomGenerator] = None) -> Sequence[str]:
        assert rng is not None
        if run_config.enable_aggregator_mode:
            return self.sample_from_faker(rng)
        return fill_chars_to_num(self.sample_from_faker, run_config.num_chars, rng)


char_sampler_faker_engine_executor_factory = EngineExecutorFactory(CharSamplerFakerEngine)
