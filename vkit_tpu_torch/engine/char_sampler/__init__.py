"""Char-sampler engine family registry."""
from ..interface import EngineExecutorAggregatorFactory
from . import corpus, datetime, faker, lexicon
from .corpus import CharSamplerCorpusEngine, CharSamplerCorpusEngineInitConfig
from .datetime import CharSamplerDatetimeEngine, CharSamplerDatetimeEngineInitConfig
from .faker import CharSamplerFakerEngine, CharSamplerFakerEngineInitConfig
from .func_collate import char_sampler_func_collate
from .lexicon import CharSamplerLexiconEngine, CharSamplerLexiconEngineInitConfig
from .type import CharSamplerEngineInitResource, CharSamplerEngineRunConfig

_FAMILY = (corpus, datetime, faker, lexicon)

char_sampler_corpus_engine_executor_factory = corpus.char_sampler_corpus_engine_executor_factory
char_sampler_datetime_engine_executor_factory = datetime.char_sampler_datetime_engine_executor_factory
char_sampler_faker_engine_executor_factory = faker.char_sampler_faker_engine_executor_factory
char_sampler_lexicon_engine_executor_factory = lexicon.char_sampler_lexicon_engine_executor_factory

char_sampler_engine_executor_aggregator_factory = EngineExecutorAggregatorFactory(
    [
        corpus.char_sampler_corpus_engine_executor_factory,
        datetime.char_sampler_datetime_engine_executor_factory,
        faker.char_sampler_faker_engine_executor_factory,
        lexicon.char_sampler_lexicon_engine_executor_factory,
    ],
    func_collate=char_sampler_func_collate,
)
