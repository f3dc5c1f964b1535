"""Aggregator-mode collate: draw from random engines until num_chars.

Behavioral spec: vkit/engine/char_sampler/func_collate.py:22-55
(re-derived on top of the shared trim helper).
"""
from typing import List, Sequence

from numpy.random import Generator as RandomGenerator

from .type import CharSamplerEngineRunConfig, trim_chars_tail


def char_sampler_func_collate(
    aggregator,
    run_config: CharSamplerEngineRunConfig,
    rng: RandomGenerator,
) -> Sequence[str]:
    if not run_config.enable_aggregator_mode:
        return aggregator.select_engine_executor(rng).run(run_config, rng)

    chars: List[str] = []
    while len(chars) < run_config.num_chars:
        if chars and rng.random() < 0.5:
            chars.append(' ')
        chars.extend(aggregator.select_engine_executor(rng).run(run_config, rng))
    chars = trim_chars_tail(chars, run_config.num_chars)
    assert len(chars) == run_config.num_chars
    return chars
