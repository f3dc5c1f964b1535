"""Char-sampler shared types and the text-assembly helpers.

Behavioral spec: vkit/engine/char_sampler/type.py + the shared
concatenate-and-trim loop in each sampler (re-derived).
"""
from typing import Callable, List, Sequence

import attr
from numpy.random import Generator as RandomGenerator

from ...element import LexiconCollection


@attr.define
class CharSamplerEngineInitResource:
    lexicon_collection: LexiconCollection


@attr.define
class CharSamplerEngineRunConfig:
    num_chars: int
    enable_aggregator_mode: bool = False


def trim_chars_tail(chars: List[str], num_chars: int) -> List[str]:
    """Cut to num_chars; a trailing space swaps for the next non-space."""
    if len(chars) <= num_chars:
        return chars
    overflow = chars[num_chars:]
    chars = chars[:num_chars]
    if chars[-1].isspace():
        chars.pop()
        assert not overflow[0].isspace()
        chars.append(overflow[0])
    return chars


def fill_chars_to_num(
    sample_text: Callable[[RandomGenerator], str],
    num_chars: int,
    rng: RandomGenerator,
) -> Sequence[str]:
    """Join sampled texts with single spaces to exactly ``num_chars``."""
    if num_chars <= 0:
        return []
    pieces: List[str] = []
    total = 0
    # total + (len(pieces) - 1) joining spaces must reach num_chars.
    while total + len(pieces) - 1 < num_chars:
        piece = sample_text(rng)
        pieces.append(piece)
        total += len(piece)
    return trim_chars_tail(list(' '.join(pieces)), num_chars)
