"""RNG + misc helpers.

Capability parity: vkit/utility/opt.py (rng_choice:95, rng_choice_with_size:103,
rng_shuffle:113, normalize_to_probs:205, normalize_to_keys_and_probs:217,
camel-to-snake naming:235-243, resize-interpolation sampling:125-148).
"""
import re
from typing import Dict, List, Sequence, Tuple, TypeVar

import numpy as np
from numpy.random import Generator as RandomGenerator

_T = TypeVar('_T')


def rng_choice(rng: RandomGenerator, items: Sequence[_T], probs=None) -> _T:
    # Bit-identical to Generator.choice but without its per-call p
    # validation (tens of thousands of draws per prepared page batch):
    # choice without p draws one integers(); with p it inverse-CDF
    # samples exactly one random() — both reproduced here verbatim.
    if probs is None:
        return items[int(rng.integers(len(items)))]
    cdf = np.cumsum(np.asarray(probs, dtype=np.float64))
    cdf /= cdf[-1]
    return items[int(cdf.searchsorted(rng.random(), 'right'))]


def rng_choice_with_size(
    rng: RandomGenerator,
    items: Sequence[_T],
    size: int,
    probs=None,
    replace: bool = True,
) -> List[_T]:
    if replace:  # same draw stream as Generator.choice (see rng_choice)
        if probs is None:
            indices = rng.integers(0, len(items), size=size)
        else:
            cdf = np.cumsum(np.asarray(probs, dtype=np.float64))
            cdf /= cdf[-1]
            indices = cdf.searchsorted(rng.random(size), 'right')
    else:
        indices = rng.choice(len(items), p=probs, size=size, replace=False)
    return [items[int(idx)] for idx in indices]


def rng_shuffle(rng: RandomGenerator, items: Sequence[_T]) -> List[_T]:
    indices = list(range(len(items)))
    rng.shuffle(indices)
    return [items[idx] for idx in indices]


def normalize_to_probs(weights: Sequence[float]) -> List[float]:
    total = sum(weights)
    assert total > 0
    return [w / total for w in weights]


def normalize_to_keys_and_probs(
    key_weight_items: Sequence[Tuple[_T, float]],
) -> Tuple[List[_T], List[float]]:
    keys: List[_T] = []
    weights: List[float] = []
    for key, weight in key_weight_items:
        keys.append(key)
        weights.append(weight)
    return keys, normalize_to_probs(weights)


_CAMEL_RE_0 = re.compile(r'(.)([A-Z][a-z]+)')
_CAMEL_RE_1 = re.compile(r'([a-z0-9])([A-Z])')


def convert_camel_case_name_to_snake_case_name(name: str) -> str:
    return _CAMEL_RE_1.sub(r'\1_\2', _CAMEL_RE_0.sub(r'\1_\2', name)).lower()


def get_config_class_snake_case_name(class_name: str) -> str:
    name = convert_camel_case_name_to_snake_case_name(class_name)
    if name.endswith('_config'):
        name = name[:-len('_config')]
    return name


def sample_resize_interpolation(rng: RandomGenerator, include_area: bool = False):
    """Sample a resize interpolation (EXACT-variant whitelist).

    Capability parity: vkit/utility/opt.py:125-148
    (sample_cv_resize_interpolation).
    """
    from ..ops.resize_taps import Interpolation

    flags = (
        Interpolation.NEAREST_EXACT,
        Interpolation.LINEAR_EXACT,
        Interpolation.CUBIC,
        Interpolation.LANCZOS4,
    )
    if include_area:
        flags = (*flags, Interpolation.AREA)
    return rng_choice(rng, flags)


def clip_val(val: float, size: int) -> float:
    return float(np.clip(val, 0, size - 1))


def resize_val(val: float, size: int, resized_size: int) -> float:
    return val * resized_size / size
