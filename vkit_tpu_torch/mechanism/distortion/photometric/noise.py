"""Noise-family photometric ops (4).

Behavioral spec: vkit/mechanism/distortion/photometric/noise.py:25-190
(re-derived).  The misspelled ``gaussion_noise`` name is part of the public
config surface and is kept.  All four replay from a frozen rng state.
"""
from typing import Any, Mapping, Optional

import attr
import numpy as np

from ....element import Image
from ..interface import DistortionConfig
from .base import clip_u8, photometric_op


@attr.define
class GaussionNoiseConfig(DistortionConfig):
    std: float
    rng_state: Optional[Mapping[str, Any]] = None


@photometric_op(GaussionNoiseConfig)
def gaussion_noise(config: GaussionNoiseConfig, image: Image, rng) -> Image:
    assert rng is not None
    noise = np.round(rng.normal(0, config.std, image.mat.shape))
    return Image(mat=clip_u8(image.mat.astype(np.int16) + noise.astype(np.int16)))


@attr.define
class PoissonNoiseConfig(DistortionConfig):
    rng_state: Optional[Mapping[str, Any]] = None


@photometric_op(PoissonNoiseConfig)
def poisson_noise(config: PoissonNoiseConfig, image: Image, rng) -> Image:
    assert rng is not None
    return Image(mat=clip_u8(rng.poisson(image.mat.astype(np.float32))))


@attr.define
class ImpulseNoiseConfig(DistortionConfig):
    prob_salt: float
    prob_pepper: float
    rng_state: Optional[Mapping[str, Any]] = None


@photometric_op(ImpulseNoiseConfig)
def impulse_noise(config: ImpulseNoiseConfig, image: Image, rng) -> Image:
    assert rng is not None
    prob_keep = 1.0 - config.prob_salt - config.prob_pepper
    assert prob_keep >= 0.0
    lottery = rng.choice(
        (0, 1, 2), size=image.shape,
        p=[prob_keep, config.prob_salt, config.prob_pepper],
    )
    mat = image.mat.copy()
    mat[lottery == 1] = 255
    mat[lottery == 2] = 0
    return Image(mat=mat)


@attr.define
class SpeckleNoiseConfig(DistortionConfig):
    std: float
    rng_state: Optional[Mapping[str, Any]] = None


@photometric_op(SpeckleNoiseConfig)
def speckle_noise(config: SpeckleNoiseConfig, image: Image, rng) -> Image:
    assert rng is not None
    mat = image.mat.astype(np.float32)
    gain = rng.normal(0, config.std, mat.shape)
    return Image(mat=clip_u8(mat * (1.0 + gain)))
