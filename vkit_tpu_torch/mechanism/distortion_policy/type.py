"""Policy framework v2: a policy = (distortion, knobs, sampler function).

A *sampler* is a plain function ``sampler(knobs, level, shape, rng) ->
config-dict-or-instance``; knobs are an attrs class holding the tunable
parameter table (field names are part of the public config surface).  This
replaces the reference's per-policy generator-class triple and its generic
reflection (behavioral spec: vkit/mechanism/distortion_policy/type.py:50-152;
re-derived).
"""
from typing import Any, Callable, Generic, Mapping, Optional, Type, TypeVar, Union

from numpy.random import Generator as RandomGenerator

from ...utility import PathType, dyn_structure
from ..distortion.interface import Distortion

_T_KNOBS = TypeVar('_T_KNOBS')

Sampler = Callable[..., Any]  # (knobs, level, shape, rng) -> config


class DistortionPolicy(Generic[_T_KNOBS]):
    """A leveled random-config wrapper around one distortion."""

    def __init__(self, distortion: Distortion, knobs: _T_KNOBS, sampler: Sampler):
        self.distortion = distortion
        self.knobs = knobs
        self.sampler = sampler

    @property
    def name(self) -> str:
        return self.distortion.config_cls.get_name()

    def __repr__(self):
        return f'DistortionPolicy({self.name})'

    def sample_config(self, level: int, shape, rng: RandomGenerator):
        assert 1 <= level <= 10
        raw = self.sampler(self.knobs, level, shape, rng)
        return dyn_structure(raw, self.distortion.config_cls)

    def distort(
        self,
        level: int,
        shapable_or_shape=None,
        image=None,
        mask=None,
        score_map=None,
        point=None,
        points=None,
        corner_points=None,
        polygon=None,
        polygons=None,
        rng: Optional[RandomGenerator] = None,
        enable_debug: bool = False,
    ):
        return self.distortion.distort(
            config_or_config_generator=(
                lambda shape, gen_rng: self.sample_config(level, shape, gen_rng)
            ),
            shapable_or_shape=shapable_or_shape,
            image=image,
            mask=mask,
            score_map=score_map,
            point=point,
            points=points,
            corner_points=corner_points,
            polygon=polygon,
            polygons=polygons,
            rng=rng,
            get_config=enable_debug,
            get_state=enable_debug,
        )


class DistortionPolicyFactory(Generic[_T_KNOBS]):

    def __init__(self, distortion: Distortion, knobs_cls: Type[_T_KNOBS],
                 sampler: Sampler):
        self.distortion = distortion
        self.knobs_cls = knobs_cls
        self.sampler = sampler

    @property
    def name(self) -> str:
        return self.distortion.config_cls.get_name()

    def create(
        self,
        config: Optional[Union[Mapping[str, Any], PathType, _T_KNOBS]] = None,
    ) -> DistortionPolicy[_T_KNOBS]:
        knobs = dyn_structure(
            config, self.knobs_cls,
            support_path_type=True, support_none_type=True,
        )
        return DistortionPolicy(self.distortion, knobs, self.sampler)


def policy_factory(distortion: Distortion, knobs_cls: Type[_T_KNOBS]):
    """Decorator: a sampler function becomes a DistortionPolicyFactory."""

    def wrap(sampler: Sampler) -> DistortionPolicyFactory:
        return DistortionPolicyFactory(distortion, knobs_cls, sampler)

    return wrap
