"""Randomized distortion staging: weighted policy draws with conflict
groups, per-draw level sampling, corner-point injection and post-trim.

Behavioral spec: vkit/mechanism/distortion_policy/random_distortion.py
(re-derived; default stage structure, weight tables and conflict groups
are config-surface and match exactly).
"""
import logging
from typing import Any, List, Mapping, Optional, Sequence, Tuple, Union

import attr
import numpy as np
from numpy.random import Generator as RandomGenerator

from ...element import Box, Image, Mask, Point, PointTuple, Polygon, ScoreMap
from ...utility import PathType, dyn_structure, normalize_to_probs, \
    rng_choice_with_size
from ..distortion.interface import DistortionResult, _shape_from
from .geometric import affine, camera, mls
from .opt import LEVEL_MAX, LEVEL_MIN
from .photometric import blur, color, effect, noise, streak
from .type import DistortionPolicy, DistortionPolicyFactory

logger = logging.getLogger(__name__)


@attr.define
class RandomDistortionDebug:
    distortion_names: List[str] = attr.field(factory=list)
    distortion_levels: List[int] = attr.field(factory=list)
    distortion_images: List[Image] = attr.field(factory=list)
    distortion_configs: List[Any] = attr.field(factory=list)
    distortion_states: List[Any] = attr.field(factory=list)


@attr.define
class RandomDistortionStageConfig:
    distortion_policies: Sequence[DistortionPolicy]
    distortion_policy_weights: Sequence[float]
    prob_enable: float
    num_distortions_min: int
    num_distortions_max: int
    inject_corner_points: bool = False
    conflict_control_keyword_groups: Sequence[Sequence[str]] = ()
    force_sample_level_in_full_range: bool = False


def _conflict_free(policies: Sequence[DistortionPolicy],
                   keyword_groups: Sequence[Sequence[str]]) -> bool:
    """At most one sampled policy per conflict keyword group."""
    for keywords in keyword_groups:
        hits = sum(
            1 for policy in policies
            if any(keyword in policy.name for keyword in keywords)
        )
        if hits > 1:
            return False
    return True


def _border_lattice(shape: Tuple[int, int]) -> PointTuple:
    """Points along the canvas border, ~quarter-side spacing, so the trim
    step can recover the content bounding box after any warp."""
    height, width = shape
    step = min(height // 4, width // 4)
    assert step > 0

    ys = list(range(0, height, step))
    if ys[-1] < height - 1:
        ys.append(height - 1)
    xs = [x for x in range(step, width - 1, step)]

    border: List[Point] = []
    for x in (0, width - 1):
        border.extend(Point.create(y=y, x=x) for y in ys)
    for y in (0, height - 1):
        border.extend(Point.create(y=y, x=x) for x in xs)
    return PointTuple(border)


class RandomDistortionStage:
    """One stage: maybe-enabled weighted draws applied sequentially."""

    def __init__(self, config: RandomDistortionStageConfig):
        self.config = config
        self.probs = normalize_to_probs(config.distortion_policy_weights)

    def sample_distortion_policies(self, rng: RandomGenerator
                                   ) -> Sequence[DistortionPolicy]:
        count = int(rng.integers(
            self.config.num_distortions_min, self.config.num_distortions_max + 1
        ))
        if count <= 0:
            return ()
        for _ in range(5):
            drawn = rng_choice_with_size(
                rng, self.config.distortion_policies,
                size=count, probs=self.probs, replace=False,
            )
            if _conflict_free(drawn, self.config.conflict_control_keyword_groups):
                return drawn
        logger.warning(f'no conflict-free draw of {count} policies; skipping stage')
        return ()

    def apply_distortions(
        self,
        result: DistortionResult,
        level_min: int,
        level_max: int,
        rng: RandomGenerator,
        debug: Optional[RandomDistortionDebug] = None,
    ) -> DistortionResult:
        if rng.random() > self.config.prob_enable:
            return result

        if self.config.inject_corner_points:
            result.corner_points = _border_lattice(result.shape)

        if self.config.force_sample_level_in_full_range:
            level_min, level_max = LEVEL_MIN, LEVEL_MAX

        for policy in self.sample_distortion_policies(rng):
            level = int(rng.integers(level_min, level_max + 1))
            result = policy.distort(
                level=level,
                shapable_or_shape=result.shape,
                image=result.image,
                mask=result.mask,
                score_map=result.score_map,
                point=result.point,
                points=result.points,
                corner_points=result.corner_points,
                polygon=result.polygon,
                polygons=result.polygons,
                rng=rng,
                enable_debug=bool(debug),
            )
            if debug is not None:
                assert result.image
                debug.distortion_images.append(result.image)
                debug.distortion_names.append(policy.name)
                debug.distortion_levels.append(level)
                debug.distortion_configs.append(result.config)
                debug.distortion_states.append(result.state)
            result.config = None
            result.state = None
        return result


def _collect_result_xy(result: DistortionResult) -> np.ndarray:
    """All geometry carried by a result, as one (V, 2) int array."""
    chunks: List[np.ndarray] = []
    for points in (result.corner_points, result.points):
        if points:
            chunks.append(points.to_np_array())
    if result.point:
        chunks.append(np.asarray([result.point.to_xy_pair()], dtype=np.int32))
    if result.polygon:
        chunks.append(result.polygon.to_np_array())
    if result.polygons:
        chunks.extend(p.to_np_array() for p in result.polygons)
    return np.concatenate(chunks, axis=0)


def trim_result_to_content(result: DistortionResult) -> DistortionResult:
    """Crop the canvas to the geometry bounding box (needs corner points)."""
    if not result.corner_points:
        return result

    height, width = result.shape
    xy = _collect_result_xy(result)
    box = Box(
        up=int(xy[:, 1].min()), down=int(xy[:, 1].max()),
        left=int(xy[:, 0].min()), right=int(xy[:, 0].max()),
    )

    slack = (box.up, height - 1 - box.down, box.left, width - 1 - box.right)
    # Tolerate 1px of rounding error outside the canvas.
    assert all(s >= -1 for s in slack)
    if all(s <= 0 for s in slack):
        return result

    up, down = max(0, box.up), min(height - 1, box.down)
    left, right = max(0, box.left), min(width - 1, box.right)
    dy, dx = -max(0, box.up), -max(0, box.left)

    if result.image:
        result.image = result.image.to_cropped_image(up=up, down=down,
                                                     left=left, right=right)
    if result.mask:
        result.mask = result.mask.to_cropped_mask(up=up, down=down,
                                                  left=left, right=right)
    if result.score_map:
        result.score_map = result.score_map.to_cropped_score_map(
            up=up, down=down, left=left, right=right
        )
    if result.point:
        result.point = result.point.to_shifted_point(dy, dx)
    if result.points:
        result.points = result.points.to_shifted_points(dy, dx)
    if result.polygon:
        result.polygon = result.polygon.to_shifted_polygon(dy, dx)
    if result.polygons:
        result.polygons = [p.to_shifted_polygon(dy, dx) for p in result.polygons]
    result.shape = (down - up + 1, right - left + 1)
    return result


class RandomDistortion:

    def __init__(self, configs: Sequence[RandomDistortionStageConfig],
                 level_min: int, level_max: int):
        self.stages = [RandomDistortionStage(cfg) for cfg in configs]
        self.level_min = level_min
        self.level_max = level_max

    def distort(
        self,
        rng: RandomGenerator,
        shapable_or_shape=None,
        image: Optional[Image] = None,
        mask: Optional[Mask] = None,
        score_map: Optional[ScoreMap] = None,
        point: Optional[Point] = None,
        points=None,
        polygon: Optional[Polygon] = None,
        polygons=None,
        debug: Optional[RandomDistortionDebug] = None,
    ) -> DistortionResult:
        if shapable_or_shape is None:
            shapable_or_shape = image or mask or score_map
        result = DistortionResult(
            shape=_shape_from(shapable_or_shape),
            image=image,
            mask=mask,
            score_map=score_map,
            point=point,
            points=PointTuple(points) if points else None,
            polygon=polygon,
            polygons=tuple(polygons) if polygons else None,
        )
        for stage in self.stages:
            result = stage.apply_distortions(
                result, self.level_min, self.level_max, rng, debug
            )
        return trim_result_to_content(result)


@attr.define
class RandomDistortionFactoryConfig:
    # Photometric stage.
    prob_photometric: float = 1.0
    num_photometric_min: int = 0
    num_photometric_max: int = 2
    photometric_conflict_control_keyword_groups: Sequence[Sequence[str]] = attr.field(
        factory=lambda: [
            ['blur', 'pixelation', 'jpeg'],
            ['noise'],
        ]
    )
    # Geometric stage.
    prob_geometric: float = 0.75
    force_post_rotate: bool = False
    # Shared.
    level_min: int = LEVEL_MIN
    level_max: int = LEVEL_MAX
    disabled_policy_names: Sequence[str] = attr.field(factory=list)
    name_to_policy_config: Mapping[str, Any] = attr.field(factory=dict)
    name_to_policy_weight: Mapping[str, float] = attr.field(factory=dict)


# Default catalog: family -> (factories, total family weight).  Weight is
# split evenly inside each family (reference weight tables).
_PHOTOMETRIC_FAMILIES = (
    ((color.mean_shift_policy_factory,
      color.color_shift_policy_factory,
      color.brightness_shift_policy_factory,
      color.std_shift_policy_factory,
      color.boundary_equalization_policy_factory,
      color.histogram_equalization_policy_factory,
      color.complement_policy_factory,
      color.posterization_policy_factory,
      color.color_balance_policy_factory,
      color.channel_permutation_policy_factory), 10.0),
    ((blur.gaussian_blur_policy_factory,
      blur.defocus_blur_policy_factory,
      blur.motion_blur_policy_factory,
      blur.glass_blur_policy_factory,
      blur.zoom_in_blur_policy_factory), 1.0),
    ((noise.gaussion_noise_policy_factory,
      noise.poisson_noise_policy_factory,
      noise.impulse_noise_policy_factory,
      noise.speckle_noise_policy_factory), 3.0),
    ((effect.jpeg_quality_policy_factory,
      effect.pixelation_policy_factory,
      effect.fog_policy_factory), 1.0),
    ((streak.line_streak_policy_factory,
      streak.rectangle_streak_policy_factory,
      streak.ellipse_streak_policy_factory), 1.0),
)

_GEOMETRIC_FAMILIES = (
    ((affine.shear_hori_policy_factory,
      affine.shear_vert_policy_factory,
      affine.rotate_policy_factory,
      affine.skew_hori_policy_factory,
      affine.skew_vert_policy_factory), 1.0),
    ((mls.similarity_mls_policy_factory,), 1.0),
    ((camera.camera_plane_only_policy_factory,
      camera.camera_cubic_curve_policy_factory,
      camera.camera_plane_line_fold_policy_factory,
      camera.camera_plane_line_curve_policy_factory), 1.0),
)


def _flatten_families(families):
    factories: List[DistortionPolicyFactory] = []
    weights: List[float] = []
    for group, family_weight in families:
        factories.extend(group)
        weights.extend([family_weight / len(group)] * len(group))
    return factories, weights


class RandomDistortionFactory:

    def __init__(
        self,
        photometric_policy_factories_and_default_weights_sum_pairs=_PHOTOMETRIC_FAMILIES,
        geometric_policy_factories_and_default_weights_sum_pairs=_GEOMETRIC_FAMILIES,
    ):
        self.photometric_factories, self.photometric_weights = _flatten_families(
            photometric_policy_factories_and_default_weights_sum_pairs
        )
        self.geometric_factories, self.geometric_weights = _flatten_families(
            geometric_policy_factories_and_default_weights_sum_pairs
        )

    @staticmethod
    def _instantiate(factories, default_weights,
                     config: RandomDistortionFactoryConfig):
        disabled = set(config.disabled_policy_names)
        policies: List[DistortionPolicy] = []
        weights: List[float] = []
        for factory, default_weight in zip(factories, default_weights):
            if factory.name in disabled:
                continue
            policies.append(factory.create(
                config.name_to_policy_config.get(factory.name)
            ))
            weights.append(
                config.name_to_policy_weight.get(factory.name, default_weight)
            )
        return policies, weights

    @staticmethod
    def _structure(config) -> RandomDistortionFactoryConfig:
        return dyn_structure(
            config, RandomDistortionFactoryConfig,
            support_path_type=True, support_none_type=True,
        )

    def create_photometric_stage_config(
        self,
        config: Optional[Union[Mapping[str, Any], PathType,
                               RandomDistortionFactoryConfig]] = None,
    ) -> RandomDistortionStageConfig:
        """The photometric stage alone (used by mechanism.batched_random)."""
        config = self._structure(config)
        policies, weights = self._instantiate(
            self.photometric_factories, self.photometric_weights, config
        )
        return RandomDistortionStageConfig(
            distortion_policies=policies,
            distortion_policy_weights=weights,
            prob_enable=config.prob_photometric,
            num_distortions_min=config.num_photometric_min,
            num_distortions_max=config.num_photometric_max,
            conflict_control_keyword_groups=(
                config.photometric_conflict_control_keyword_groups
            ),
        )

    def create_geometric_stage_config(
        self,
        config: Optional[Union[Mapping[str, Any], PathType,
                               RandomDistortionFactoryConfig]] = None,
    ) -> RandomDistortionStageConfig:
        """The geometric stage alone (used by mechanism.batched_random)."""
        config = self._structure(config)
        policies, weights = self._instantiate(
            self.geometric_factories, self.geometric_weights, config
        )
        return RandomDistortionStageConfig(
            distortion_policies=policies,
            distortion_policy_weights=weights,
            prob_enable=config.prob_geometric,
            num_distortions_min=1,
            num_distortions_max=1,
        )

    def create(
        self,
        config: Optional[Union[Mapping[str, Any], PathType,
                               RandomDistortionFactoryConfig]] = None,
    ) -> RandomDistortion:
        config = self._structure(config)
        stages = [self.create_photometric_stage_config(config)]

        geo_policies, geo_weights = self._instantiate(
            self.geometric_factories, self.geometric_weights, config
        )

        post_rotate = None
        if config.force_post_rotate:
            idx = next(
                i for i, p in enumerate(geo_policies) if p.name == 'rotate'
            )
            post_rotate = geo_policies.pop(idx)
            geo_weights.pop(idx)

        stages.append(RandomDistortionStageConfig(
            distortion_policies=geo_policies,
            distortion_policy_weights=geo_weights,
            prob_enable=config.prob_geometric,
            num_distortions_min=1,
            num_distortions_max=1,
            inject_corner_points=config.force_post_rotate,
        ))
        if post_rotate is not None:
            stages.append(RandomDistortionStageConfig(
                distortion_policies=[post_rotate],
                distortion_policy_weights=[1.0],
                prob_enable=1.0,
                num_distortions_min=1,
                num_distortions_max=1,
                force_sample_level_in_full_range=True,
            ))

        return RandomDistortion(stages, config.level_min, config.level_max)


random_distortion_factory = RandomDistortionFactory()
