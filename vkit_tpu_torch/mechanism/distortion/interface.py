"""Distortion framework v2: two op kinds, one orchestrator.

A distortion is either

* **photometric** — an image-space function ``apply(config, image, rng) ->
  Image``; labels (masks / points / polygons) pass through unchanged; or
* **geometric** — a planner ``plan(config, shape, rng) -> WarpPlan``: every
  geometric op canonicalizes to one backward-warp representation (analytic
  matrix or dense displacement field + forward point transform), and a single
  engine (warp_plan.py) applies it to rasters and geometry alike.

This replaces the reference's per-distortion composition of eight optional
per-element functions (behavioral spec: vkit/mechanism/distortion/
interface.py:49-913; re-derived).  RNG-consuming configs freeze the numpy
bit-generator state on first use and replay it per element, so a sampled
config is exactly reproducible.
"""
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple, Union

import attr
import numpy as np
from numpy.random import Generator as RandomGenerator
from numpy.random import default_rng

from ...element import (
    Image,
    Mask,
    Point,
    PointList,
    PointTuple,
    Polygon,
    ScoreMap,
)
from ...utility import dyn_structure, get_config_class_snake_case_name
from .warp_plan import WarpPlan, warp_active_mask, warp_image, warp_mask, \
    warp_points, warp_score_map


class DistortionConfig:
    """Base for distortion configs (attrs classes in the catalog).

    A config that declares an ``rng_state`` field is rng-consuming: the
    orchestrator freezes the exterior rng's state into it on first use and
    replays from that state on every apply.
    """

    _snake_name: str = ''

    @classmethod
    def get_name(cls) -> str:
        if not cls.__dict__.get('_snake_name'):
            cls._snake_name = get_config_class_snake_case_name(cls.__name__)
        return cls._snake_name

    @property
    def name(self) -> str:
        return self.get_name()

    @classmethod
    def consumes_rng(cls) -> bool:
        return attr.has(cls) and any(
            f.name == 'rng_state' for f in attr.fields(cls)  # type: ignore[arg-type]
        )

    # Back-compat spelling.
    @property
    def supports_rng_state(self) -> bool:
        return self.consumes_rng()


ConfigLike = Union[
    DistortionConfig,
    Mapping[str, Any],
    Callable[[Tuple[int, int], RandomGenerator], Any],
]


@attr.define
class DistortionResult:
    shape: Tuple[int, int]
    image: Optional[Image] = None
    mask: Optional[Mask] = None
    score_map: Optional[ScoreMap] = None
    active_mask: Optional[Mask] = None
    point: Optional[Point] = None
    points: Optional[PointTuple] = None
    corner_points: Optional[PointTuple] = None
    polygon: Optional[Polygon] = None
    polygons: Optional[Sequence[Polygon]] = None
    config: Optional[Any] = None
    state: Optional[Any] = None
    meta: Optional[Mapping[str, Any]] = None


def _shape_from(shapable_or_shape) -> Tuple[int, int]:
    if isinstance(shapable_or_shape, (tuple, list)):
        h, w = shapable_or_shape
        return int(h), int(w)
    return shapable_or_shape.shape


class Distortion:
    """Shared orchestration: config resolution, rng freeze/replay, clip."""

    def __init__(self, config_cls):
        self.config_cls = config_cls

    @property
    def is_geometric(self) -> bool:
        raise NotImplementedError()

    # -- config / rng plumbing ------------------------------------------------

    def resolve_config(self, config_like: ConfigLike, shape: Tuple[int, int],
                       rng: Optional[RandomGenerator]):
        """Returns (config, apply_rng)."""
        if callable(config_like) and not isinstance(config_like, DistortionConfig):
            if rng is None:
                raise RuntimeError('a config generator needs an rng')
            config_like = config_like(shape, rng)
        config = dyn_structure(config_like, self.config_cls)

        if not config.consumes_rng():
            return config, None
        if getattr(config, 'rng_state', None) is None:
            if rng is None:
                raise RuntimeError(f'{config.name}: rng required to seed rng_state')
            config.rng_state = rng.bit_generator.state
            rng.random()  # Advance the exterior stream so reruns differ.
        return config, self._replay_rng(config)

    @staticmethod
    def _replay_rng(config) -> RandomGenerator:
        rng = default_rng()
        rng.bit_generator.state = config.rng_state
        return rng

    def generate_config(self, config_like: ConfigLike, shapable_or_shape,
                        rng: Optional[RandomGenerator] = None):
        config, _ = self.resolve_config(config_like, _shape_from(shapable_or_shape), rng)
        return config

    # Subclasses implement the element transforms + distort().


class PhotometricDistortion(Distortion):

    def __init__(self, config_cls, apply_image):
        super().__init__(config_cls)
        self._apply_image = apply_image

    @property
    def is_geometric(self) -> bool:
        return False

    def generate_state(self, config_like, shapable_or_shape, rng=None):
        return None

    def distort_image(self, config_like: ConfigLike, image: Image,
                      rng: Optional[RandomGenerator] = None,
                      state=None) -> Image:
        config, apply_rng = self.resolve_config(config_like, image.shape, rng)
        return self._apply_image(config, image, apply_rng)

    def distort(
        self,
        config_or_config_generator: ConfigLike,
        shapable_or_shape=None,
        image: Optional[Image] = None,
        mask: Optional[Mask] = None,
        score_map: Optional[ScoreMap] = None,
        point: Optional[Point] = None,
        points=None,
        corner_points=None,
        polygon: Optional[Polygon] = None,
        polygons=None,
        get_active_mask: bool = False,
        get_config: bool = False,
        get_state: bool = False,
        disable_clip_result_elements: bool = False,
        rng: Optional[RandomGenerator] = None,
    ) -> DistortionResult:
        if shapable_or_shape is None:
            shapable_or_shape = image or mask or score_map
        shape = _shape_from(shapable_or_shape)
        config, apply_rng = self.resolve_config(config_or_config_generator, shape, rng)

        result = DistortionResult(shape=shape)
        if image is not None:
            result.image = self._apply_image(config, image, apply_rng)
            assert result.image.shape == shape
        # Labels are untouched by photometric ops.
        result.mask = mask
        result.score_map = score_map
        result.point = point
        result.points = PointTuple(points) if points else None
        result.corner_points = PointTuple(corner_points) if corner_points else None
        result.polygon = polygon
        result.polygons = tuple(polygons) if polygons else None
        if get_active_mask:
            result.active_mask = Mask.from_shape(shape, value=1)
        if get_config:
            result.config = config
        if get_state:
            result.state = None
        return result


class GeometricDistortion(Distortion):

    def __init__(self, config_cls, plan_fn):
        super().__init__(config_cls)
        self._plan_fn = plan_fn

    @property
    def is_geometric(self) -> bool:
        return True

    def plan(self, config_like: ConfigLike, shapable_or_shape,
             rng: Optional[RandomGenerator] = None) -> WarpPlan:
        shape = _shape_from(shapable_or_shape)
        config, apply_rng = self.resolve_config(config_like, shape, rng)
        return self._plan_fn(config, shape, apply_rng)

    # ``state`` for a geometric distortion IS its warp plan.
    def generate_state(self, config_like, shapable_or_shape, rng=None) -> WarpPlan:
        return self.plan(config_like, shapable_or_shape, rng)

    def distort_image(self, config_like, image: Image,
                      rng: Optional[RandomGenerator] = None,
                      state: Optional[WarpPlan] = None) -> Image:
        plan = state or self.plan(config_like, image.shape, rng)
        return warp_image(plan, image)

    def distort_mask(self, config_like, mask: Mask,
                     rng: Optional[RandomGenerator] = None,
                     state: Optional[WarpPlan] = None) -> Mask:
        plan = state or self.plan(config_like, mask.shape, rng)
        return warp_mask(plan, mask)

    def distort_score_map(self, config_like, score_map: ScoreMap,
                          rng: Optional[RandomGenerator] = None,
                          state: Optional[WarpPlan] = None) -> ScoreMap:
        plan = state or self.plan(config_like, score_map.shape, rng)
        return warp_score_map(plan, score_map)

    def distort_point(self, config_like, shapable_or_shape, point: Point,
                      rng: Optional[RandomGenerator] = None,
                      state: Optional[WarpPlan] = None) -> Point:
        plan = state or self.plan(config_like, shapable_or_shape, rng)
        return warp_points(plan, PointTuple.from_point(point))[0]

    def distort_points(self, config_like, shapable_or_shape, points,
                       rng: Optional[RandomGenerator] = None,
                       state: Optional[WarpPlan] = None) -> PointTuple:
        plan = state or self.plan(config_like, shapable_or_shape, rng)
        return warp_points(plan, PointTuple(points))

    def distort_polygon(self, config_like, shapable_or_shape, polygon: Polygon,
                        rng: Optional[RandomGenerator] = None,
                        state: Optional[WarpPlan] = None) -> Polygon:
        plan = state or self.plan(config_like, shapable_or_shape, rng)
        return Polygon.from_np_xy(plan.map_points(polygon.np_xy))

    def distort_polygons(self, config_like, shapable_or_shape, polygons,
                         rng: Optional[RandomGenerator] = None,
                         state: Optional[WarpPlan] = None) -> Sequence[Polygon]:
        plan = state or self.plan(config_like, shapable_or_shape, rng)
        # One vectorized transform over the concatenation of all rings.
        polygons = tuple(polygons)
        if not polygons:
            return ()
        counts = [p.num_points for p in polygons]
        merged = np.concatenate([p.np_xy for p in polygons], axis=0)
        mapped = plan.map_points(merged)
        out = []
        offset = 0
        for count in counts:
            out.append(Polygon.from_np_xy(mapped[offset:offset + count]))
            offset += count
        return out

    def get_active_mask(self, config_like, shapable_or_shape,
                        rng: Optional[RandomGenerator] = None,
                        state: Optional[WarpPlan] = None) -> Mask:
        plan = state or self.plan(config_like, shapable_or_shape, rng)
        return warp_active_mask(plan)

    def distort(
        self,
        config_or_config_generator: ConfigLike,
        shapable_or_shape=None,
        image: Optional[Image] = None,
        mask: Optional[Mask] = None,
        score_map: Optional[ScoreMap] = None,
        point: Optional[Point] = None,
        points=None,
        corner_points=None,
        polygon: Optional[Polygon] = None,
        polygons=None,
        get_active_mask: bool = False,
        get_config: bool = False,
        get_state: bool = False,
        disable_clip_result_elements: bool = False,
        rng: Optional[RandomGenerator] = None,
    ) -> DistortionResult:
        if shapable_or_shape is None:
            shapable_or_shape = image or mask or score_map
        shape = _shape_from(shapable_or_shape)
        config, apply_rng = self.resolve_config(config_or_config_generator, shape, rng)
        plan = self._plan_fn(config, shape, apply_rng)

        result = DistortionResult(shape=plan.dst_shape)
        if image is not None:
            result.image = warp_image(plan, image)
            assert result.image.shape == result.shape
        if mask is not None:
            result.mask = warp_mask(plan, mask)
            assert result.mask.shape == result.shape
        if score_map is not None:
            result.score_map = warp_score_map(plan, score_map)
            assert result.score_map.shape == result.shape
        if point is not None:
            result.point = warp_points(plan, PointTuple.from_point(point))[0]
        if points:
            result.points = warp_points(plan, PointTuple(points))
        if corner_points:
            result.corner_points = warp_points(plan, PointTuple(corner_points))
        if polygon is not None:
            result.polygon = Polygon.from_np_xy(plan.map_points(polygon.np_xy))
        if polygons:
            result.polygons = self.distort_polygons(
                config, shape, polygons, state=plan
            )
        if get_active_mask:
            result.active_mask = warp_active_mask(plan)
            assert result.active_mask.shape == result.shape
        if get_config:
            result.config = config
        if get_state:
            result.state = plan

        if not disable_clip_result_elements:
            self._clip_geometry(result)
        return result

    @staticmethod
    def _clip_geometry(result: DistortionResult) -> None:
        shape = result.shape
        if result.point:
            result.point = result.point.to_clipped_point(shape)
        if result.points:
            result.points = result.points.to_clipped_points(shape)
        if result.corner_points:
            result.corner_points = result.corner_points.to_clipped_points(shape)
        if result.polygon:
            result.polygon = result.polygon.to_clipped_polygon(shape)
        if result.polygons:
            result.polygons = [p.to_clipped_polygon(shape) for p in result.polygons]
