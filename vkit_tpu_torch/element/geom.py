"""2-D geometry elements: Point / Line / Box / Polygon.

Struct-of-arrays core: every container canonicalizes to an (N, 2) float64
xy array, and all coordinate transforms (shift / rescale / clip) funnel
through one vectorized mapper, `map_xy`.  Behavioral spec:
vkit/element/{point,line,box,polygon}.py (re-derived, not ported).
"""
import math
from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np

from .. import geometry as geom_backend
from .blend import Shapable, clamp, rescale, scaled_shape, shape_of

Coord = Union[float, int, str]


def map_xy(
    np_xy: np.ndarray,
    from_shape: Optional[Tuple[int, int]] = None,
    to_shape: Optional[Tuple[int, int]] = None,
    offset_y: float = 0.0,
    offset_x: float = 0.0,
    clip_shape: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Vectorized coordinate map: optional rescale, then shift, then clip."""
    out = np.asarray(np_xy, dtype=np.float64).copy()
    if to_shape is not None:
        assert from_shape is not None
        fh, fw = from_shape
        th, tw = to_shape
        out[:, 0] *= tw / fw
        out[:, 1] *= th / fh
        # Rescaled coordinates clamp into the *new* extent.
        np.clip(out[:, 0], 0.0, tw - 1, out=out[:, 0])
        np.clip(out[:, 1], 0.0, th - 1, out=out[:, 1])
    if offset_x or offset_y:
        out[:, 0] += offset_x
        out[:, 1] += offset_y
    if clip_shape is not None:
        ch, cw = clip_shape
        np.clip(out[:, 0], 0.0, cw - 1, out=out[:, 0])
        np.clip(out[:, 1], 0.0, ch - 1, out=out[:, 1])
    return out


def _round_int(val: float) -> int:
    return int(round(val))


class Point:
    """Sub-pixel point; equality and hashing use rounded integer coords."""

    __slots__ = ('smooth_y', 'smooth_x')

    def __init__(self, smooth_y: float, smooth_x: float):
        object.__setattr__(self, 'smooth_y', float(smooth_y))
        object.__setattr__(self, 'smooth_x', float(smooth_x))

    def __setattr__(self, name, value):
        raise AttributeError('Point is immutable')

    def __repr__(self):
        return f'Point(y={self.smooth_y}, x={self.smooth_x})'

    @property
    def y(self) -> int:
        return _round_int(self.smooth_y)

    @property
    def x(self) -> int:
        return _round_int(self.smooth_x)

    def __eq__(self, other):
        if not isinstance(other, Point):
            return NotImplemented
        return (self.y, self.x) == (other.y, other.x)

    def __hash__(self):
        return hash((self.y, self.x))

    @classmethod
    def create(cls, y: Coord, x: Coord) -> 'Point':
        return cls(float(y), float(x))

    @classmethod
    def from_xy_pair(cls, xy_pair: Tuple[Coord, Coord]) -> 'Point':
        return cls(float(xy_pair[1]), float(xy_pair[0]))

    def to_xy_pair(self) -> Tuple[int, int]:
        return self.x, self.y

    def to_smooth_xy_pair(self) -> Tuple[float, float]:
        return self.smooth_x, self.smooth_y

    def to_clipped_point(self, of) -> 'Point':
        h, w = shape_of(of)
        return Point(clamp(self.smooth_y, h), clamp(self.smooth_x, w))

    def to_shifted_point(self, offset_y: int = 0, offset_x: int = 0) -> 'Point':
        return Point(self.smooth_y + offset_y, self.smooth_x + offset_x)

    def to_relative_point(self, origin_y: int, origin_x: int) -> 'Point':
        return Point(self.smooth_y - origin_y, self.smooth_x - origin_x)

    def to_conducted_resized_point(
        self,
        shapable_or_shape,
        resized_height: Optional[int] = None,
        resized_width: Optional[int] = None,
    ) -> 'Point':
        h, w = shape_of(shapable_or_shape)
        rh, rw = scaled_shape(h, w, resized_height, resized_width)
        return Point(rescale(self.smooth_y, h, rh), rescale(self.smooth_x, w, rw))


def _points_to_xy(points: Iterable[Point]) -> np.ndarray:
    pts = [(p.smooth_x, p.smooth_y) for p in points]
    return np.asarray(pts, dtype=np.float64).reshape(-1, 2)


def _xy_to_points(np_xy: np.ndarray) -> List[Point]:
    return [Point(float(y), float(x)) for x, y in np_xy]


class _PointContainer:
    """Shared vectorized ops; every bulk transform round-trips one array."""

    def _xy(self) -> np.ndarray:
        return _points_to_xy(self)  # type: ignore[arg-type]

    def _rebuild(self, np_xy: np.ndarray):
        return type(self)(_xy_to_points(np_xy))  # type: ignore[call-arg]

    def to_xy_pairs(self) -> List[Tuple[int, int]]:
        return [p.to_xy_pair() for p in self]  # type: ignore[attr-defined]

    def to_smooth_xy_pairs(self) -> List[Tuple[float, float]]:
        return [p.to_smooth_xy_pair() for p in self]  # type: ignore[attr-defined]

    def to_flatten_xy_pairs(self) -> List[int]:
        flat: List[int] = []
        for x, y in self.to_xy_pairs():
            flat.append(x)
            flat.append(y)
        return flat

    def to_smooth_flatten_xy_pairs(self) -> List[float]:
        flat: List[float] = []
        for x, y in self.to_smooth_xy_pairs():
            flat.append(x)
            flat.append(y)
        return flat

    def to_np_array(self) -> np.ndarray:
        return np.asarray(self.to_xy_pairs(), dtype=np.int32)

    def to_smooth_np_array(self) -> np.ndarray:
        return self._xy().astype(np.float32)

    def to_clipped_points(self, of):
        return PointList(_xy_to_points(map_xy(self._xy(), clip_shape=shape_of(of))))

    def to_shifted_points(self, offset_y: int = 0, offset_x: int = 0):
        return PointList(
            _xy_to_points(self._xy() + np.asarray([offset_x, offset_y], dtype=np.float64))
        )

    def to_relative_points(self, origin_y: int, origin_x: int):
        return self.to_shifted_points(offset_y=-origin_y, offset_x=-origin_x)

    def to_conducted_resized_points(
        self,
        shapable_or_shape,
        resized_height: Optional[int] = None,
        resized_width: Optional[int] = None,
    ):
        h, w = shape_of(shapable_or_shape)
        rh, rw = scaled_shape(h, w, resized_height, resized_width)
        return PointList(
            _xy_to_points(map_xy(self._xy(), from_shape=(h, w), to_shape=(rh, rw)))
        )


def _container_constructors(cls):
    """Attach the shared alternative constructors to a point container."""

    def from_point(inner, point: Point):
        return inner((point,))

    def from_xy_pairs(inner, xy_pairs):
        return inner(Point.from_xy_pair(pair) for pair in xy_pairs)

    def from_flatten_xy_pairs(inner, flat: Sequence[Coord]):
        assert len(flat) % 2 == 0
        it = iter(flat)
        return inner(Point(float(y), float(x)) for x, y in zip(it, it))

    def from_np_array(inner, np_points: np.ndarray):
        np_points = np.asarray(np_points)
        assert np_points.ndim == 2 and np_points.shape[1] == 2
        return inner(Point(float(y), float(x)) for x, y in np_points)

    cls.from_point = classmethod(from_point)
    cls.from_xy_pairs = classmethod(from_xy_pairs)
    cls.from_flatten_xy_pairs = classmethod(from_flatten_xy_pairs)
    cls.from_np_array = classmethod(from_np_array)
    return cls


@_container_constructors
class PointList(List[Point], _PointContainer):

    def to_point_tuple(self) -> 'PointTuple':
        return PointTuple(self)

    def copy(self) -> 'PointList':
        return PointList(self)


@_container_constructors
class PointTuple(Tuple[Point, ...], _PointContainer):

    def to_clipped_points(self, of) -> 'PointTuple':
        return PointTuple(super().to_clipped_points(of))

    def to_shifted_points(self, offset_y: int = 0, offset_x: int = 0) -> 'PointTuple':
        return PointTuple(super().to_shifted_points(offset_y, offset_x))

    def to_relative_points(self, origin_y: int, origin_x: int) -> 'PointTuple':
        return self.to_shifted_points(offset_y=-origin_y, offset_x=-origin_x)

    def to_conducted_resized_points(self, shapable_or_shape, resized_height=None,
                                    resized_width=None) -> 'PointTuple':
        return PointTuple(
            super().to_conducted_resized_points(
                shapable_or_shape, resized_height, resized_width
            )
        )


class Line(NamedTuple):
    point_begin: Point
    point_end: Point

    @classmethod
    def from_xy_pairs(cls, xy_pairs) -> 'Line':
        (x0, y0), (x1, y1) = xy_pairs
        return cls(Point.create(y=y0, x=x0), Point.create(y=y1, x=x1))

    def to_xy_pairs(self):
        return [self.point_begin.to_xy_pair(), self.point_end.to_xy_pair()]

    @classmethod
    def from_flatten_xy_pairs(cls, flat) -> 'Line':
        x0, y0, x1, y1 = flat
        return cls(Point.create(y=y0, x=x0), Point.create(y=y1, x=x1))

    def to_flatten_xy_pairs(self):
        (x0, y0), (x1, y1) = self.to_xy_pairs()
        return [x0, y0, x1, y1]

    def get_center_point(self) -> Point:
        return Point(
            (self.point_begin.smooth_y + self.point_end.smooth_y) / 2,
            (self.point_begin.smooth_x + self.point_end.smooth_x) / 2,
        )


class Box(NamedTuple):
    """Inclusive integer bounds on a raster grid."""

    up: int
    down: int
    left: int
    right: int

    @classmethod
    def from_shape(cls, shape: Tuple[int, int]) -> 'Box':
        h, w = shape
        return cls(0, h - 1, 0, w - 1)

    @classmethod
    def from_shapable(cls, shapable: Shapable) -> 'Box':
        return cls.from_shape(shapable.shape)

    @classmethod
    def from_boxes(cls, boxes: Iterable['Box']) -> 'Box':
        ups, downs, lefts, rights = zip(*boxes)
        return cls(min(ups), max(downs), min(lefts), max(rights))

    @property
    def height(self) -> int:
        return self.down - self.up + 1

    @property
    def width(self) -> int:
        return self.right - self.left + 1

    @property
    def shape(self) -> Tuple[int, int]:
        return self.height, self.width

    @property
    def area(self) -> int:
        return self.height * self.width

    @property
    def valid(self) -> bool:
        return 0 <= self.up <= self.down and 0 <= self.left <= self.right

    @property
    def slices(self) -> Tuple[slice, slice]:
        return slice(self.up, self.down + 1), slice(self.left, self.right + 1)

    def get_center_point(self) -> Point:
        return Point((self.up + self.down) / 2, (self.left + self.right) / 2)

    def to_polygon(self, step: Optional[int] = None) -> 'Polygon':
        if self.up == self.down or self.left == self.right:
            raise RuntimeError(f'box {self} is degenerate; no polygon')
        if step is None:
            # Corner order contract: ul -> ur -> dr -> dl (char labeling
            # depends on it; see vkit/element/box.py:94-135).
            quad = [
                (self.left, self.up),
                (self.right, self.up),
                (self.right, self.down),
                (self.left, self.down),
            ]
            return Polygon.from_xy_pairs(quad)
        assert step > 0
        # Walk the perimeter clockwise, emitting a vertex every `step` px.
        top_xs = np.arange(self.left, self.right + 1, step).tolist()
        if top_xs[-1] < self.right:
            top_xs.append(self.right)
        side_ys = np.arange(self.up, self.down + 1, step).tolist()
        if side_ys and side_ys[-1] == self.down:
            side_ys.pop()
        side_ys = side_ys[1:]
        xy: List[Tuple[int, int]] = []
        xy.extend((x, self.up) for x in top_xs)
        xy.extend((self.right, y) for y in side_ys)
        xy.extend((x, self.down) for x in reversed(top_xs))
        xy.extend((self.left, y) for y in reversed(side_ys))
        return Polygon.from_xy_pairs(xy)

    def to_clipped_box(self, shapable_or_shape) -> 'Box':
        h, w = shape_of(shapable_or_shape)
        return Box(
            clamp(self.up, h), clamp(self.down, h),
            clamp(self.left, w), clamp(self.right, w),
        )

    def to_conducted_resized_box(
        self,
        shapable_or_shape,
        resized_height: Optional[int] = None,
        resized_width: Optional[int] = None,
    ) -> 'Box':
        h, w = shape_of(shapable_or_shape)
        rh, rw = scaled_shape(h, w, resized_height, resized_width)
        return Box(
            round(rescale(self.up, h, rh)),
            round(rescale(self.down, h, rh)),
            round(rescale(self.left, w, rw)),
            round(rescale(self.right, w, rw)),
        )

    def to_resized_box(self, resized_height=None, resized_width=None) -> 'Box':
        return self.to_conducted_resized_box(self, resized_height, resized_width)

    def to_shifted_box(self, offset_y: int = 0, offset_x: int = 0) -> 'Box':
        return Box(
            self.up + offset_y, self.down + offset_y,
            self.left + offset_x, self.right + offset_x,
        )

    def to_relative_box(self, origin_y: int, origin_x: int) -> 'Box':
        return self.to_shifted_box(-origin_y, -origin_x)

    def to_dilated_box(self, ratio: float, clip_long_side: bool = False) -> 'Box':
        pad_v = math.ceil(self.height * ratio / 2)
        pad_h = math.ceil(self.width * ratio / 2)
        if clip_long_side:
            pad_v = pad_h = min(pad_v, pad_h)
        return Box(self.up - pad_v, self.down + pad_v, self.left - pad_h, self.right + pad_h)

    def get_boxes_for_box_attached_opt(self, element_box: Optional['Box']):
        """Resolve self against an element's attached box.

        Returns (box in the element's local frame, new attached box or None).
        """
        if element_box is None:
            return self, None
        assert element_box.up <= self.up and self.down <= element_box.down
        assert element_box.left <= self.left and self.right <= element_box.right
        return self.to_relative_box(element_box.up, element_box.left), self

    def extract_np_array(self, mat: np.ndarray) -> np.ndarray:
        assert 0 <= self.up <= self.down < mat.shape[0] + 1
        assert 0 <= self.left <= self.right < mat.shape[1] + 1
        return mat[self.slices]

    def prep_mat_and_value(self, mat: np.ndarray, value):
        """Crop full-canvas mats/values down to this box's region."""
        full_shape = mat.shape[:2]
        if full_shape != self.shape:
            mat = self.extract_np_array(mat)
        if isinstance(value, np.ndarray):
            if value.shape[:2] != mat.shape[:2]:
                assert value.shape[:2] == full_shape
                value = self.extract_np_array(value)
            if value.dtype != mat.dtype:
                value = value.astype(mat.dtype)
        return mat, value

    # Raster plumbing: delegate to the shared paint/lift engine.

    def extract_mask(self, mask):
        from .raster import lift
        return lift(self, mask)

    def extract_score_map(self, score_map):
        from .raster import lift
        return lift(self, score_map)

    def extract_image(self, image):
        from .raster import lift
        return lift(self, image)

    def fill_np_array(self, mat, value, np_mask=None, alpha=1.0,
                      keep_max_value=False, keep_min_value=False):
        from .raster import paint_np
        paint_np(self, mat, value, np_mask, alpha, keep_max_value, keep_min_value)

    def fill_mask(self, mask, value=1, mask_mask=None,
                  keep_max_value=False, keep_min_value=False):
        from .raster import paint
        paint(mask, self, value, gate=mask_mask,
              prefer_max=keep_max_value, prefer_min=keep_min_value)

    def fill_score_map(self, score_map, value, score_map_mask=None,
                       keep_max_value=False, keep_min_value=False):
        from .raster import paint
        paint(score_map, self, value, gate=score_map_mask,
              prefer_max=keep_max_value, prefer_min=keep_min_value)

    def fill_image(self, image, value, image_mask=None, alpha=1.0):
        from .raster import paint
        paint(image, self, value, gate=image_mask, weight=alpha)


class BoxOverlappingValidator:
    """Vectorized pairwise interval test (no spatial index needed)."""

    def __init__(self, boxes: Iterable[Box]):
        bounds = [tuple(b) for b in boxes]
        self.np_bounds = np.asarray(bounds, dtype=np.int64).reshape(-1, 4)

    def is_overlapped(self, box: Box) -> bool:
        if not len(self.np_bounds):
            return False
        ups, downs, lefts, rights = self.np_bounds.T
        hit = (
            (ups <= box.down) & (box.up <= downs)
            & (lefts <= box.right) & (box.left <= rights)
        )
        return bool(hit.any())


class _PolygonData:
    """Lazily derived per-polygon rasters and metrics (SoA core)."""

    __slots__ = ('np_xy', 'bounding_box', 'np_rel_xy', '_area', '_np_mask',
                 '_mask', '_rel_polygon')

    def __init__(self, np_xy: np.ndarray):
        self.np_xy = np_xy
        x_min, y_min = np_xy.min(axis=0)
        x_max, y_max = np_xy.max(axis=0)
        self.bounding_box = Box(
            round(float(y_min)), round(float(y_max)),
            round(float(x_min)), round(float(x_max)),
        )
        self.np_rel_xy = np_xy - np.asarray([x_min, y_min], dtype=np.float64)
        self._area = None
        self._np_mask = None
        self._mask = None
        self._rel_polygon = None

    # Reference-compatible attribute name.
    @property
    def np_self_relative_points(self) -> np.ndarray:
        return self.np_rel_xy.astype(np.float32)

    @property
    def area(self) -> float:
        if self._area is None:
            self._area = geom_backend.polygon_area(self.np_rel_xy)
        return self._area

    @property
    def np_mask(self) -> np.ndarray:
        if self._np_mask is None:
            self._np_mask = geom_backend.fill_poly(
                self.np_rel_xy, self.bounding_box.shape
            ).astype(bool)
        return self._np_mask

    @property
    def mask(self):
        if self._mask is None:
            from .raster import Mask
            self._mask = Mask(
                mat=self.np_mask.astype(np.uint8), box=self.bounding_box
            )
        return self._mask

    @property
    def self_relative_polygon(self) -> 'Polygon':
        if self._rel_polygon is None:
            self._rel_polygon = Polygon.from_np_xy(self.np_rel_xy)
        return self._rel_polygon


class Polygon:
    """Closed polygon backed by an (P, 2) float64 xy array."""

    __slots__ = ('np_xy', '_data', '_points')

    def __init__(self, points=None, *, np_xy: Optional[np.ndarray] = None):
        if np_xy is None:
            assert points is not None
            np_xy = _points_to_xy(points)
            object.__setattr__(self, '_points', PointTuple(points))
        else:
            object.__setattr__(self, '_points', None)
        np_xy = np.asarray(np_xy, dtype=np.float64)
        assert np_xy.ndim == 2 and np_xy.shape[1] == 2 and np_xy.shape[0] >= 3
        np_xy.flags.writeable = False
        object.__setattr__(self, 'np_xy', np_xy)
        object.__setattr__(self, '_data', None)

    def __setattr__(self, name, value):
        raise AttributeError('Polygon is immutable')

    def __repr__(self):
        return f'Polygon(num_points={self.num_points})'

    def __eq__(self, other):
        if not isinstance(other, Polygon):
            return NotImplemented
        a = np.round(self.np_xy).astype(np.int64)
        b = np.round(other.np_xy).astype(np.int64)
        return a.shape == b.shape and bool((a == b).all())

    @property
    def points(self) -> PointTuple:
        if self._points is None:
            object.__setattr__(
                self, '_points', PointTuple(_xy_to_points(self.np_xy))
            )
        return self._points

    @property
    def num_points(self) -> int:
        return self.np_xy.shape[0]

    @property
    def internals(self) -> _PolygonData:
        if self._data is None:
            object.__setattr__(self, '_data', _PolygonData(self.np_xy))
        return self._data

    @property
    def area(self) -> float:
        return self.internals.area

    @property
    def bounding_box(self) -> Box:
        return self.internals.bounding_box

    @property
    def self_relative_polygon(self) -> 'Polygon':
        return self.internals.self_relative_polygon

    @property
    def mask(self):
        return self.internals.mask

    @classmethod
    def create(cls, points) -> 'Polygon':
        return cls(points=tuple(points))

    @classmethod
    def from_np_xy(cls, np_xy: np.ndarray) -> 'Polygon':
        return cls(np_xy=np.array(np_xy, dtype=np.float64))

    @classmethod
    def from_xy_pairs(cls, xy_pairs) -> 'Polygon':
        return cls.from_np_xy(np.asarray([tuple(p) for p in xy_pairs], dtype=np.float64))

    @classmethod
    def from_flatten_xy_pairs(cls, flat: Sequence[Coord]) -> 'Polygon':
        arr = np.asarray([float(v) for v in flat], dtype=np.float64)
        return cls.from_np_xy(arr.reshape(-1, 2))

    @classmethod
    def from_np_array(cls, np_points: np.ndarray) -> 'Polygon':
        return cls.from_np_xy(np.asarray(np_points, dtype=np.float64))

    def to_xy_pairs(self):
        return [(int(x), int(y)) for x, y in np.round(self.np_xy).astype(np.int64)]

    def to_smooth_xy_pairs(self):
        return [(float(x), float(y)) for x, y in self.np_xy]

    def to_flatten_xy_pairs(self):
        return [int(v) for v in np.round(self.np_xy).astype(np.int64).ravel()]

    def to_smooth_flatten_xy_pairs(self):
        return [float(v) for v in self.np_xy.ravel()]

    def to_np_array(self) -> np.ndarray:
        return np.round(self.np_xy).astype(np.int64).astype(np.int32)

    def to_smooth_np_array(self) -> np.ndarray:
        return self.np_xy.astype(np.float32)

    def get_center_point(self) -> Point:
        cx, cy = geom_backend.polygon_centroid(self.np_xy)
        return Point(cy, cx)

    def _edge_mean(self, idx_a0, idx_a1, idx_b0, idx_b1) -> float:
        a = np.linalg.norm(self.np_xy[idx_a0] - self.np_xy[idx_a1])
        b = np.linalg.norm(self.np_xy[idx_b0] - self.np_xy[idx_b1])
        return float(a + b) / 2

    def get_rectangular_height(self) -> float:
        # ul/ur/dr/dl corner order contract.
        assert self.num_points == 4
        return self._edge_mean(0, 3, 1, 2)

    def get_rectangular_width(self) -> float:
        assert self.num_points == 4
        return self._edge_mean(0, 1, 3, 2)

    def to_clipped_points(self, of) -> PointTuple:
        return PointTuple(_xy_to_points(map_xy(self.np_xy, clip_shape=shape_of(of))))

    def to_clipped_polygon(self, of) -> 'Polygon':
        return Polygon.from_np_xy(map_xy(self.np_xy, clip_shape=shape_of(of)))

    def to_shifted_points(self, offset_y: int = 0, offset_x: int = 0) -> PointTuple:
        return self.to_shifted_polygon(offset_y, offset_x).points

    def to_relative_points(self, origin_y: int, origin_x: int) -> PointTuple:
        return self.to_shifted_points(-origin_y, -origin_x)

    def to_shifted_polygon(self, offset_y: int = 0, offset_x: int = 0) -> 'Polygon':
        return Polygon.from_np_xy(
            map_xy(self.np_xy, offset_y=offset_y, offset_x=offset_x)
        )

    def to_relative_polygon(self, origin_y: int, origin_x: int) -> 'Polygon':
        return self.to_shifted_polygon(-origin_y, -origin_x)

    def to_conducted_resized_polygon(
        self,
        shapable_or_shape,
        resized_height: Optional[int] = None,
        resized_width: Optional[int] = None,
    ) -> 'Polygon':
        h, w = shape_of(shapable_or_shape)
        rh, rw = scaled_shape(h, w, resized_height, resized_width)
        return Polygon.from_np_xy(
            map_xy(self.np_xy, from_shape=(h, w), to_shape=(rh, rw))
        )

    def to_resized_polygon(self, resized_height=None, resized_width=None) -> 'Polygon':
        return self.to_conducted_resized_polygon(
            self.bounding_box.shape, resized_height, resized_width
        )

    def to_bounding_box(self) -> Box:
        return self.bounding_box

    def to_bounding_rectangular_polygon(
        self,
        shape: Tuple[int, int],
        angle: Optional[float] = None,
    ) -> 'Polygon':
        if angle is None:
            corners = geom_backend.min_area_rect(self.np_xy)
            rect = Polygon.from_np_xy(np.asarray(corners, dtype=np.float64))
        else:
            rect = _angled_bounding_rect(self.np_xy, angle % 180)
        return rect.to_clipped_polygon(shape)

    # Raster plumbing.

    def fill_np_array(self, mat, value, alpha=1.0,
                      keep_max_value=False, keep_min_value=False):
        from .raster import paint_np
        paint_np(self.bounding_box, mat, value, self.internals.np_mask, alpha,
                 keep_max_value, keep_min_value)

    def extract_mask(self, mask):
        from .raster import lift
        return lift(self, mask)

    def fill_mask(self, mask, value=1, keep_max_value=False, keep_min_value=False):
        from .raster import paint
        paint(mask, self, value, prefer_max=keep_max_value, prefer_min=keep_min_value)

    def extract_score_map(self, score_map):
        from .raster import lift
        return lift(self, score_map)

    def fill_score_map(self, score_map, value,
                       keep_max_value=False, keep_min_value=False):
        from .raster import paint
        paint(score_map, self, value,
              prefer_max=keep_max_value, prefer_min=keep_min_value)

    def extract_image(self, image):
        from .raster import lift
        return lift(self, image)

    def fill_image(self, image, value, alpha=1.0):
        from .raster import paint
        paint(image, self, value, weight=alpha)

    # Offsetting (Vatti-equivalent, first-party EDT backend).

    def to_vatti_clipped_polygon(self, ratio: float, shrink: bool):
        """Offset by d = area * (1 - ratio^2) / perimeter (DBNet-style)."""
        assert 0.0 <= ratio <= 1.0
        if ratio == 1.0:
            return self, 0.0
        area = geom_backend.polygon_area(self.np_xy)
        perimeter = geom_backend.polygon_perimeter(self.np_xy)
        distance = area * (1.0 - ratio * ratio) / max(perimeter, 1e-6)
        pieces = geom_backend.offset_polygon(
            self.np_xy, -distance if shrink else distance
        )
        assert pieces
        largest = max(pieces, key=geom_backend.polygon_area)
        rounded = np.round(np.asarray(largest, dtype=np.float64))
        return Polygon.from_np_xy(_dedup_ring(rounded)), (
            -distance if shrink else distance
        )

    def _offset_with_fallback(self, ratio: float, shrink: bool,
                              no_exception: bool) -> 'Polygon':
        import logging
        logger = logging.getLogger(__name__)
        try:
            offset_polygon, _ = self.to_vatti_clipped_polygon(ratio, shrink=shrink)
            inner, outer = (
                (offset_polygon, self) if shrink else (self, offset_polygon)
            )
            ib, ob = inner.bounding_box, outer.bounding_box
            contained = (
                ob.up <= ib.up and ib.down <= ob.down
                and ob.left <= ib.left and ib.right <= ob.right
            )
            if not (offset_polygon.bounding_box.valid and contained):
                logger.warning('offset polygon out of bounds; NOP fallback')
                return self
            ok = (
                0 < offset_polygon.area <= self.area if shrink
                else offset_polygon.area >= self.area
            )
            if not ok:
                logger.warning('offset polygon area check failed; NOP fallback')
                return self
            return offset_polygon
        except Exception:
            if no_exception:
                logger.exception('polygon offset failed; NOP fallback')
                return self
            raise

    def to_shrank_polygon(self, ratio: float, no_exception: bool = True) -> 'Polygon':
        return self._offset_with_fallback(ratio, shrink=True, no_exception=no_exception)

    def to_dilated_polygon(self, ratio: float, no_exception: bool = True) -> 'Polygon':
        return self._offset_with_fallback(ratio, shrink=False, no_exception=no_exception)


def _dedup_ring(np_xy: np.ndarray) -> np.ndarray:
    """Drop consecutive duplicate vertices and an equal closing vertex."""
    keep = np.ones(len(np_xy), dtype=bool)
    keep[1:] = (np_xy[1:] != np_xy[:-1]).any(axis=1)
    out = np_xy[keep]
    if len(out) > 1 and (out[0] == out[-1]).all():
        out = out[:-1]
    assert len(out) >= 3
    return out


def _angled_bounding_rect(np_xy: np.ndarray, angle: float) -> Polygon:
    """Bounding rectangle aligned to `angle` (degrees) via projection."""
    theta = math.radians(angle)
    u = np.asarray([math.cos(theta), math.sin(theta)])           # main axis
    v = np.asarray([-math.sin(theta), math.cos(theta)])          # orthogonal
    su = np_xy @ u
    sv = np_xy @ v
    corners = [
        su.min() * u + sv.min() * v,
        su.min() * u + sv.max() * v,
        su.max() * u + sv.max() * v,
        su.max() * u + sv.min() * v,
    ]
    return Polygon.from_np_xy(np.asarray(corners, dtype=np.float64))


def estimate_polygon_height(np_points: np.ndarray) -> float:
    """area / longest edge (spec: vkit/element/polygon.py:623-634)."""
    ring = np.vstack([np_points, np_points[:1]])
    edge_lengths = np.hypot(*np.diff(ring, axis=0).T)
    return geom_backend.polygon_area(np_points) / max(float(edge_lengths.max()), 1e-6)


def unionize_polygons(polygons: Iterable[Polygon]):
    """Merge overlapping polygons; returns (merged, scatter_indices).

    Raster-space union (valid by construction) replaces GEOS unary_union
    (spec: vkit/element/polygon.py:656-701).
    """
    np_polys = [p.np_xy for p in polygons]
    merged, scatter_indices = geom_backend.unionize_polygons_raster(np_polys)
    return [Polygon.from_np_xy(np.asarray(m, dtype=np.float64)) for m in merged], \
        scatter_indices
