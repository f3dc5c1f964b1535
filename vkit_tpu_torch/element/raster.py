"""Raster elements (Mask, ScoreMap) and the shared paint/lift engine.

One engine serves every raster kind: an element resolves to a *patch*
(placement box + optional boolean stencil), and all fills/extracts/set-ops
run through `paint` / `lift` / `coverage`.  This replaces the reference's
per-class fill_mask/fill_score_map/fill_image method triplets
(behavioral spec: vkit/element/{mask,score_map,box}.py; re-derived).

Known divergence: in the reference's mode != UNION, non-unique-values fill
over box-attached masks, the extracted combined-mask region loses its box
and is painted at the canvas origin (vkit/element/image.py:579-591); here
the patch box is kept, which is the evidently intended behavior.
"""
import logging
from contextlib import contextmanager
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import geometry as geom_backend
from ..ops.resize_taps import Interpolation, resize_np
from .blend import (
    ElementSetOperationMode,
    Shapable,
    all_equal_values,
    compose,
    scaled_shape,
)
from .geom import Box, Point, Polygon

logger = logging.getLogger(__name__)

UNION = ElementSetOperationMode.UNION
DISTINCT = ElementSetOperationMode.DISTINCT
INTERSECT = ElementSetOperationMode.INTERSECT


class Raster(Shapable):
    """Immutable raster with an optional attached placement box."""

    __slots__ = ('mat', 'box', '_stale')

    def __init__(self, mat: np.ndarray, box: Optional[Box] = None):
        self._check_mat(mat)
        mat.flags.writeable = False
        object.__setattr__(self, 'mat', mat)
        object.__setattr__(self, 'box', box)
        object.__setattr__(self, '_stale', {})
        if box is not None and box.shape != mat.shape[:2]:
            raise RuntimeError(f'attached box {box} does not match mat {mat.shape}')

    def _check_mat(self, mat: np.ndarray) -> None:
        raise NotImplementedError()

    def _fields(self) -> dict:
        return {'mat': self.mat, 'box': self.box}

    def replace(self, **over) -> 'Raster':
        kw = self._fields()
        kw.update(over)
        return type(self)(**kw)

    @property
    def height(self) -> int:
        return self.mat.shape[0]

    @property
    def width(self) -> int:
        return self.mat.shape[1]

    @property
    def equivalent_box(self) -> Box:
        return self.box if self.box is not None else Box.from_shapable(self)

    def copy(self) -> 'Raster':
        return self.replace(mat=self.mat.copy())

    def _invalidate(self) -> None:
        self._stale.clear()

    @contextmanager
    def editable(self):
        """Temporarily writable view of `mat` (copy-on-write for shared bufs)."""
        mat = self.mat
        try:
            mat.flags.writeable = True
        except ValueError:
            mat = mat.copy()
            object.__setattr__(self, 'mat', mat)
        try:
            yield mat
        finally:
            mat.flags.writeable = False
            self._invalidate()

    @property
    def writable_context(self):
        return self.editable()

    def assign_mat(self, mat: np.ndarray) -> None:
        self._check_mat(mat)
        mat.flags.writeable = False
        object.__setattr__(self, 'mat', mat)
        self._invalidate()

    def to_box_attached(self, box: Box):
        assert self.shape == box.shape
        return self.replace(box=box)

    def to_box_detached(self):
        assert self.box is not None
        return self.replace(box=None)


# ----------------------------------------------------------------------------
# The paint / lift / coverage engine.
# ----------------------------------------------------------------------------

def patch_of(element) -> Tuple[Box, Optional[np.ndarray]]:
    """Resolve any paintable element to (placement box, bool stencil|None)."""
    if isinstance(element, Box):
        return element, None
    if isinstance(element, Polygon):
        data = element.internals
        return data.bounding_box, data.np_mask
    if isinstance(element, Mask):
        return element.equivalent_box, element.np_mask
    if isinstance(element, ScoreMap):
        return element.equivalent_box, element.mat > 0.0
    raise NotImplementedError(f'not paintable: {type(element)}')


def _as_gate(gate) -> Optional[np.ndarray]:
    if gate is None:
        return None
    if isinstance(gate, Mask):
        # The gate mask's own box is deliberately ignored (spec:
        # vkit/element/box.py:301-309).
        return gate.np_mask
    return gate


def _as_weight(weight):
    if isinstance(weight, ScoreMap):
        assert weight.is_prob
        return weight.mat
    return weight


def paint_np(
    box: Box,
    mat: np.ndarray,
    value,
    np_mask: Optional[np.ndarray] = None,
    alpha=1.0,
    keep_max_value: bool = False,
    keep_min_value: bool = False,
) -> None:
    """Composite `value` into the box region of a writable array."""
    alpha = _as_weight(alpha)
    np_mask = _as_gate(np_mask)
    region, value = box.prep_mat_and_value(mat, value)
    if np_mask is None and isinstance(alpha, np.ndarray):
        # Sparse-alpha shortcut: fully transparent pixels never write.
        np_mask = alpha > 0.0
    compose(
        region, value, where=np_mask, weight=alpha,
        prefer_max=keep_max_value, prefer_min=keep_min_value,
    )


def paint(
    target: Raster,
    element,
    value,
    gate=None,
    weight=1.0,
    prefer_max: bool = False,
    prefer_min: bool = False,
) -> None:
    """Composite `value` onto `target` through `element`'s footprint."""
    box, stencil = patch_of(element)
    rel_box, _ = box.get_boxes_for_box_attached_opt(target.box)

    if isinstance(value, Raster):
        if value.shape != box.shape:
            value = lift(box, value)
        value = value.mat

    gate_arr = _as_gate(gate)
    where = stencil
    if gate_arr is not None:
        where = gate_arr if where is None else (where & gate_arr.astype(bool))

    with target.editable() as mat:
        paint_np(rel_box, mat, value, where, weight, prefer_max, prefer_min)


def lift(element, raster: Raster) -> Raster:
    """Extract `element`'s footprint from `raster` (stencil zeroes outside)."""
    box, stencil = patch_of(element)
    rel_box, new_box = box.get_boxes_for_box_attached_opt(raster.box)
    if rel_box.shape == raster.shape:
        out = raster
    else:
        out = raster.replace(mat=rel_box.extract_np_array(raster.mat), box=new_box)
    if stencil is not None:
        mat = out.mat.copy()
        mat[~stencil] = 0
        out = out.replace(mat=mat)
    return out


def coverage(
    shape: Tuple[int, int],
    elements: Iterable,
    origin: Optional[Box] = None,
) -> np.ndarray:
    """Per-pixel count of covering elements (int32)."""
    counts = np.zeros(shape, dtype=np.int32)
    for element in elements:
        box, stencil = patch_of(element)
        if origin is not None:
            box = box.to_relative_box(origin.up, origin.left)
        region = box.extract_np_array(counts)
        if stencil is None:
            region += 1
        else:
            region[stencil] += 1
    return counts


def _unpack_shape_or_box(shape_or_box):
    if isinstance(shape_or_box, Box):
        return shape_or_box.shape, shape_or_box
    return shape_or_box, None


def mask_from_elements(
    shape_or_box,
    elements: Iterable,
    mode: ElementSetOperationMode = UNION,
) -> 'Mask':
    """Set-op rasterization: UNION >=1, DISTINCT ==1, INTERSECT >1."""
    shape, attached = _unpack_shape_or_box(shape_or_box)
    counts = coverage(shape, elements, origin=attached)
    if mode is UNION:
        mat = (counts > 0)
    elif mode is DISTINCT:
        mat = (counts == 1)
    elif mode is INTERSECT:
        mat = (counts > 1)
    else:
        raise NotImplementedError(mode)
    return Mask(mat=mat.astype(np.uint8), box=attached)


def paint_many(
    target: Raster,
    entries: Sequence[Tuple],
    mode: ElementSetOperationMode = UNION,
    prefer_max: bool = False,
    prefer_min: bool = False,
    assume_unique: bool = False,
) -> None:
    """Multi-element fill with set-op semantics and single-write shortcut.

    entries: (element, value) or (element, value, weight) tuples.
    """
    triples = [(e[0], e[1], e[2] if len(e) > 2 else 1.0) for e in entries]
    if mode is UNION:
        for element, value, weight in triples:
            paint(target, element, value, weight=weight,
                  prefer_max=prefer_max, prefer_min=prefer_min)
        return

    combined = mask_from_elements(target.shape, [t[0] for t in triples], mode)
    unique = assume_unique or (
        all_equal_values([t[1] for t in triples])
        and all_equal_values([t[2] for t in triples])
    )
    if unique:
        element, value, weight = triples[0]
        paint(target, combined, value, weight=weight,
              prefer_max=prefer_max, prefer_min=prefer_min)
        return

    for element, value, weight in triples:
        box, stencil = patch_of(element)
        gated = box.extract_np_array(combined.mat).copy()
        if stencil is not None and isinstance(element, (Mask, ScoreMap)):
            # Box/Polygon entries gate on the bounding region only (spec
            # behavior); raster entries intersect with their own stencil.
            gated[~stencil] = 0
        paint(target, Mask(mat=gated, box=box), value, weight=weight,
              prefer_max=prefer_max, prefer_min=prefer_min)


# ----------------------------------------------------------------------------
# Mask
# ----------------------------------------------------------------------------

class MaskSetItemConfig:

    def __init__(self, value=1, keep_max_value: bool = False,
                 keep_min_value: bool = False):
        self.value = value
        self.keep_max_value = keep_max_value
        self.keep_min_value = keep_min_value


class Mask(Raster):

    def _check_mat(self, mat: np.ndarray) -> None:
        if mat.dtype != np.uint8:
            raise RuntimeError('Mask.mat must be uint8')
        if mat.ndim != 2:
            raise RuntimeError('Mask.mat must be 2-D')

    @classmethod
    def from_shape(cls, shape: Tuple[int, int], value: int = 0) -> 'Mask':
        h, w = shape
        mat = np.zeros((h, w), np.uint8) if value == 0 \
            else np.full((h, w), value, np.uint8)
        return cls(mat=mat)

    @classmethod
    def from_shapable(cls, shapable, value: int = 0) -> 'Mask':
        return cls.from_shape(shapable.shape, value=value)

    @classmethod
    def from_boxes(cls, shape_or_box, boxes, mode=UNION) -> 'Mask':
        return mask_from_elements(shape_or_box, boxes, mode)

    @classmethod
    def from_polygons(cls, shape_or_box, polygons, mode=UNION) -> 'Mask':
        return mask_from_elements(shape_or_box, polygons, mode)

    @classmethod
    def from_masks(cls, shape_or_box, masks, mode=UNION) -> 'Mask':
        return mask_from_elements(shape_or_box, masks, mode)

    @classmethod
    def from_score_maps(cls, shape_or_box, score_maps, mode=UNION) -> 'Mask':
        return mask_from_elements(shape_or_box, score_maps, mode)

    @property
    def np_mask(self) -> np.ndarray:
        cached = self._stale.get('np_mask')
        if cached is None:
            cached = self.mat > 0
            self._stale['np_mask'] = cached
        return cached

    def set_np_mask_out_of_date(self) -> None:
        self._invalidate()

    # Multi-element fills.

    def fill_by_box_value_pairs(self, box_value_pairs, mode=UNION,
                                keep_max_value=False, keep_min_value=False,
                                skip_values_uniqueness_check=False):
        paint_many(self, tuple(box_value_pairs), mode,
                   prefer_max=keep_max_value, prefer_min=keep_min_value,
                   assume_unique=skip_values_uniqueness_check)

    fill_by_polygon_value_pairs = fill_by_box_value_pairs
    fill_by_mask_value_pairs = fill_by_box_value_pairs

    def fill_by_boxes(self, boxes, value=1, mode=UNION,
                      keep_max_value=False, keep_min_value=False):
        paint_many(self, [(b, value) for b in boxes], mode,
                   prefer_max=keep_max_value, prefer_min=keep_min_value,
                   assume_unique=True)

    fill_by_polygons = fill_by_boxes
    fill_by_masks = fill_by_boxes

    def __setitem__(self, element, config):
        if isinstance(config, MaskSetItemConfig):
            paint(self, element, config.value,
                  prefer_max=config.keep_max_value,
                  prefer_min=config.keep_min_value)
        else:
            paint(self, element, config)

    def __getitem__(self, element) -> 'Mask':
        return lift(element, self)

    # Single-element plumbing (kept for API parity; all funnel to the engine).

    def fill_np_array(self, mat, value, alpha=1.0,
                      keep_max_value=False, keep_min_value=False):
        paint_np(self.equivalent_box, mat, value, self.np_mask, alpha,
                 keep_max_value, keep_min_value)

    def fill_mask(self, mask, value=1, keep_max_value=False, keep_min_value=False):
        paint(mask, self, value, prefer_max=keep_max_value, prefer_min=keep_min_value)

    def extract_mask(self, mask) -> 'Mask':
        return lift(self, mask)

    def fill_score_map(self, score_map, value,
                       keep_max_value=False, keep_min_value=False):
        paint(score_map, self, value,
              prefer_max=keep_max_value, prefer_min=keep_min_value)

    def extract_score_map(self, score_map):
        return lift(self, score_map)

    def fill_image(self, image, value, alpha=1.0):
        paint(image, self, value, weight=alpha)

    def extract_image(self, image):
        return lift(self, image)

    # Conversions.

    def to_inverted_mask(self) -> 'Mask':
        return self.replace(mat=(~self.np_mask).astype(np.uint8))

    def to_shifted_mask(self, offset_y: int = 0, offset_x: int = 0) -> 'Mask':
        assert self.box is not None
        return self.replace(box=self.box.to_shifted_box(offset_y, offset_x))

    def to_resized_mask(self, resized_height=None, resized_width=None,
                        interpolation: Interpolation = Interpolation.CUBIC,
                        binarization_threshold: int = 0) -> 'Mask':
        assert self.box is None
        rh, rw = scaled_shape(self.height, self.width, resized_height, resized_width)
        # Resize through 0/255 then re-binarize to keep edge precision.
        wide = resize_np(self.np_mask.astype(np.uint8) * 255, (rh, rw), interpolation)
        return Mask(mat=(wide > binarization_threshold).astype(np.uint8))

    def to_conducted_resized_mask(self, shapable_or_shape,
                                  resized_height=None, resized_width=None,
                                  interpolation: Interpolation = Interpolation.CUBIC,
                                  binarization_threshold: int = 0) -> 'Mask':
        assert self.box is not None
        resized_box = self.box.to_conducted_resized_box(
            shapable_or_shape, resized_height, resized_width
        )
        return self.to_box_detached().to_resized_mask(
            resized_box.height, resized_box.width,
            interpolation, binarization_threshold,
        ).to_box_attached(resized_box)

    def to_cropped_mask(self, up=None, down=None, left=None, right=None) -> 'Mask':
        assert self.box is None
        crop = Box(up or 0, down or self.height - 1, left or 0, right or self.width - 1)
        return self.replace(mat=crop.extract_np_array(self.mat))

    def to_score_map(self) -> 'ScoreMap':
        return ScoreMap(mat=self.np_mask.astype(np.float32), box=self.box)

    def to_external_box(self) -> Box:
        rows = np.flatnonzero(self.np_mask.any(axis=1))
        cols = np.flatnonzero(self.np_mask.any(axis=0))
        if not rows.size or not cols.size:
            raise RuntimeError('to_external_box: mask is empty')
        return Box(int(rows[0]), int(rows[-1]), int(cols[0]), int(cols[-1]))

    def to_disconnected_polygons(self) -> Sequence[Polygon]:
        """External contour of each 8-connected component (first-party
        tracer; contours are simple polygons by construction)."""
        out: List[Polygon] = []
        for np_points in geom_backend.external_contours(self.np_mask.astype(np.uint8)):
            if np_points.shape[0] < 3:
                continue
            if self.box is not None:
                np_points = np_points + np.asarray([self.box.left, self.box.up])
            out.append(Polygon.from_np_xy(np_points.astype(np.float64)))
        return out

    def to_external_polygon(self) -> Polygon:
        polygons = self.to_disconnected_polygons()
        if not polygons:
            raise RuntimeError('no contour found')
        if len(polygons) > 1:
            logger.warning('multiple contours; keeping the largest')
        return max(polygons, key=lambda p: p.area)

    def to_disconnected_polygon_mask_pairs(self) -> Sequence[Tuple[Polygon, 'Mask']]:
        pairs: List[Tuple[Polygon, Mask]] = []
        for polygon in self.to_disconnected_polygons():
            bb = polygon.bounding_box
            boxed = Mask.from_shapable(bb).to_box_attached(bb)
            paint(boxed, polygon, 1)
            pairs.append((polygon, boxed))
        return pairs


# ----------------------------------------------------------------------------
# ScoreMap
# ----------------------------------------------------------------------------

class ScoreMapSetItemConfig:

    def __init__(self, value=1.0, keep_max_value: bool = False,
                 keep_min_value: bool = False):
        self.value = value
        self.keep_max_value = keep_max_value
        self.keep_min_value = keep_min_value


class ScoreMap(Raster):

    __slots__ = ('is_prob',)

    def __init__(self, mat: np.ndarray, box: Optional[Box] = None,
                 is_prob: bool = True):
        object.__setattr__(self, 'is_prob', is_prob)
        super().__init__(mat, box)
        if is_prob and mat.size:
            lo, hi = float(mat.min()), float(mat.max())
            if lo < 0.0 or hi > 1.0:
                raise RuntimeError(f'probability scores out of range [{lo}, {hi}]')

    def _check_mat(self, mat: np.ndarray) -> None:
        if mat.dtype != np.float32:
            raise RuntimeError('ScoreMap.mat must be float32')
        if mat.ndim != 2:
            raise RuntimeError('ScoreMap.mat must be 2-D')

    def _fields(self) -> dict:
        return {'mat': self.mat, 'box': self.box, 'is_prob': self.is_prob}

    @classmethod
    def from_shape(cls, shape: Tuple[int, int], value: float = 0.0,
                   is_prob: bool = True) -> 'ScoreMap':
        if is_prob:
            assert 0.0 <= value <= 1.0
        h, w = shape
        # np.zeros maps zero pages lazily; np.full faults in every page.
        mat = np.zeros((h, w), np.float32) if value == 0 \
            else np.full((h, w), value, np.float32)
        return cls(mat=mat, is_prob=is_prob)

    @classmethod
    def from_shapable(cls, shapable, value: float = 0.0,
                      is_prob: bool = True) -> 'ScoreMap':
        return cls.from_shape(shapable.shape, value, is_prob)

    @classmethod
    def from_quad_interpolation(cls, point0: Point, point1: Point, point2: Point,
                                point3: Point, func_np_uv_to_mat,
                                is_prob: bool = True) -> 'ScoreMap':
        """Inverse-bilinear (u, v) field over a quad, mapped to scores."""
        quad = Polygon.create((point0, point1, point2, point3))
        data = quad.internals
        np_uv = _inverse_bilinear_uv(
            data.np_self_relative_points, data.bounding_box.shape, data.np_mask
        )
        return cls(mat=func_np_uv_to_mat(np_uv), box=data.bounding_box,
                   is_prob=is_prob)

    def _check_value(self, value) -> None:
        if self.is_prob and isinstance(value, float):
            assert 0.0 <= value <= 1.0

    def fill_by_box_value_pairs(self, box_value_pairs, mode=UNION,
                                keep_max_value=False, keep_min_value=False,
                                skip_values_uniqueness_check=False):
        entries = tuple(box_value_pairs)
        for _, value in entries:
            self._check_value(value)
        paint_many(self, entries, mode,
                   prefer_max=keep_max_value, prefer_min=keep_min_value,
                   assume_unique=skip_values_uniqueness_check)

    fill_by_polygon_value_pairs = fill_by_box_value_pairs
    fill_by_mask_value_pairs = fill_by_box_value_pairs

    def fill_by_boxes(self, boxes, value=1.0, mode=UNION,
                      keep_max_value=False, keep_min_value=False):
        self._check_value(value)
        paint_many(self, [(b, value) for b in boxes], mode,
                   prefer_max=keep_max_value, prefer_min=keep_min_value,
                   assume_unique=True)

    fill_by_polygons = fill_by_boxes
    fill_by_masks = fill_by_boxes

    def __setitem__(self, element, config):
        if isinstance(config, ScoreMapSetItemConfig):
            paint(self, element, config.value,
                  prefer_max=config.keep_max_value,
                  prefer_min=config.keep_min_value)
        else:
            paint(self, element, config)

    def __getitem__(self, element) -> 'ScoreMap':
        return lift(element, self)

    def fill_by_quad_interpolation(self, point0, point1, point2, point3,
                                   func_np_uv_to_mat,
                                   keep_max_value=False, keep_min_value=False):
        patch = self.from_quad_interpolation(
            point0, point1, point2, point3, func_np_uv_to_mat, self.is_prob
        )
        assert patch.box is not None
        with self.editable() as mat:
            paint_np(patch.box, mat, patch.mat, patch.mat > 0.0,
                     keep_max_value=keep_max_value, keep_min_value=keep_min_value)

    # Single-element plumbing.

    def fill_np_array(self, mat, value, keep_max_value=False, keep_min_value=False):
        paint_np(self.equivalent_box, mat, value, None, self,
                 keep_max_value, keep_min_value)

    def fill_score_map(self, score_map, value,
                       keep_max_value=False, keep_min_value=False):
        paint(score_map, self, value,
              prefer_max=keep_max_value, prefer_min=keep_min_value)

    def extract_score_map(self, score_map):
        return lift(self, score_map)

    def fill_image(self, image, value):
        paint(image, self, value, weight=self)

    def extract_image(self, image):
        return lift(self, image)

    # Conversions.

    def to_mask(self, threshold: float = 0.0) -> Mask:
        return Mask(mat=(self.mat > threshold).astype(np.uint8), box=self.box)

    def to_shifted_score_map(self, offset_y: int = 0, offset_x: int = 0) -> 'ScoreMap':
        assert self.box is not None
        return self.replace(box=self.box.to_shifted_box(offset_y, offset_x))

    def to_resized_score_map(self, resized_height=None, resized_width=None,
                             interpolation: Interpolation = Interpolation.CUBIC,
                             ) -> 'ScoreMap':
        assert self.box is None
        rh, rw = scaled_shape(self.height, self.width, resized_height, resized_width)
        mat = resize_np(self.mat, (rh, rw), interpolation)
        if self.is_prob:
            mat = np.clip(mat, 0.0, 1.0)
        return ScoreMap(mat=mat, is_prob=self.is_prob)

    def to_conducted_resized_score_map(self, shapable_or_shape,
                                       resized_height=None, resized_width=None,
                                       interpolation: Interpolation = Interpolation.CUBIC,
                                       ) -> 'ScoreMap':
        assert self.box is not None
        resized_box = self.box.to_conducted_resized_box(
            shapable_or_shape, resized_height, resized_width
        )
        return self.to_box_detached().to_resized_score_map(
            resized_box.height, resized_box.width, interpolation
        ).to_box_attached(resized_box)

    # Reference exposes this under a misleading name; keep the alias.
    to_conducted_resized_polygon = to_conducted_resized_score_map

    def to_cropped_score_map(self, up=None, down=None, left=None, right=None
                             ) -> 'ScoreMap':
        assert self.box is None
        crop = Box(up or 0, down or self.height - 1, left or 0, right or self.width - 1)
        return self.replace(mat=crop.extract_np_array(self.mat))


def _inverse_bilinear_uv(
    np_rel_quad: np.ndarray,
    shape: Tuple[int, int],
    np_active_mask: np.ndarray,
) -> np.ndarray:
    """Per-pixel (u, v) of each lattice point inside a quad.

    Quad corners clockwise: p0 (0,0), p1 (1,0), p2 (1,1), p3 (0,1).  Solves
    the inverse-bilinear quadratic (reedbeta quadrilateral interpolation;
    same math as vkit/element/score_map.py:139-283).  Returns (H, W, 2)
    float32 with u, v clipped to [0, 1].
    """
    height, width = shape
    p0, p1, p2, p3 = (np_rel_quad[i].astype(np.float32) for i in range(4))

    xs = np.arange(width, dtype=np.float32)[None, :].repeat(height, axis=0)
    ys = np.arange(height, dtype=np.float32)[:, None].repeat(width, axis=1)

    def cross(ax, ay, bx, by):
        return ax * by - ay * bx

    qx = xs - p0[0]
    qy = ys - p0[1]
    b1 = p1 - p0
    b2 = p3 - p0
    b3 = (p0 - p1) - p3 + p2

    scale_a = float(cross(b2[0], b2[1], b3[0], b3[1]))
    np_b = cross(b3[0], b3[1], qx, qy) - float(cross(b1[0], b1[1], b2[0], b2[1]))
    np_c = cross(b1[0], b1[1], qx, qy)

    if abs(scale_a) < 0.001:
        with np.errstate(divide='ignore', invalid='ignore'):
            np_v = np.where(np_b != 0, -np_c / np.where(np_b == 0, 1.0, np_b), 0.0)
    else:
        np_discrim = np.sqrt(np.maximum(np_b**2 - 4 * scale_a * np_c, 0.0))
        scale_i2a = 0.5 / scale_a
        np_v_pos = (-np_b + np_discrim) * scale_i2a
        np_v_neg = (-np_b - np_discrim) * scale_i2a
        pos_valid = ((0.0 <= np_v_pos) & (np_v_pos <= 1.0) & np_active_mask).sum()
        neg_valid = ((0.0 <= np_v_neg) & (np_v_neg <= 1.0) & np_active_mask).sum()
        np_v = np_v_pos if pos_valid >= neg_valid else np_v_neg

    np_v = np.where(np_active_mask, np_v, 0.0)
    np_v = np.clip(np_v, 0.0, 1.0)

    denom_x = b1[0] + b3[0] * np_v
    denom_y = b1[1] + b3[1] * np_v
    use_x = (np.abs(denom_x) > np.abs(denom_y)) & (denom_x != 0.0)
    use_y = (~use_x) & (denom_y != 0.0)
    np_u = np.zeros_like(np_v)
    with np.errstate(divide='ignore', invalid='ignore'):
        np_u = np.where(use_x, (qx - b2[0] * np_v) / np.where(use_x, denom_x, 1.0), np_u)
        np_u = np.where(use_y, (qy - b2[1] * np_v) / np.where(use_y, denom_y, 1.0), np_u)
    np_u = np.where(np_active_mask, np_u, 0.0)
    np_u = np.clip(np_u, 0.0, 1.0)

    return np.stack((np_u, np_v), axis=-1).astype(np.float32)
