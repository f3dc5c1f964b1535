"""Composite core shared by every raster element.

One implementation of masked / weighted / preferential writes serves Mask,
ScoreMap and Image alike (behavioral spec: vkit/element/opt.py:118-209 and
vkit/element/type.py:19-42; re-derived, not ported).  The device-side twin
lives in vkit_tpu/ops/blend.py.
"""
from enum import Enum, unique
from typing import Optional, Tuple, Union

import numpy as np

Scalar = Union[int, float]
SrcValue = Union[np.ndarray, Tuple[float, ...], float, int]
Weight = Union[np.ndarray, float]


class Shapable:
    """Anything with an (height, width) extent."""

    @property
    def height(self) -> int:
        raise NotImplementedError()

    @property
    def width(self) -> int:
        raise NotImplementedError()

    @property
    def shape(self) -> Tuple[int, int]:
        return self.height, self.width

    @property
    def area(self) -> int:
        return self.height * self.width


@unique
class ElementSetOperationMode(Enum):
    # Values are part of the public config surface; names must stay stable.
    UNION = 'union'
    DISTINCT = 'distinct'
    INTERSECT = 'intersect'


def shape_of(obj) -> Tuple[int, int]:
    """Accept anything with a .shape, or a raw (height, width) tuple."""
    shape = getattr(obj, 'shape', None)
    if shape is not None:
        h, w = shape[:2]
    else:
        h, w = obj
    return int(h), int(w)


def clamp(val, limit: int):
    """Clamp a coordinate into [0, limit - 1]."""
    if val < 0:
        return 0
    last = limit - 1
    return last if val > last else val


def rescale(val, size: int, new_size: int):
    """Map a coordinate from a `size`-extent onto a `new_size`-extent."""
    return clamp(val * new_size / size, new_size)


def scaled_shape(
    height: int,
    width: int,
    new_height: Optional[int] = None,
    new_width: Optional[int] = None,
) -> Tuple[int, int]:
    """Complete a target shape, deriving the missing side by aspect ratio."""
    if new_height is None and new_width is None:
        raise RuntimeError('need new_height and/or new_width')
    if new_height is None:
        assert new_width is not None
        new_height = round(new_width * height / width)
    elif new_width is None:
        new_width = round(new_height * width / height)
    return new_height, new_width


def _broadcast_gate(gate: np.ndarray, ndim: int) -> np.ndarray:
    """Lift an (H, W) bool gate to cover trailing channel dims."""
    if gate.ndim + 1 == ndim:
        return gate[..., None]
    assert gate.ndim == ndim
    return gate


def _src_as_array(dst: np.ndarray, src: SrcValue) -> np.ndarray:
    """Materialize `src` as an array matching dst's shape and dtype."""
    if isinstance(src, np.ndarray):
        if src.shape != dst.shape:
            raise RuntimeError(
                f'src shape {src.shape} incompatible with dst {dst.shape}'
            )
        return src if src.dtype == dst.dtype else src.astype(dst.dtype)
    if isinstance(src, tuple):
        if dst.ndim != 3 or len(src) != dst.shape[2]:
            raise RuntimeError(f'channel tuple {src} does not fit dst {dst.shape}')
    return np.full_like(dst, src)


def compose(
    dst: np.ndarray,
    src: SrcValue,
    where: Optional[np.ndarray] = None,
    weight: Weight = 1.0,
    prefer_max: bool = False,
    prefer_min: bool = False,
) -> None:
    """In-place composite of `src` onto the writable array `dst`.

    where:   optional (H, W) bool gate restricting the write.
    weight:  scalar or per-pixel (H, W) float alpha; 1.0 = opaque.
    prefer_max / prefer_min: write only where src beats dst (opaque only).

    Blended values truncate (not round) back to dst.dtype, matching the
    reference blend semantics exactly.
    """
    assert not (prefer_max and prefer_min)

    opaque = isinstance(weight, (int, float)) and float(weight) == 1.0

    # Opaque scalar write through a gate: the dominant fast path.
    if (
        opaque and where is not None and not prefer_max and not prefer_min
        and not isinstance(src, np.ndarray)
    ):
        dst[where] = src
        return

    if opaque:
        src_arr = _src_as_array(dst, src)
        if prefer_max or prefer_min:
            beats = (dst < src_arr) if prefer_max else (dst > src_arr)
            if where is not None:
                beats &= _broadcast_gate(where.astype(bool), dst.ndim)
            np.putmask(dst, beats, src_arr)
        elif where is None:
            np.copyto(dst, src_arr)
        else:
            dst[where] = src_arr[where]
        return

    # Translucent path: float32 lerp.  prefer_* is undefined here by spec.
    if isinstance(weight, (int, float)):
        w = float(weight)
        if not 0.0 <= w <= 1.0:
            raise RuntimeError(f'weight={w} out of [0, 1]')
        if w == 0.0:
            return
        alpha = np.full(dst.shape[:2], w, dtype=np.float32)
    else:
        alpha = weight.astype(np.float32)
    if alpha.shape != dst.shape:
        alpha = _broadcast_gate(alpha, dst.ndim)

    src_arr = _src_as_array(dst, src)
    mixed = (
        dst.astype(np.float32) * (1.0 - alpha) + src_arr.astype(np.float32) * alpha
    ).astype(dst.dtype)
    if where is None:
        np.copyto(dst, mixed)
    else:
        dst[where] = mixed[where]


def equal_values(a, b) -> bool:
    """Deep equality across rasters / ndarrays / tuples / scalars.

    Powers the single-write optimization in the multi-element paint engine
    (spec: vkit/element/uniqueness.py:20-90).
    """
    if a is b:
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, np.ndarray):
        return bool(np.array_equal(a, b))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(equal_values(x, y) for x, y in zip(a, b))
    mat = getattr(a, 'mat', None)
    if mat is not None:
        return bool(
            np.array_equal(mat, b.mat)
            and getattr(a, 'box', None) == getattr(b, 'box', None)
        )
    return bool(a == b)


def all_equal_values(values) -> bool:
    assert values
    head = values[0]
    return all(equal_values(head, v) for v in values[1:])
