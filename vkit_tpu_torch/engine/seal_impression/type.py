"""Seal impression types.

Behavioral spec: vkit/engine/seal_impression/type.py:22-63 (re-derived).
"""
import math
from typing import Optional, Sequence, Tuple

import attr

from ...element import Box, Mask, Point


@attr.define
class CharSlot:
    """One character anchor on a seal arc: its baseline direction angle."""

    angle: int
    point_up: Point
    point_down: Point

    @classmethod
    def build(cls, point_up: Point, point_down: Point) -> 'CharSlot':
        degrees = math.degrees(math.atan2(
            point_up.smooth_y - point_down.smooth_y,
            point_up.smooth_x - point_down.smooth_x,
        )) % 360
        return cls(angle=round(degrees), point_up=point_up, point_down=point_down)


@attr.define
class TextLineSlot:
    text_line_height: int
    char_aspect_ratio: float
    char_slots: Sequence[CharSlot]


@attr.define
class SealImpression:
    alpha: float
    color: Tuple[int, int, int]
    background_mask: Mask
    text_line_slots: Sequence[TextLineSlot]
    internal_text_line_box: Optional[Box]

    @property
    def shape(self) -> Tuple[int, int]:
        return self.background_mask.shape


@attr.define
class SealImpressionEngineRunConfig:
    height: int
    width: int
