"""Char mask types. Capability parity: vkit/engine/char_mask/type.py."""
from typing import Optional, Sequence

import attr

from ...element import Box, Mask, Polygon


@attr.define
class CharMaskEngineRunConfig:
    height: int
    width: int
    char_polygons: Sequence[Polygon]
    char_bounding_boxes: Optional[Sequence[Box]] = None
    char_bounding_polygons: Optional[Sequence[Polygon]] = None


@attr.define
class CharMask:
    combined_chars_mask: Mask
    char_masks: Optional[Sequence[Mask]] = None
