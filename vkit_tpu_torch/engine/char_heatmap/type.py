"""Char heatmap types. Capability parity: vkit/engine/char_heatmap/type.py."""
from typing import Any, Sequence

import attr

from ...element import Polygon, ScoreMap


@attr.define
class CharHeatmapEngineRunConfig:
    height: int
    width: int
    char_polygons: Sequence[Polygon]
    enable_debug: bool = False


@attr.define
class CharHeatmap:
    score_map: ScoreMap
    debug: Any = None
