"""Element layer: host-side label algebra (geometry + raster set-ops).

Public surface parity: vkit/element/__init__.py:14-22.
"""
from .blend import ElementSetOperationMode, Shapable
from .geom import (
    Box,
    BoxOverlappingValidator,
    Line,
    Point,
    PointList,
    PointTuple,
    Polygon,
    estimate_polygon_height,
    unionize_polygons,
)
from .raster import (
    Mask,
    MaskSetItemConfig,
    ScoreMap,
    ScoreMapSetItemConfig,
    coverage,
    lift,
    mask_from_elements,
    paint,
    paint_many,
)
from .visual import Image, ImageMode, ImageSetItemConfig
from .lexicon import Lexicon, LexiconCollection
from ..ops.resize_taps import Interpolation
