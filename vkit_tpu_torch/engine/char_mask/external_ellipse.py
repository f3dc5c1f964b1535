"""External-ellipse char-mask engine: a circumscribing ellipse template,
perspective-warped by each char quad's deformation.

Behavioral spec: vkit/engine/char_mask/external_ellipse.py:34-258
(re-derived; the four manual edge-trim blocks collapse into a Box clip).
"""
import itertools
import math
from typing import List, Optional, Tuple

import attr
import numpy as np
from numpy.random import Generator as RandomGenerator

from ...element import Box, Mask, Polygon
from ...ops import warp as warp_ops
from ..char_heatmap.default import build_np_distance
from ..interface import Engine, EngineExecutorFactory, NoneTypeEngineInitResource
from .type import CharMask, CharMaskEngineRunConfig


@attr.define
class CharMaskExternalEllipseEngineInitConfig:
    internal_side_length: int = 40


class _EllipseTemplate:
    """A disk circumscribing a centered square char cell."""

    def __init__(self, internal_side: int):
        radius = math.ceil(internal_side / math.sqrt(2))
        self.np_mask = (build_np_distance(radius) <= radius).astype(np.uint8)
        side = self.np_mask.shape[0]

        pad = (side - internal_side) // 2
        lo, hi = pad, pad + internal_side - 1
        # Corner order matches the char-quad contract (ul, dl, dr, ur in
        # (y, x) pairs as the reference lays them out).
        self.np_cell_quad = np.asarray(
            [(lo, lo), (hi, lo), (hi, hi), (lo, hi)], dtype=np.float64
        )
        edge = side - 1
        self.np_outer_quad = np.asarray(
            [(0, 0), (edge, 0), (edge, edge), (0, edge)], dtype=np.float64
        )

    def warp_to(self, char_polygon: Polygon) -> Optional[Tuple[np.ndarray, float, float]]:
        """Deform by the quad; returns (warped mask, x_offset, y_offset)."""
        to_quad = warp_ops.solve_perspective(
            self.np_cell_quad,
            char_polygon.internals.np_self_relative_points.astype(np.float64),
        )
        outer = warp_ops.affine_np_points(to_quad, self.np_outer_quad)
        x_off = outer[:, 0].min()
        y_off = outer[:, 1].min()
        outer = outer - [x_off, y_off]
        height = math.ceil(outer[:, 1].max())
        width = math.ceil(outer[:, 0].max())
        if height <= 0 or width <= 0:
            return None
        warped = warp_ops.warp_perspective_np(
            self.np_mask,
            warp_ops.solve_perspective(self.np_outer_quad, outer),
            (height, width),
        )
        return warped, float(x_off), float(y_off)


class CharMaskExternalEllipseEngine(
    Engine[CharMaskExternalEllipseEngineInitConfig, NoneTypeEngineInitResource, CharMaskEngineRunConfig, CharMask]
):

    @classmethod
    def get_type_name(cls) -> str:
        return 'external_ellipse'

    def __init__(self, init_config, init_resource=None):
        super().__init__(init_config, init_resource)
        self.template = _EllipseTemplate(init_config.internal_side_length)

    @staticmethod
    def _bounds(run_config: CharMaskEngineRunConfig):
        boxes = run_config.char_bounding_boxes
        polys = run_config.char_bounding_polygons
        assert not (boxes and polys)
        for bounds in (boxes, polys):
            if bounds:
                assert len(bounds) == len(run_config.char_polygons)
                return bounds
        return itertools.repeat(
            Box(0, run_config.height - 1, 0, run_config.width - 1)
        )

    def run(self, run_config: CharMaskEngineRunConfig,
            rng: Optional[RandomGenerator] = None) -> CharMask:
        combined = Mask.from_shape((run_config.height, run_config.width))
        char_masks: List[Mask] = []

        for char_polygon, bound in zip(run_config.char_polygons,
                                       self._bounds(run_config)):
            assert char_polygon.num_points == 4
            warped = self.template.warp_to(char_polygon)
            if warped is None:
                continue
            np_warped, x_off, y_off = warped

            xy = char_polygon.np_xy
            up = round(float(xy[:, 1].min()) + y_off)
            left = round(float(xy[:, 0].min()) + x_off)
            placed = Box(up, up + np_warped.shape[0] - 1,
                         left, left + np_warped.shape[1] - 1)

            bound_box = bound if isinstance(bound, Box) else bound.bounding_box
            clipped = Box(
                max(placed.up, bound_box.up),
                min(placed.down, bound_box.down),
                max(placed.left, bound_box.left),
                min(placed.right, bound_box.right),
            )
            if clipped.up > clipped.down or clipped.left > clipped.right:
                continue
            window = clipped.to_relative_box(placed.up, placed.left)
            char_mask = Mask(
                mat=np.ascontiguousarray(window.extract_np_array(np_warped)),
                box=clipped,
            )

            if isinstance(bound, Polygon):
                # Zero pixels outside the bounding polygon's footprint.
                gate = clipped.extract_mask(bound.mask.to_inverted_mask())
                gate.fill_mask(char_mask, 0)

            char_masks.append(char_mask)
            char_mask.fill_mask(combined, 1, keep_max_value=True)

        return CharMask(combined_chars_mask=combined, char_masks=char_masks)


char_mask_external_ellipse_engine_executor_factory = EngineExecutorFactory(
    CharMaskExternalEllipseEngine
)
