"""Default char-heatmap engine: a gaussian bump perspective-warped into
each char quad, with overlap neutralization.

Behavioral spec: vkit/engine/char_heatmap/default.py:30-195 (re-derived;
per-char homographies batch-solved, the neutralization chain composed as
plain array math).
"""
from typing import Optional

import attr
import numpy as np
from numpy.random import Generator as RandomGenerator

from ...element import Mask, ScoreMap, coverage
from ...ops import warp as warp_ops
from ..interface import Engine, EngineExecutorFactory, NoneTypeEngineInitResource
from .type import CharHeatmap, CharHeatmapEngineRunConfig


def build_np_distance(radius: int) -> np.ndarray:
    offsets = np.abs(np.arange(radius * 2 + 1, dtype=np.float32) - radius)
    return np.sqrt(offsets[:, None]**2 + offsets[None, :]**2)


@attr.define
class CharHeatmapDefaultEngineInitConfig:
    # Larger distance factor -> tighter activation.
    gaussian_map_distance_factor: float = 2.25
    gaussian_map_char_radius: int = 25
    gaussian_map_preserving_score_min: float = 0.9
    weight_neutralized_score_map: float = 0.4


@attr.define
class CharHeatmapDefaultDebug:
    score_map_max: ScoreMap
    score_map_min: ScoreMap
    char_overlapped_mask: Mask
    char_neutralized_score_map: ScoreMap
    neutralized_mask: Mask
    neutralized_score_map: ScoreMap


class CharHeatmapDefaultEngine(
    Engine[CharHeatmapDefaultEngineInitConfig, NoneTypeEngineInitResource, CharHeatmapEngineRunConfig, CharHeatmap]
):

    @classmethod
    def get_type_name(cls) -> str:
        return 'default'

    def __init__(self, init_config, init_resource=None):
        super().__init__(init_config, init_resource)
        radius = init_config.gaussian_map_char_radius
        norm_distance = build_np_distance(radius) / radius
        self.np_bump = np.exp(
            -0.5 * (init_config.gaussian_map_distance_factor * norm_distance)**2
        ).astype(np.float32)
        edge = self.np_bump.shape[0] - 1
        self.np_bump_quad = np.asarray(
            [(0, 0), (edge, 0), (edge, edge), (0, edge)], dtype=np.float64
        )

    def _accumulate_char_bumps(self, char_polygons, np_max, np_min):
        """Warp the bump into every char quad; track per-pixel max and min."""
        quads = np.stack([
            p.internals.np_self_relative_points.astype(np.float64)
            for p in char_polygons
        ])
        mats = warp_ops.solve_perspective_batch(
            np.broadcast_to(self.np_bump_quad, quads.shape), quads
        )
        # Tiny per-char rasters: a loop beats padded stacking on this host.
        for mat, polygon in zip(mats, char_polygons):
            bb = polygon.bounding_box
            warped = np.clip(
                warp_ops.warp_perspective_np(self.np_bump, mat, bb.shape),
                0.0, 1.0,
            )
            stencil = polygon.internals.np_mask
            region_max = bb.extract_np_array(np_max)
            region_min = bb.extract_np_array(np_min)
            np.maximum(region_max, np.where(stencil, warped, 0.0), out=region_max)
            np.minimum(region_min, np.where(stencil, warped, 1.0), out=region_min)

    def run(self, run_config: CharHeatmapEngineRunConfig,
            rng: Optional[RandomGenerator] = None) -> CharHeatmap:
        shape = (run_config.height, run_config.width)
        char_polygons = run_config.char_polygons

        np_max = np.zeros(shape, dtype=np.float32)
        np_min = np.ones(shape, dtype=np.float32)
        if char_polygons:
            self._accumulate_char_bumps(char_polygons, np_max, np_min)

        # Neutralize overlap zones, preserving strong activations.
        np_overlap = coverage(shape, char_polygons) > 1
        keep_min = self.init_config.gaussian_map_preserving_score_min
        np_neutralize = np_overlap & (np_max < keep_min)
        np_delta = np.clip(np_max - np_min, 0.0, 1.0)
        np_neutralized = np.where(np_neutralize, np_delta, np_max)

        weight = self.init_config.weight_neutralized_score_map
        score_map = ScoreMap(
            mat=((1 - weight) * np_max + weight * np_neutralized).astype(np.float32)
        )

        debug = None
        if run_config.enable_debug:
            debug = CharHeatmapDefaultDebug(
                score_map_max=ScoreMap(mat=np_max),
                score_map_min=ScoreMap(mat=np_min),
                char_overlapped_mask=Mask(mat=np_overlap.astype(np.uint8)),
                char_neutralized_score_map=ScoreMap(mat=np_delta),
                neutralized_mask=Mask(mat=np_neutralize.astype(np.uint8)),
                neutralized_score_map=ScoreMap(mat=np_neutralized),
            )
        return CharHeatmap(score_map=score_map, debug=debug)


char_heatmap_default_engine_executor_factory = EngineExecutorFactory(
    CharHeatmapDefaultEngine
)
