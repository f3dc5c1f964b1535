"""Ellipse seal-impression engine: stamp geometry synthesis.

Samples color/alpha, lays curved text-line slots along elliptical arc
bands, stamps an optional icon and internal text-line box, and rasterizes
the stroked border ring.  Behavioral spec:
vkit/engine/seal_impression/ellipse.py:38-720 (re-derived; arc points are
vectorized and the band bookkeeping lives in one ArcBand struct).
"""
from enum import Enum, unique
from typing import List, Optional, Sequence, Tuple

import attr
import numpy as np
from numpy.random import Generator as RandomGenerator

from ...element import Box, ImageMode, Mask, Point
from ...mechanism.distortion.photometric.streak import draw_ellipse_ring
from ...utility import normalize_to_keys_and_probs, rng_choice
from ..image.selector import image_selector_engine_executor_factory
from ..interface import Engine, EngineExecutorFactory, NoneTypeEngineInitResource
from .type import (
    CharSlot,
    SealImpression,
    SealImpressionEngineRunConfig,
    TextLineSlot,
)


@attr.define
class SealImpressionEllipseEngineInitConfig:
    # Color & transparency.
    color_rgb_min: int = 128
    color_rgb_max: int = 255
    weight_color_grayscale: float = 5
    weight_color_red: float = 10
    weight_color_green: float = 1
    weight_color_blue: float = 1
    alpha_min: float = 0.25
    alpha_max: float = 0.75

    # Border.
    border_thickness_ratio_min: float = 0.0
    border_thickness_ratio_max: float = 0.03
    border_thickness_min: int = 2
    weight_border_style_solid_line: float = 3
    weight_border_style_double_lines: float = 1

    # Char slots (ratios relative to seal height).
    pad_ratio_min: float = 0.03
    pad_ratio_max: float = 0.08
    text_line_height_ratio_min: float = 0.075
    text_line_height_ratio_max: float = 0.2
    weight_text_line_mode_one: float = 1
    weight_text_line_mode_two: float = 1
    text_line_mode_one_gap_ratio_min: float = 0.1
    text_line_mode_one_gap_ratio_max: float = 0.55
    text_line_mode_two_gap_ratio_min: float = 0.1
    text_line_mode_two_gap_ratio_max: float = 0.4
    char_aspect_ratio_min: float = 0.4
    char_aspect_ratio_max: float = 0.9
    char_space_ratio_min: float = 0.05
    char_space_ratio_max: float = 0.25
    angle_step_min: int = 10

    # Icon.
    icon_image_folders: Optional[Sequence[str]] = None
    icon_image_grayscale_min: int = 127
    prob_add_icon: float = 0.9
    icon_height_ratio_min: float = 0.35
    icon_height_ratio_max: float = 0.75
    icon_width_ratio_min: float = 0.35
    icon_width_ratio_max: float = 0.75

    # Internal text line.
    prob_add_internal_text_line: float = 0.5
    internal_text_line_height_ratio_min: float = 0.075
    internal_text_line_height_ratio_max: float = 0.15
    internal_text_line_width_ratio_min: float = 0.22
    internal_text_line_width_ratio_max: float = 0.5


@unique
class SealImpressionEllipseBorderStyle(Enum):
    SOLID_LINE = 'solid_line'
    DOUBLE_LINES = 'double_lines'


@unique
class SealImpressionEllipseTextLineMode(Enum):
    ONE = 'one'
    TWO = 'two'


@unique
class SealImpressionEllipseColorMode(Enum):
    GRAYSCALE = 'grayscale'
    RED = 'red'
    GREEN = 'green'
    BLUE = 'blue'


_COLOR_TEMPLATES = {
    SealImpressionEllipseColorMode.GRAYSCALE: (1, 1, 1),
    SealImpressionEllipseColorMode.RED: (1, 0, 0),
    SealImpressionEllipseColorMode.GREEN: (0, 1, 0),
    SealImpressionEllipseColorMode.BLUE: (0, 0, 1),
}


@attr.define
class ArcBand:
    """One curved text band between two concentric ellipses."""

    outer_axes: Tuple[int, int]   # (height, width) of the outer ellipse
    inner_axes: Tuple[int, int]
    text_line_height: int
    angle_begin: int
    angle_end: int
    clockwise: bool


def arc_points(axes: Tuple[int, int], center_yx: Tuple[int, int],
               angles: np.ndarray) -> List[Point]:
    """Points on an ellipse at the given angles (degrees, clockwise)."""
    theta = np.radians(angles.astype(np.float64))
    ys = np.sin(theta) * (axes[0] / 2) + center_yx[0]
    xs = np.cos(theta) * (axes[1] / 2) + center_yx[1]
    return [Point.create(y=float(y), x=float(x)) for y, x in zip(ys, xs)]


def arc_angles(angle_begin: int, angle_end: int, step: int,
               keep_last_oob: bool) -> np.ndarray:
    """arange over the arc; optionally one overshooting angle at the end."""
    bound = angle_end + (step if keep_last_oob else 1)
    return np.arange(angle_begin, bound, step)


class SealImpressionEllipseEngine(
    Engine[SealImpressionEllipseEngineInitConfig, NoneTypeEngineInitResource, SealImpressionEngineRunConfig, SealImpression]
):

    @classmethod
    def get_type_name(cls) -> str:
        return 'ellipse'

    def __init__(self, init_config, init_resource=None):
        super().__init__(init_config, init_resource)
        cfg = init_config

        self.border_styles, self.border_styles_probs = normalize_to_keys_and_probs([
            (SealImpressionEllipseBorderStyle.SOLID_LINE,
             cfg.weight_border_style_solid_line),
            (SealImpressionEllipseBorderStyle.DOUBLE_LINES,
             cfg.weight_border_style_double_lines),
        ])
        self.text_line_modes, self.text_line_modes_probs = normalize_to_keys_and_probs([
            (SealImpressionEllipseTextLineMode.ONE, cfg.weight_text_line_mode_one),
            (SealImpressionEllipseTextLineMode.TWO, cfg.weight_text_line_mode_two),
        ])
        self.color_modes, self.color_modes_probs = normalize_to_keys_and_probs([
            (SealImpressionEllipseColorMode.GRAYSCALE, cfg.weight_color_grayscale),
            (SealImpressionEllipseColorMode.RED, cfg.weight_color_red),
            (SealImpressionEllipseColorMode.GREEN, cfg.weight_color_green),
            (SealImpressionEllipseColorMode.BLUE, cfg.weight_color_blue),
        ])

        self.icon_image_selector = None
        if cfg.icon_image_folders:
            self.icon_image_selector = image_selector_engine_executor_factory.create({
                'image_folders': cfg.icon_image_folders,
                'target_image_mode': ImageMode.GRAYSCALE,
                'force_resize': True,
            })

    # ------------------------------------------------------------------
    # Appearance.
    # ------------------------------------------------------------------

    def sample_alpha_and_color(self, rng: RandomGenerator):
        cfg = self.init_config
        alpha = float(rng.uniform(cfg.alpha_min, cfg.alpha_max))
        mode = rng_choice(rng, self.color_modes, probs=self.color_modes_probs)
        value = int(rng.integers(cfg.color_rgb_min, cfg.color_rgb_max + 1))
        color = tuple(value * gate for gate in _COLOR_TEMPLATES[mode])
        return alpha, color

    # ------------------------------------------------------------------
    # Curved text bands.
    # ------------------------------------------------------------------

    def _sample_band_geometry(self, height: int, width: int,
                              rng: RandomGenerator) -> List[ArcBand]:
        cfg = self.init_config
        pad = round(float(rng.uniform(cfg.pad_ratio_min, cfg.pad_ratio_max)) * height)
        outer = (height - 2 * pad, width - 2 * pad)
        assert outer[0] > 0 and outer[1] > 0

        mode = rng_choice(rng, self.text_line_modes, probs=self.text_line_modes_probs)

        def band(angle_begin: int, angle_end: int, clockwise: bool) -> ArcBand:
            ratio = float(rng.uniform(cfg.text_line_height_ratio_min,
                                      cfg.text_line_height_ratio_max))
            line_height = round(ratio * height)
            assert line_height > 0
            inner = (outer[0] - 2 * line_height, outer[1] - 2 * line_height)
            assert inner[0] > 0 and inner[1] > 0
            return ArcBand(
                outer_axes=outer, inner_axes=inner,
                text_line_height=line_height,
                angle_begin=angle_begin, angle_end=angle_end,
                clockwise=clockwise,
            )

        if mode == SealImpressionEllipseTextLineMode.ONE:
            gap_ratio = float(rng.uniform(cfg.text_line_mode_one_gap_ratio_min,
                                          cfg.text_line_mode_one_gap_ratio_max))
            gap = round(gap_ratio * 360)
            begin = 90 + gap // 2
            return [band(begin, begin + (360 - gap) - 1, clockwise=True)]

        gap_ratio = float(rng.uniform(cfg.text_line_mode_two_gap_ratio_min,
                                      cfg.text_line_mode_two_gap_ratio_max))
        half_gap = round(gap_ratio * 360 / 2)
        return [
            band(180 + half_gap, 360 - half_gap, clockwise=True),
            band(half_gap, 180 - half_gap, clockwise=False),
        ]

    def _slots_for_band(self, arc_band: ArcBand, center_yx: Tuple[int, int],
                        rng: RandomGenerator) -> TextLineSlot:
        cfg = self.init_config
        char_aspect = float(rng.uniform(cfg.char_aspect_ratio_min,
                                        cfg.char_aspect_ratio_max))
        space_ratio = float(rng.uniform(cfg.char_space_ratio_min,
                                        cfg.char_space_ratio_max))
        char_w = max(1, round(arc_band.text_line_height * char_aspect))
        char_gap = max(1, round(arc_band.text_line_height * space_ratio))
        radius = max(1, center_yx[0])
        step = max(
            cfg.angle_step_min,
            round(360 * (char_w + char_gap) / (2 * np.pi * radius)),
        )

        keep_last_oob = rng.random() < 0.5
        angles = arc_angles(arc_band.angle_begin, arc_band.angle_end, step,
                            keep_last_oob)
        # Clockwise bands read outer->inner; counter-clockwise the reverse.
        top, bottom = (
            (arc_band.outer_axes, arc_band.inner_axes) if arc_band.clockwise
            else (arc_band.inner_axes, arc_band.outer_axes)
        )
        ups = arc_points(top, center_yx, angles)
        downs = arc_points(bottom, center_yx, angles)
        char_slots = [CharSlot.build(pu, pd) for pu, pd in zip(ups, downs)]
        if not arc_band.clockwise:
            char_slots.reverse()

        return TextLineSlot(
            text_line_height=arc_band.text_line_height,
            char_aspect_ratio=char_aspect,
            char_slots=char_slots,
        )

    # ------------------------------------------------------------------
    # Background / icon / internal text line.
    # ------------------------------------------------------------------

    def _sample_icon_box(self, height: int, width: int,
                         inner_shape: Tuple[int, int],
                         rng: RandomGenerator) -> Box:
        cfg = self.init_config
        box_h = round(inner_shape[0] * rng.uniform(cfg.icon_height_ratio_min,
                                                   cfg.icon_height_ratio_max))
        box_w = round(inner_shape[1] * rng.uniform(cfg.icon_width_ratio_min,
                                                   cfg.icon_width_ratio_max))
        up = (height - box_h) // 2
        left = (width - box_w) // 2
        return Box(up, up + box_h - 1, left, left + box_w - 1)

    def _sample_internal_text_line_box(
        self, height: int, width: int, inner_shape: Tuple[int, int],
        icon_box_down: Optional[int], rng: RandomGenerator,
    ) -> Optional[Box]:
        cfg = self.init_config
        inner_h, inner_w = inner_shape
        if inner_h > inner_w:
            return None

        box_h = round(inner_h * rng.uniform(
            cfg.internal_text_line_height_ratio_min,
            cfg.internal_text_line_height_ratio_max,
        ))
        mid = height // 2
        up = icon_box_down + 1 if icon_box_down else mid
        down = min(height - 1, mid + inner_h // 2 - 1, up + box_h - 1)
        if up > down:
            return None

        # The widest box fitting inside the inner ellipse at this height.
        drop = down + 1 - mid
        semi_x = inner_w / 2
        semi_y = inner_h / 2
        fit_w = round(2 * semi_y * np.sqrt(max(semi_x**2 - drop**2, 0.0)) / semi_x)
        box_w = round(inner_w * rng.uniform(
            cfg.internal_text_line_width_ratio_min,
            cfg.internal_text_line_width_ratio_max,
        ))
        box_w = max(fit_w, box_w)
        left = (width - box_w) // 2
        if left > left + box_w - 1:
            return None
        return Box(up, down, left, left + box_w - 1)

    def _render_border(self, np_mask: np.ndarray, height: int, width: int,
                       rng: RandomGenerator) -> None:
        cfg = self.init_config
        thickness = max(
            cfg.border_thickness_min,
            round(height * rng.uniform(cfg.border_thickness_ratio_min,
                                       cfg.border_thickness_ratio_max)),
        )
        center = (width // 2, height // 2)
        axes = (width // 2 - thickness - 1, height // 2 - thickness - 1)
        draw_ellipse_ring(np_mask, center, axes, thickness)

        style = rng_choice(rng, self.border_styles, probs=self.border_styles_probs)
        hollow_room = thickness - 2 * cfg.border_thickness_min
        if style == SealImpressionEllipseBorderStyle.DOUBLE_LINES and hollow_room > 1:
            # Hollow the stroke's center to leave two concentric lines.
            np_hole = np.zeros_like(np_mask)
            draw_ellipse_ring(
                np_hole, center, axes, int(rng.integers(1, hollow_room))
            )
            np_mask[np_hole > 0] = 0

    def run(self, run_config: SealImpressionEngineRunConfig,
            rng: Optional[RandomGenerator] = None) -> SealImpression:
        assert rng is not None
        cfg = self.init_config
        height, width = run_config.height, run_config.width
        center_yx = (height // 2, width // 2)

        alpha, color = self.sample_alpha_and_color(rng)

        bands = self._sample_band_geometry(height, width, rng)
        text_line_slots = [
            self._slots_for_band(arc_band, center_yx, rng) for arc_band in bands
        ]
        inner_shape = (
            min(b.inner_axes[0] for b in bands),
            min(b.inner_axes[1] for b in bands),
        )

        background_mask = Mask.from_shape((height, width))
        icon_box_down = None
        with background_mask.writable_context:
            self._render_border(background_mask.mat, height, width, rng)
        if self.icon_image_selector and rng.random() < cfg.prob_add_icon:
            icon_box = self._sample_icon_box(height, width, inner_shape, rng)
            icon_box_down = icon_box.down
            icon = self.icon_image_selector.run(
                {'height': icon_box.height, 'width': icon_box.width}, rng
            )
            icon_box.fill_mask(
                background_mask,
                Mask(mat=(icon.mat > cfg.icon_image_grayscale_min).astype(np.uint8)),
            )

        internal_text_line_box = None
        if rng.random() < cfg.prob_add_internal_text_line:
            internal_text_line_box = self._sample_internal_text_line_box(
                height, width, inner_shape, icon_box_down, rng
            )

        return SealImpression(
            alpha=alpha,
            color=color,
            background_mask=background_mask,
            text_line_slots=text_line_slots,
            internal_text_line_box=internal_text_line_box,
        )


seal_impression_ellipse_engine_executor_factory = EngineExecutorFactory(
    SealImpressionEllipseEngine
)
