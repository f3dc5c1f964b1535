"""Painter: debug visualization of elements over an image.

Capability parity: vkit/mechanism/painter.py:35-493 (palette management +
paint points/lines/boxes/polygons/masks/score-maps/texts).  Drawing runs on a
PIL RGBA overlay composited once; the JET colormap for score maps is computed
in numpy (no cv.applyColorMap).
"""
from typing import Any, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
from PIL import Image as PilImage
from PIL import ImageColor as PilImageColor
from PIL import ImageDraw, ImageFont

from ..element import Box, Image, Line, Mask, Point, Polygon, ScoreMap, Shapable
from ..utility.type import PathType


def _jet_colormap(values: np.ndarray) -> np.ndarray:
    """values in [0, 1] -> RGB uint8 (matplotlib/cv2 JET-like)."""
    v = np.clip(values, 0.0, 1.0)
    four_v = 4.0 * v
    r = np.clip(np.minimum(four_v - 1.5, -four_v + 4.5), 0, 1)
    g = np.clip(np.minimum(four_v - 0.5, -four_v + 3.5), 0, 1)
    b = np.clip(np.minimum(four_v + 0.5, -four_v + 2.5), 0, 1)
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(rgb * 255), 0, 255).astype(np.uint8)


class Painter:

    # A qualitatively-distinct debug palette.
    PALETTE = (
        '#006400',  # darkgreen
        '#00008b',  # darkblue
        '#b03060',  # maroon
        '#ff0000',  # red
        '#ffff00',  # yellow
        '#deb887',  # burlywood
        '#00ff00',  # lime
        '#00ffff',  # aqua
        '#ff00ff',  # fuchsia
        '#6495ed',  # cornflower
    )

    @classmethod
    def get_rgb_tuple_from_color_name(cls, color_name: str) -> Tuple[int, int, int]:
        return PilImageColor.getrgb(color_name)  # type: ignore[return-value]

    @classmethod
    def get_complementary_rgba_tuple(cls, rgba_tuple):
        return tuple(
            255 - val if idx < 3 else val for idx, val in enumerate(rgba_tuple)
        )

    @classmethod
    def get_color_names(
        cls,
        elements_or_num_elements: Union[Iterable[Any], int],
        palette: Sequence[str] = PALETTE,
    ):
        if isinstance(elements_or_num_elements, int):
            elements: Iterable[Any] = range(elements_or_num_elements)
        else:
            elements = elements_or_num_elements
        return tuple(palette[idx % len(palette)] for idx, _ in enumerate(elements))

    @classmethod
    def get_rgb_tuples(
        cls,
        elements_or_num_elements: Union[Iterable[Any], int],
        palette: Sequence[str] = PALETTE,
    ):
        return tuple(
            cls.get_rgb_tuple_from_color_name(color_name)
            for color_name in cls.get_color_names(elements_or_num_elements, palette)
        )

    @classmethod
    def get_rgba_tuples(
        cls,
        num_elements: int,
        color: Optional[Union[str, Iterable[str], Iterable[int]]],
        alpha: float,
        palette: Sequence[str] = PALETTE,
    ):
        if color is None:
            rgb_tuples = cls.get_rgb_tuples(num_elements, palette=palette)
        elif isinstance(color, str):
            rgb_tuples = (cls.get_rgb_tuple_from_color_name(color),) * num_elements
        else:
            colors = tuple(color)
            if colors and isinstance(colors[0], int):
                color_names = [palette[idx % len(palette)] for idx in colors]  # type: ignore[arg-type]
            else:
                color_names = list(colors)  # type: ignore[arg-type]
            rgb_tuples = tuple(
                cls.get_rgb_tuple_from_color_name(name) for name in color_names
            )
        alpha_val = round(255 * alpha)
        return tuple((*rgb, alpha_val) for rgb in rgb_tuples)

    @classmethod
    def create(cls, shapable_or_image: Union[Shapable, Image]) -> 'Painter':
        if isinstance(shapable_or_image, Image):
            image = shapable_or_image.to_rgb_image().copy()
        else:
            image = Image.from_shapable(shapable_or_image, value=255)
        return cls(image)

    def __init__(self, image: Image):
        self.image = image.to_rgb_image().copy()

    def copy(self) -> 'Painter':
        return Painter(self.image.copy())

    def _generate_layer(self) -> PilImage.Image:
        return PilImage.new('RGBA', (self.image.width, self.image.height), (0, 0, 0, 0))

    def _overlay_layer(self, layer: PilImage.Image):
        base = PilImage.fromarray(self.image.mat).convert('RGBA')
        merged = PilImage.alpha_composite(base, layer).convert('RGB')
        self.image.assign_mat(np.array(merged, dtype=np.uint8))

    def paint_points(
        self,
        points: Union[Iterable[Point], Iterable[Tuple[int, int]]],
        color: Optional[Union[str, Iterable[str], Iterable[int]]] = None,
        radius: int = 2,
        alpha: float = 1.0,
    ) -> 'Painter':
        points = [
            point if isinstance(point, Point) else Point.create(y=point[0], x=point[1])
            for point in points
        ]
        rgba_tuples = self.get_rgba_tuples(len(points), color, alpha)
        layer = self._generate_layer()
        draw = ImageDraw.Draw(layer)
        for point, rgba in zip(points, rgba_tuples):
            draw.ellipse(
                (point.x - radius, point.y - radius, point.x + radius, point.y + radius),
                fill=rgba,
            )
        self._overlay_layer(layer)
        return self

    def paint_lines(
        self,
        lines: Iterable[Line],
        color: Optional[Union[str, Iterable[str], Iterable[int]]] = None,
        thickness: int = 1,
        alpha: float = 1.0,
    ) -> 'Painter':
        lines = tuple(lines)
        rgba_tuples = self.get_rgba_tuples(len(lines), color, alpha)
        layer = self._generate_layer()
        draw = ImageDraw.Draw(layer)
        for line, rgba in zip(lines, rgba_tuples):
            draw.line(
                (line.point_begin.x, line.point_begin.y,
                 line.point_end.x, line.point_end.y),
                fill=rgba,
                width=thickness,
            )
        self._overlay_layer(layer)
        return self

    def paint_boxes(
        self,
        boxes: Iterable[Box],
        color: Optional[Union[str, Iterable[str], Iterable[int]]] = None,
        border_thickness: int = 1,
        fill_alpha: float = 0.25,
        alpha: float = 1.0,
    ) -> 'Painter':
        boxes = tuple(boxes)
        rgba_tuples = self.get_rgba_tuples(len(boxes), color, alpha)
        layer = self._generate_layer()
        draw = ImageDraw.Draw(layer)
        for box, rgba in zip(boxes, rgba_tuples):
            fill = (*rgba[:3], round(rgba[3] * fill_alpha))
            draw.rectangle(
                (box.left, box.up, box.right, box.down),
                outline=rgba,
                fill=fill,
                width=border_thickness,
            )
        self._overlay_layer(layer)
        return self

    def paint_polygons(
        self,
        polygons: Iterable[Polygon],
        color: Optional[Union[str, Iterable[str], Iterable[int]]] = None,
        fill_alpha: float = 0.25,
        alpha: float = 1.0,
        enable_index: bool = False,
    ) -> 'Painter':
        polygons = tuple(polygons)
        rgba_tuples = self.get_rgba_tuples(len(polygons), color, alpha)
        layer = self._generate_layer()
        draw = ImageDraw.Draw(layer)
        for idx, (polygon, rgba) in enumerate(zip(polygons, rgba_tuples)):
            xy = [(p.x, p.y) for p in polygon.points]
            fill = (*rgba[:3], round(rgba[3] * fill_alpha))
            draw.polygon(xy, outline=rgba, fill=fill)
            if enable_index:
                center = polygon.get_center_point()
                draw.text((center.x, center.y), str(idx), fill=rgba)
        self._overlay_layer(layer)
        return self

    def paint_mask(
        self,
        mask: Mask,
        color: Union[str, Tuple[int, int, int]] = 'red',
        alpha: float = 0.5,
    ) -> 'Painter':
        if isinstance(color, str):
            color = self.get_rgb_tuple_from_color_name(color)
        box = mask.box or Box.from_shapable(mask)
        box.fill_image(
            self.image,
            value=color,
            image_mask=mask,
            alpha=alpha,
        )
        return self

    def paint_masks(
        self,
        masks: Iterable[Mask],
        color: Optional[Union[str, Iterable[str], Iterable[int]]] = None,
        alpha: float = 0.5,
    ) -> 'Painter':
        masks = tuple(masks)
        rgba_tuples = self.get_rgba_tuples(len(masks), color, alpha)
        for mask, rgba in zip(masks, rgba_tuples):
            self.paint_mask(mask, color=rgba[:3], alpha=alpha)
        return self

    def paint_score_map(
        self,
        score_map: ScoreMap,
        alpha: float = 0.5,
    ) -> 'Painter':
        mat = score_map.mat
        if not score_map.is_prob:
            lo, hi = float(mat.min()), float(mat.max())
            mat = (mat - lo) / max(hi - lo, 1e-6)
        color_mat = _jet_colormap(mat)
        box = score_map.box or Box.from_shapable(score_map)
        box.fill_image(self.image, value=color_mat, alpha=alpha)
        return self

    def paint_texts(
        self,
        texts: Iterable[str],
        points: Union[Iterable[Point], Iterable[Tuple[int, int]]],
        color: Optional[Union[str, Iterable[str], Iterable[int]]] = None,
        alpha: float = 1.0,
        font_size: Optional[int] = None,
    ) -> 'Painter':
        texts = tuple(texts)
        points = [
            point if isinstance(point, Point) else Point.create(y=point[0], x=point[1])
            for point in points
        ]
        assert len(texts) == len(points)
        rgba_tuples = self.get_rgba_tuples(len(texts), color, alpha)
        layer = self._generate_layer()
        draw = ImageDraw.Draw(layer)
        font = None
        if font_size:
            try:
                font = ImageFont.load_default(size=font_size)
            except Exception:  # noqa: BLE001 - PIL<10 fallback.
                font = None
        for text, point, rgba in zip(texts, points, rgba_tuples):
            draw.text((point.x, point.y), text, fill=rgba, font=font)
        self._overlay_layer(layer)
        return self

    def to_file(self, path: PathType, disable_to_rgb_image: bool = False):
        self.image.to_file(path, disable_to_rgb_image=disable_to_rgb_image)
