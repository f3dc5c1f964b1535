"""Cropper: sample a (crop_size x crop_size) window with pad/core geometry.

Frames: ``original_box`` selects source pixels; ``target_box`` places them
on the crop canvas; ``target_core_box`` / ``original_core_box`` delimit the
un-padded core in each frame.  Behavioral spec: vkit/mechanism/cropper.py:
28-376 (re-derived; one per-axis span sampler + one generic crop routine
replace the per-raster-kind method triplication).
"""
from typing import NamedTuple, Tuple

from numpy.random import Generator as RandomGenerator

from ..element import Box, Image, Mask, Point, ScoreMap


class AxisSpan(NamedTuple):
    """Placement of one axis: source [begin, end] lands at target_offset."""

    target_offset: int
    begin: int
    end: int


def _random_span(core_size: int, pad_size: int, crop_size: int, length: int,
                 rng: RandomGenerator) -> AxisSpan:
    if core_size <= length:
        core_begin = int(rng.integers(0, length - core_size + 1))
        begin = core_begin - pad_size
        offset = max(0, -begin)
        begin = max(0, begin)
    else:
        # Content shorter than the core: center-ish placement inside it.
        begin = 0
        offset = pad_size + int(rng.integers(0, core_size - length + 1))
    end = min(length - 1, begin + (crop_size - offset) - 1)
    return AxisSpan(offset, begin, end)


def _centered_span(center: int, crop_size: int, length: int) -> AxisSpan:
    begin = center - crop_size // 2
    offset = max(0, -begin)
    begin = max(0, begin)
    end = min(length - 1, begin + crop_size - 1 - offset)
    return AxisSpan(offset, begin, end)


class Cropper:

    def __init__(self, shape: Tuple[int, int], core_size: int, pad_size: int,
                 pad_value: int, vert: AxisSpan, hori: AxisSpan):
        self.height, self.width = shape
        self.core_size = core_size
        self.pad_size = pad_size
        self.pad_value = pad_value
        self.crop_size = 2 * pad_size + core_size

        self.original_box = Box(vert.begin, vert.end, hori.begin, hori.end)
        self.target_box = Box(
            vert.target_offset,
            vert.target_offset + self.original_box.height - 1,
            hori.target_offset,
            hori.target_offset + self.original_box.width - 1,
        )
        self.target_core_box = Box(
            pad_size, pad_size + core_size - 1,
            pad_size, pad_size + core_size - 1,
        )
        # The core region mapped back into the source frame.
        self.original_core_box = Box(
            self.original_box.up + (self.target_core_box.up - self.target_box.up),
            self.original_box.down + (self.target_core_box.down - self.target_box.down),
            self.original_box.left + (self.target_core_box.left - self.target_box.left),
            self.original_box.right + (self.target_core_box.right - self.target_box.right),
        )

    @classmethod
    def create_from_random_proposal(cls, shape: Tuple[int, int], core_size: int,
                                    pad_size: int, rng: RandomGenerator,
                                    pad_value: int = 0) -> 'Cropper':
        height, width = shape
        crop_size = 2 * pad_size + core_size
        return cls(
            shape, core_size, pad_size, pad_value,
            vert=_random_span(core_size, pad_size, crop_size, height, rng),
            hori=_random_span(core_size, pad_size, crop_size, width, rng),
        )

    @classmethod
    def create_from_center_point(cls, shape: Tuple[int, int], core_size: int,
                                 pad_size: int, center_point: Point,
                                 pad_value: int = 0) -> 'Cropper':
        height, width = shape
        assert 0 <= center_point.y < height and 0 <= center_point.x < width
        crop_size = 2 * pad_size + core_size
        return cls(
            shape, core_size, pad_size, pad_value,
            vert=_centered_span(center_point.y, crop_size, height),
            hori=_centered_span(center_point.x, crop_size, width),
        )

    @property
    def need_post_filling(self) -> bool:
        return self.original_box.shape != (self.crop_size, self.crop_size)

    @property
    def cropped_shape(self) -> Tuple[int, int]:
        return self.crop_size, self.crop_size

    # One generic crop routine serves every raster kind.

    def _crop(self, raster, make_blank, core_only: bool):
        from ..element.raster import lift, paint
        out = lift(self.original_box, raster)
        if self.need_post_filling:
            blank = make_blank()
            paint(blank, self.target_box, out)
            out = blank
        if core_only:
            out = lift(self.target_core_box, out).to_box_attached(
                self.target_core_box
            )
        return out

    def crop_mask(self, mask: Mask, core_only: bool = False) -> Mask:
        return self._crop(
            mask, lambda: Mask.from_shape(self.cropped_shape), core_only
        )

    def crop_score_map(self, score_map: ScoreMap, core_only: bool = False
                       ) -> ScoreMap:
        return self._crop(
            score_map,
            lambda: ScoreMap.from_shape(self.cropped_shape,
                                        is_prob=score_map.is_prob),
            core_only,
        )

    def crop_image(self, image: Image) -> Image:
        return self._crop(
            image,
            lambda: Image.from_shape(self.cropped_shape,
                                     num_channels=image.num_channels,
                                     value=self.pad_value),
            core_only=False,
        )
