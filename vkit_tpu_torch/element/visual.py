"""Image element: uint8 / float32 raster with colorspace-aware modes.

Behavioral spec: vkit/element/image.py:33-898 (re-derived).  Colorspace
conversions use the first-party FULL-range math in ops/colorspace_np; the
resize family uses the cv2-exact tap-matrix kernels in ops/resize_taps.
"""
import os
from enum import Enum, unique
from typing import Iterable, Optional, Tuple, Union

import numpy as np
from PIL import Image as PilImage
from PIL import ImageOps as PilImageOps

from ..ops import colorspace_np as csp
from ..ops.resize_taps import Interpolation, resize_np
from ..utility.type import PathType
from .blend import ElementSetOperationMode, all_equal_values, scaled_shape
from .geom import Box
from .raster import Raster, lift, mask_from_elements, paint, paint_many

UNION = ElementSetOperationMode.UNION

# Mode traits: (ndim, dtype, channels, gcn_partner).  A single table replaces
# the reference's five parallel lookup sets.
_TRAITS = {
    'rgb': (3, np.uint8, 3, 'rgb_gcn'),
    'rgba': (3, np.uint8, 4, None),
    'hsv': (3, np.uint8, 3, 'hsv_gcn'),
    'hsl': (3, np.uint8, 3, 'hsl_gcn'),
    'grayscale': (2, np.uint8, None, 'grayscale_gcn'),
    'rgb_gcn': (3, np.float32, 3, 'rgb'),
    'hsv_gcn': (3, np.float32, 3, 'hsv'),
    'hsl_gcn': (3, np.float32, 3, 'hsl'),
    'grayscale_gcn': (2, np.float32, None, 'grayscale'),
    'none': (None, None, None, None),
}


@unique
class ImageMode(Enum):
    RGB = 'rgb'
    RGB_GCN = 'rgb_gcn'
    RGBA = 'rgba'
    HSV = 'hsv'
    HSV_GCN = 'hsv_gcn'
    HSL = 'hsl'
    HSL_GCN = 'hsl_gcn'
    GRAYSCALE = 'grayscale'
    GRAYSCALE_GCN = 'grayscale_gcn'
    NONE = 'none'

    def to_ndim(self) -> int:
        ndim = _TRAITS[self.value][0]
        if ndim is None:
            raise NotImplementedError()
        return ndim

    def to_dtype(self):
        dtype = _TRAITS[self.value][1]
        if dtype is None:
            raise NotImplementedError()
        return dtype

    def to_num_channels(self) -> Optional[int]:
        if self is ImageMode.NONE:
            raise NotImplementedError()
        return _TRAITS[self.value][2]

    def supports_gcn_mode(self) -> bool:
        return not self.in_gcn_mode() and _TRAITS[self.value][3] is not None

    def to_gcn_mode(self) -> 'ImageMode':
        if not self.supports_gcn_mode():
            raise RuntimeError(f'{self} has no GCN variant')
        return ImageMode(_TRAITS[self.value][3])

    def in_gcn_mode(self) -> bool:
        return self.value.endswith('_gcn')

    def to_non_gcn_mode(self) -> 'ImageMode':
        if not self.in_gcn_mode():
            raise RuntimeError(f'{self} is not a GCN mode')
        return ImageMode(_TRAITS[self.value][3])


_TO_RGB = {
    ImageMode.GRAYSCALE: csp.gray_to_rgb,
    ImageMode.RGBA: csp.rgba_to_rgb,
    ImageMode.HSV: csp.hsv_full_to_rgb,
    ImageMode.HSL: csp.hsl_full_to_rgb,
}
_FROM_RGB = {
    ImageMode.GRAYSCALE: csp.rgb_to_gray,
    ImageMode.RGBA: csp.rgb_to_rgba,
    ImageMode.HSV: csp.rgb_to_hsv_full,
    ImageMode.HSL: csp.rgb_to_hsl_full,
}


def _infer_mode(mat: np.ndarray) -> ImageMode:
    if mat.dtype != np.uint8:
        raise NotImplementedError(f'cannot infer mode for dtype {mat.dtype}')
    if mat.ndim == 2:
        return ImageMode.GRAYSCALE
    if mat.ndim == 3:
        channels = mat.shape[2]
        if channels == 3:
            return ImageMode.RGB
        if channels == 4:
            return ImageMode.RGBA
        raise NotImplementedError(f'cannot infer mode for {channels} channels')
    raise NotImplementedError(f'cannot infer mode for ndim {mat.ndim}')


class ImageSetItemConfig:

    def __init__(self, value, alpha=1.0):
        self.value = value
        self.alpha = alpha


class Image(Raster):

    __slots__ = ('mode',)

    def __init__(self, mat: np.ndarray, mode: ImageMode = ImageMode.NONE,
                 box: Optional[Box] = None):
        if mode is ImageMode.NONE:
            mode = _infer_mode(mat)
        else:
            assert mode.to_dtype() == mat.dtype and mode.to_ndim() == mat.ndim
        object.__setattr__(self, 'mode', mode)
        super().__init__(mat, box)

    def _check_mat(self, mat: np.ndarray) -> None:
        pass  # mode-specific checks run in __init__.

    def _fields(self) -> dict:
        return {'mat': self.mat, 'mode': self.mode, 'box': self.box}

    @classmethod
    def from_shape(cls, shape: Tuple[int, int], num_channels: int = 3,
                   value: Union[Tuple[int, ...], int] = 255) -> 'Image':
        h, w = shape
        if num_channels == 0:
            mat = np.full((h, w), value, np.uint8)
        else:
            assert num_channels > 0
            if isinstance(value, tuple):
                assert len(value) == num_channels
            mat = np.full((h, w, num_channels), value, np.uint8)
        return cls(mat=mat)

    @classmethod
    def from_shapable(cls, shapable, num_channels: int = 3,
                      value: Union[Tuple[int, ...], int] = 255) -> 'Image':
        return cls.from_shape(shapable.shape, num_channels, value)

    @property
    def num_channels(self) -> int:
        return 0 if self.mat.ndim == 2 else self.mat.shape[2]

    # PIL / file I/O.

    @classmethod
    def from_pil_image(cls, pil_image: PilImage.Image) -> 'Image':
        return cls(mat=np.array(pil_image, dtype=np.uint8))

    def to_pil_image(self) -> PilImage.Image:
        return PilImage.fromarray(self.mat)

    @classmethod
    def from_file(cls, path: PathType, disable_exif_orientation: bool = False
                  ) -> 'Image':
        path = os.path.expanduser(os.path.expandvars(os.fspath(path)))
        pil_image = PilImage.open(path)
        pil_image.load()
        if not disable_exif_orientation and pil_image.getexif().get(0x0112):
            pil_image = PilImageOps.exif_transpose(pil_image)
        return cls.from_pil_image(pil_image)

    def to_file(self, path: PathType, disable_to_rgb_image: bool = False) -> None:
        image = self if disable_to_rgb_image else self.to_rgb_image()
        path = os.path.expanduser(os.path.expandvars(os.fspath(path)))
        image.to_pil_image().save(path)

    # Multi-element fills (value, alpha) tuples.

    @staticmethod
    def _as_triples(element_value_tuples):
        out = []
        for entry in element_value_tuples:
            if len(entry) == 2:
                out.append((entry[0], entry[1], 1.0))
            else:
                out.append(tuple(entry))
        return out

    def fill_by_box_value_tuples(self, box_value_tuples, mode=UNION,
                                 skip_values_uniqueness_check=False):
        paint_many(self, self._as_triples(box_value_tuples), mode,
                   assume_unique=skip_values_uniqueness_check)

    fill_by_polygon_value_tuples = fill_by_box_value_tuples
    fill_by_mask_value_tuples = fill_by_box_value_tuples

    def fill_by_boxes(self, boxes, value, alpha=1.0, mode=UNION):
        paint_many(self, [(b, value, alpha) for b in boxes], mode,
                   assume_unique=True)

    fill_by_polygons = fill_by_boxes
    fill_by_masks = fill_by_boxes

    def fill_by_score_map_value_tuples(self, score_map_value_tuples, mode=UNION,
                                       skip_values_uniqueness_check=False):
        # A score map is simultaneously the footprint and the alpha.
        entries = [(sm, value, sm) for sm, value, *_ in (
            (e[0], e[1]) for e in score_map_value_tuples
        )]
        if mode is UNION:
            for sm, value, _ in entries:
                paint(self, sm, value, weight=sm)
            return
        combined = mask_from_elements(self.shape, [e[0] for e in entries], mode)
        unique = skip_values_uniqueness_check or all_equal_values(
            [e[1] for e in entries]
        )
        if unique:
            paint(self, combined, entries[0][1], weight=entries[0][2])
            return
        for sm, value, _ in entries:
            box = sm.equivalent_box
            gated = box.extract_np_array(combined.mat).copy()
            gated[~(sm.mat > 0.0)] = 0
            from .raster import Mask
            paint(self, Mask(mat=gated, box=box), value, weight=sm)

    def fill_by_score_maps(self, score_maps, value, mode=UNION):
        self.fill_by_score_map_value_tuples(
            [(sm, value) for sm in score_maps], mode,
            skip_values_uniqueness_check=True,
        )

    def __setitem__(self, element, config):
        if isinstance(config, ImageSetItemConfig):
            value, alpha = config.value, config.alpha
        else:
            value, alpha = config, 1.0
        from .raster import ScoreMap
        if isinstance(element, ScoreMap):
            paint(self, element, value, weight=element)
        else:
            paint(self, element, value, weight=alpha)

    def __getitem__(self, element) -> 'Image':
        return lift(element, self)

    # Conversions.

    def to_gcn_image(self, lamb: float = 0, eps: float = 1e-8,
                     scale: float = 1.0) -> 'Image':
        """Global contrast normalization."""
        mode = self.mode.to_gcn_mode()
        mat = self.mat.astype(np.float32)
        mat -= np.mean(mat)
        std = np.sqrt(lamb + np.mean(mat * mat))
        mat /= max(eps, std)
        if scale != 1.0:
            mat *= scale
        return Image(mat=mat, mode=mode)

    def to_non_gcn_image(self) -> 'Image':
        mode = self.mode.to_non_gcn_mode()
        assert self.mat.dtype == np.float32
        mat = self.mat - self.mat.min()
        mat = mat / max(float(mat.max()), 1e-8) * 255.0
        return Image(mat=np.clip(np.round(mat), 0, 255).astype(np.uint8), mode=mode)

    def to_target_mode_image(self, target_mode: ImageMode) -> 'Image':
        if target_mode == self.mode:
            return self
        image = self
        fresh = False
        if image.mode.in_gcn_mode():
            image = image.to_non_gcn_image()
            fresh = True
        if image.mode == target_mode:
            return image if fresh else image.copy()
        mat = image.mat
        if image.mode != ImageMode.RGB:
            mat = _TO_RGB[image.mode](mat)
        if target_mode != ImageMode.RGB:
            mat = _FROM_RGB[target_mode](mat)
        return Image(mat=mat, mode=target_mode)

    def to_grayscale_image(self) -> 'Image':
        return self.to_target_mode_image(ImageMode.GRAYSCALE)

    def to_rgb_image(self) -> 'Image':
        return self.to_target_mode_image(ImageMode.RGB)

    def to_rgba_image(self) -> 'Image':
        return self.to_target_mode_image(ImageMode.RGBA)

    def to_hsv_image(self) -> 'Image':
        return self.to_target_mode_image(ImageMode.HSV)

    def to_hsl_image(self) -> 'Image':
        return self.to_target_mode_image(ImageMode.HSL)

    def to_shifted_image(self, offset_y: int = 0, offset_x: int = 0) -> 'Image':
        assert self.box is not None
        return self.replace(box=self.box.to_shifted_box(offset_y, offset_x))

    def to_resized_image(self, resized_height=None, resized_width=None,
                         interpolation: Interpolation = Interpolation.CUBIC
                         ) -> 'Image':
        rh, rw = scaled_shape(self.height, self.width, resized_height, resized_width)
        return self.replace(mat=resize_np(self.mat, (rh, rw), interpolation))

    def to_conducted_resized_image(self, shapable_or_shape,
                                   resized_height=None, resized_width=None,
                                   interpolation: Interpolation = Interpolation.CUBIC
                                   ) -> 'Image':
        assert self.box is not None
        resized_box = self.box.to_conducted_resized_box(
            shapable_or_shape, resized_height, resized_width
        )
        return self.to_box_detached().to_resized_image(
            resized_box.height, resized_box.width, interpolation
        ).to_box_attached(resized_box)

    def to_cropped_image(self, up=None, down=None, left=None, right=None
                         ) -> 'Image':
        assert self.box is None
        crop = Box(up or 0, down or self.height - 1, left or 0, right or self.width - 1)
        return self.replace(mat=crop.extract_np_array(self.mat))
