"""Image selector engine: a random file from configured folders, delivered
by random sub-crop when large enough, else by resize.

Behavioral spec: vkit/engine/image/selector.py:31-105 (re-derived).
"""
import os
from pathlib import Path
from typing import List, Optional

import attr
from numpy.random import Generator as RandomGenerator

from ...element import Box, Image, ImageMode
from ...utility import rng_choice
from ..interface import Engine, EngineExecutorFactory, NoneTypeEngineInitResource
from .type import ImageEngineRunConfig

_EXTENSIONS = ('jpg', 'jpeg', 'png')

# Decoded-file + deterministic-resize caches: a prepared page batch
# re-selects from the same small folders hundreds of times, and Image
# mats are frozen read-only, so sharing one decode/resize per key is
# safe.  Bounded FIFO so unboundedly large production folders can't
# pin host memory.
_CACHE_LIMIT = 256
_decode_cache: dict = {}
_resize_cache: dict = {}


def _cache_put(cache: dict, key, value):
    if len(cache) >= _CACHE_LIMIT:
        cache.pop(next(iter(cache)))
    cache[key] = value


def index_image_files(folders) -> List[Path]:
    """Sorted recursive listing of supported image files."""
    found: List[Path] = []
    for folder in folders:
        root = Path(os.path.expandvars(os.fspath(folder)))
        assert root.exists()
        found.extend(
            path for path in root.rglob('*')
            if path.suffix.lower().lstrip('.') in _EXTENSIONS
        )
    return sorted(found)


@attr.define
class ImageSelectorEngineInitConfig:
    image_folders: List[str]
    target_image_mode: Optional[ImageMode] = ImageMode.RGB
    force_resize: bool = False


class ImageSelectorEngine(
    Engine[ImageSelectorEngineInitConfig, NoneTypeEngineInitResource, ImageEngineRunConfig, Image]
):

    @classmethod
    def get_type_name(cls) -> str:
        return 'selector'

    def __init__(self, init_config, init_resource=None):
        super().__init__(init_config, init_resource)
        self.image_files = index_image_files(init_config.image_folders)

    def run(self, run_config: ImageEngineRunConfig,
            rng: Optional[RandomGenerator] = None) -> Image:
        assert rng is not None
        path = rng_choice(rng, self.image_files)
        decode_key = (path, self.init_config.target_image_mode)
        image = _decode_cache.get(decode_key)
        if image is None:
            image = Image.from_file(path)
            if self.init_config.target_image_mode:
                image = image.to_target_mode_image(
                    self.init_config.target_image_mode
                )
            _cache_put(_decode_cache, decode_key, image)

        if run_config.disable_resizing:
            assert run_config.height == 0 and run_config.width == 0
            return image

        h, w = run_config.height, run_config.width
        fits = h <= image.height and w <= image.width
        if fits and not self.init_config.force_resize:
            up = int(rng.integers(0, image.height - h + 1))
            left = int(rng.integers(0, image.width - w + 1))
            return Box(up, up + h - 1, left, left + w - 1).extract_image(image)
        resize_key = (decode_key, h, w)
        resized = _resize_cache.get(resize_key)
        if resized is None:
            resized = image.to_resized_image(resized_height=h, resized_width=w)
            _cache_put(_resize_cache, resize_key, resized)
        return resized


image_selector_engine_executor_factory = EngineExecutorFactory(ImageSelectorEngine)
