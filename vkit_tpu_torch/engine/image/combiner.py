"""Image combiner engine: a photo mosaic packed along a column skyline,
with gaussian seam smoothing.

Behavioral spec: vkit/engine/image/combiner.py:35-347 (re-derived; the
prioritized-segment bookkeeping is factored into a Skyline helper).
"""
import bisect
import heapq
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import attr
import numpy as np
from numpy.random import Generator as RandomGenerator

from ...element import Image, ImageMode
from ...mechanism.distortion import rotate
from ...ops import blur as blur_ops
from ...utility import read_json_file, rng_choice
from ..interface import Engine, EngineExecutorFactory, NoneTypeEngineInitResource
from .type import ImageEngineRunConfig


@attr.define(frozen=True)
class ImageMeta:
    image_file: str
    grayscale_mean: float
    grayscale_std: float


def load_image_metas_from_folder(folder: str) -> List[ImageMeta]:
    """Folder layout: <folder>/image/* + <folder>/metas.json."""
    root = Path(os.path.expandvars(folder))
    image_fd = root / 'image'
    metas_json = root / 'metas.json'
    assert image_fd.exists() and metas_json.exists()

    metas: List[ImageMeta] = []
    for entry in read_json_file(metas_json):
        image_file = image_fd / entry['image_file']
        assert image_file.exists()
        metas.append(ImageMeta(
            image_file=str(image_file),
            grayscale_mean=entry['grayscale_mean'],
            grayscale_std=entry['grayscale_std'],
        ))
    return metas


@attr.define
class ImageCombinerEngineInitConfig:
    image_meta_folder: str
    target_image_mode: ImageMode = ImageMode.RGB
    enable_cache: bool = False
    prob_use_only_the_anchor_image: float = 0.7
    prob_rotate_image: float = 0.5
    sigma: float = 3.0
    init_segment_width_min_ratio: float = 0.25
    gaussian_blur_kernel_size: int = 5


class _Skyline:
    """Column spans ordered by fill height; lowest span fills next.

    Popping also merges horizontally adjacent spans at the same height, so
    a wide photo can cover what several narrow tiles left behind.
    """

    def __init__(self):
        self._heap: List[Tuple[int, int, int]] = []  # (y, left, right)

    def __bool__(self):
        return bool(self._heap)

    def push(self, y: int, left: int, right: int) -> None:
        heapq.heappush(self._heap, (y, left, right))

    def pop_merged(self) -> Tuple[int, int, int]:
        y, left, right = heapq.heappop(self._heap)
        peers = []
        while self._heap and self._heap[0][0] == y:
            peers.append(heapq.heappop(self._heap))
        if peers:
            # Grow across directly adjacent peers; push back the rest.
            spans = sorted(peers + [(y, left, right)], key=lambda s: s[1])
            idx = spans.index((y, left, right))
            lo = idx
            while lo > 0 and spans[lo - 1][2] + 1 == spans[lo][1]:
                lo -= 1
            hi = idx
            while hi + 1 < len(spans) and spans[hi][2] + 1 == spans[hi + 1][1]:
                hi += 1
            left = spans[lo][1]
            right = spans[hi][2]
            for span in spans[:lo] + spans[hi + 1:]:
                heapq.heappush(self._heap, span)
        return y, left, right


def _band_edges(np_edge: np.ndarray, box: Tuple[int, int, int, int],
                reach: int) -> None:
    """Mark a band of width `reach` around each side of a pasted tile."""
    height, width = np_edge.shape
    up, down, left, right = box
    for y in (up, down):
        np_edge[max(0, y - reach):min(height - 1, y + reach) + 1, left:right + 1] = 1
    for x in (left, right):
        np_edge[up:down + 1, max(0, x - reach):min(width - 1, x + reach) + 1] = 1


class ImageCombinerEngine(
    Engine[ImageCombinerEngineInitConfig, NoneTypeEngineInitResource, ImageEngineRunConfig, Image]
):

    @classmethod
    def get_type_name(cls) -> str:
        return 'combiner'

    def __init__(self, init_config, init_resource=None):
        super().__init__(init_config, init_resource)
        self.image_metas = sorted(
            load_image_metas_from_folder(init_config.image_meta_folder),
            key=lambda meta: meta.grayscale_mean,
        )
        self._means = [meta.grayscale_mean for meta in self.image_metas]
        self._cache: Dict[str, Image] = {}

    def pick_tonally_close_metas(self, rng: RandomGenerator) -> Sequence[ImageMeta]:
        """All photos within sigma of a random anchor's grayscale mean."""
        anchor = rng_choice(rng, self.image_metas)
        if rng.random() < self.init_config.prob_use_only_the_anchor_image:
            return [anchor]
        sigma = self.init_config.sigma
        lo = round(anchor.grayscale_mean - sigma * anchor.grayscale_std)
        hi = round(anchor.grayscale_mean + sigma * anchor.grayscale_std)
        picked = self.image_metas[
            bisect.bisect_left(self._means, lo):bisect.bisect_right(self._means, hi)
        ]
        assert picked
        return picked

    def _tile_for(self, meta: ImageMeta, rotate_flags: Dict[str, bool],
                  rng: RandomGenerator) -> Image:
        if self.init_config.enable_cache and meta.image_file in self._cache:
            return self._cache[meta.image_file]
        tile = Image.from_file(meta.image_file).to_target_mode_image(
            self.init_config.target_image_mode
        )
        if meta.image_file not in rotate_flags:
            rotate_flags[meta.image_file] = (
                rng.random() < self.init_config.prob_rotate_image
            )
        if rotate_flags[meta.image_file]:
            tile = rotate.distort_image({'angle': 90}, tile)
        if self.init_config.enable_cache:
            self._cache[meta.image_file] = tile
        return tile

    def _initial_skyline(self, width: int, rng: RandomGenerator) -> _Skyline:
        skyline = _Skyline()
        min_width = int(np.clip(
            round(self.init_config.init_segment_width_min_ratio * width),
            1, width - 1,
        ))
        left = 0
        while left + min_width - 1 < width:
            right = int(rng.integers(left + min_width - 1, width))
            if right + 1 - left < min_width or width - right - 1 < min_width:
                break
            skyline.push(0, left, right)
            left = right + 1
        if left < width:
            skyline.push(0, left, width - 1)
        return skyline

    def synthesize_image(self, run_config: ImageEngineRunConfig,
                         image_metas: Sequence[ImageMeta],
                         rng: RandomGenerator) -> Image:
        height, width = run_config.height, run_config.width
        canvas = np.zeros((height, width, 3), dtype=np.uint8)
        np_edge = np.zeros((height, width), dtype=np.uint8)
        reach = self.init_config.gaussian_blur_kernel_size // 2 + 1

        skyline = self._initial_skyline(width, rng)
        rotate_flags: Dict[str, bool] = {}

        while skyline:
            y, left, right = skyline.pop_merged()
            tile = self._tile_for(rng_choice(rng, image_metas), rotate_flags, rng)

            down = min(height - 1, y + tile.height - 1)
            tile_right = min(right, left + tile.width - 1)
            canvas[y:down + 1, left:tile_right + 1] = \
                tile.mat[:down + 1 - y, :tile_right + 1 - left]
            _band_edges(np_edge, (y, down, left, tile_right), reach)

            if tile_right == right:
                if down + 1 < height:
                    skyline.push(down + 1, left, right)
            else:
                # The tile covered only part of the span: split it.
                if down + 1 < height:
                    skyline.push(down + 1, left, tile_right)
                skyline.push(y, tile_right + 1, right)

        # Blur the seams only.
        sigma = reach / 3
        blurred = blur_ops.gaussian_blur_np(
            canvas, sigma, self.init_config.gaussian_blur_kernel_size
        )
        seam = np_edge.astype(bool)
        canvas[seam] = blurred[seam]
        return Image(mat=canvas)

    def run(self, run_config: ImageEngineRunConfig,
            rng: Optional[RandomGenerator] = None) -> Image:
        assert rng is not None
        assert not run_config.disable_resizing
        return self.synthesize_image(
            run_config, self.pick_tonally_close_metas(rng), rng
        )


image_combiner_engine_executor_factory = EngineExecutorFactory(ImageCombinerEngine)
