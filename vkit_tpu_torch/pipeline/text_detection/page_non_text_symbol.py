"""Page non-text symbol step: decorative symbol images with layout-scaled
alpha, recolored when the source is grayscale ink.

Behavioral spec: vkit/pipeline/text_detection/page_non_text_symbol.py:28-190.
"""
from typing import List, Sequence, Tuple, Union

import attr
import numpy as np
from numpy.random import Generator as RandomGenerator

from ...element import Box, Image, ImageMode
from ...engine.image import image_selector_engine_executor_factory
from ...utility import normalize_to_keys_and_probs, rng_choice
from ..interface import PipelineStep, PipelineStepFactory
from .page_layout import PageLayoutStepOutput

# color key -> rgb gate (None = grayscale tone).
_COLOR_GATES = {
    'grayscale': None,
    'red': (1, 0, 0),
    'green': (0, 1, 0),
    'blue': (0, 0, 1),
}


@attr.define
class PageNonTextSymbolStepConfig:
    symbol_image_folders: Sequence[str]

    weight_color_grayscale: float = 0.9
    color_grayscale_min: int = 0
    color_grayscale_max: int = 75
    weight_color_red: float = 0.04
    weight_color_green: float = 0.02
    weight_color_blue: float = 0.04
    color_rgb_min: int = 128
    color_rgb_max: int = 255


@attr.define
class PageNonTextSymbolStepInput:
    page_layout_step_output: PageLayoutStepOutput


@attr.define
class PageNonTextSymbolStepOutput:
    images: Sequence[Image]
    boxes: Sequence[Box]
    alphas: Sequence[Union[np.ndarray, float]]


class PageNonTextSymbolStep(
    PipelineStep[PageNonTextSymbolStepConfig, PageNonTextSymbolStepInput, PageNonTextSymbolStepOutput]
):

    def __init__(self, config: PageNonTextSymbolStepConfig):
        super().__init__(config)
        self.symbol_source = image_selector_engine_executor_factory.create({
            'image_folders': config.symbol_image_folders,
            'target_image_mode': None,
            'force_resize': True,
        })
        self.color_keys, self.color_probs = normalize_to_keys_and_probs([
            ('grayscale', config.weight_color_grayscale),
            ('red', config.weight_color_red),
            ('green', config.weight_color_green),
            ('blue', config.weight_color_blue),
        ])

    def _sample_symbol_color(self, rng: RandomGenerator) -> Tuple[int, int, int]:
        key = rng_choice(rng, self.color_keys, probs=self.color_probs)
        gate = _COLOR_GATES[key]
        if gate is None:
            tone = int(rng.integers(self.config.color_grayscale_min,
                                    self.config.color_grayscale_max + 1))
            return (tone, tone, tone)
        value = int(rng.integers(self.config.color_rgb_min,
                                 self.config.color_rgb_max + 1))
        return tuple(value * g for g in gate)  # type: ignore[return-value]

    def _prepare_symbol(self, image: Image, layout_alpha: float,
                        rng: RandomGenerator):
        """Returns (rgb image, per-pixel or scalar alpha)."""
        if image.mode == ImageMode.RGBA:
            # Rescale the alpha channel so its peak carries layout_alpha.
            np_alpha = image.mat[:, :, 3].astype(np.float32) / 255
            peak = np_alpha.max()
            np_alpha *= layout_alpha
            if peak > 0:
                np_alpha /= peak
            return Image(mat=image.mat[:, :, :3]), np_alpha

        if image.mode == ImageMode.GRAYSCALE:
            # Ink coverage becomes the alpha; recolor the ink.
            np_alpha = (image.mat > 0).astype(np.float32) * layout_alpha
            recolored = Image.from_shapable(
                image, value=self._sample_symbol_color(rng)
            )
            return recolored, np_alpha

        raise NotImplementedError(f'unsupported symbol mode {image.mode}')

    def run(self, input: PageNonTextSymbolStepInput, rng: RandomGenerator):
        symbols = input.page_layout_step_output.page_layout.layout_non_text_symbols

        images: List[Image] = []
        boxes: List[Box] = []
        alphas: List[Union[np.ndarray, float]] = []
        for symbol in symbols:
            raw = self.symbol_source.run(
                {'height': symbol.box.height, 'width': symbol.box.width}, rng
            )
            image, alpha = self._prepare_symbol(raw, symbol.alpha, rng)
            images.append(image)
            boxes.append(symbol.box)
            alphas.append(alpha)

        return PageNonTextSymbolStepOutput(images=images, boxes=boxes, alphas=alphas)


page_non_text_symbol_step_factory = PipelineStepFactory(PageNonTextSymbolStep)
