"""Page background step: a photo background or a flat random grayscale.

Behavioral spec: vkit/pipeline/text_detection/page_background.py:32-110.
"""
from typing import Any, Mapping, Sequence, Union

import attr
from numpy.random import Generator as RandomGenerator

from ...element import Image
from ...engine.image import image_engine_executor_aggregator_factory
from ...utility import PathType, normalize_to_probs
from ..interface import PipelineStep, PipelineStepFactory
from .page_shape import PageShapeStepOutput


@attr.define
class PageBackgroundStepConfig:
    image_configs: Union[Sequence[Mapping[str, Any]], PathType]
    weight_image: float = 0.8
    weight_random_grayscale: float = 0.2
    grayscale_min: int = 127
    grayscale_max: int = 255


@attr.define
class PageBackgroundStepInput:
    page_shape_step_output: PageShapeStepOutput


@attr.define
class PageBackgroundStepOutput:
    background_image: Image


class PageBackgroundStep(
    PipelineStep[PageBackgroundStepConfig, PageBackgroundStepInput, PageBackgroundStepOutput]
):

    def __init__(self, config: PageBackgroundStepConfig):
        super().__init__(config)
        self.image_source = image_engine_executor_aggregator_factory.create(
            config.image_configs
        )
        self.prob_image = normalize_to_probs(
            [config.weight_image, config.weight_random_grayscale]
        )[0]

    def run(self, input: PageBackgroundStepInput, rng: RandomGenerator):
        shape_out = input.page_shape_step_output
        height, width = shape_out.height, shape_out.width

        if rng.random() < self.prob_image:
            background = self.image_source.run(
                {'height': height, 'width': width}, rng
            )
        else:
            tone = int(rng.integers(self.config.grayscale_min,
                                    self.config.grayscale_max + 1))
            background = Image.from_shape((height, width), num_channels=3, value=tone)
        return PageBackgroundStepOutput(background_image=background)


page_background_step_factory = PipelineStepFactory(PageBackgroundStep)
