"""Page shape step: fixed page area, coin-flip aspect ratio.

Behavioral spec: vkit/pipeline/text_detection/page_shape.py:25-60.
"""
import math
from typing import Sequence

import attr
from numpy.random import Generator as RandomGenerator

from ...utility import rng_choice
from ..interface import PipelineStep, PipelineStepFactory


@attr.define
class PageShapeStepConfig:
    aspect_ratios: Sequence[float] = attr.field(factory=lambda: (1 / 1.4142, 1.4142))
    # Keeps the minimum font size >= 18 px.
    area: int = 2522**2


@attr.define
class PageShapeStepInput:
    pass


@attr.define
class PageShapeStepOutput:
    height: int
    width: int


class PageShapeStep(
    PipelineStep[PageShapeStepConfig, PageShapeStepInput, PageShapeStepOutput]
):

    def run(self, input: PageShapeStepInput, rng: RandomGenerator):
        # area = h * w, aspect = w / h  =>  h = sqrt(area / aspect).
        aspect = rng_choice(rng, self.config.aspect_ratios)
        height = round(math.sqrt(self.config.area / aspect))
        width = round(aspect * height)
        assert min(height, width) > 0
        return PageShapeStepOutput(height=height, width=width)


page_shape_step_factory = PipelineStepFactory(PageShapeStep)
