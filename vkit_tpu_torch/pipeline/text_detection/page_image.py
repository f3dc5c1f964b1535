"""Page image step: photos for the layout's image boxes + the bottom-layer
image that later fills distortion-opened inactive regions.

Behavioral spec: vkit/pipeline/text_detection/page_image.py:25-118.
"""
from typing import Any, Mapping, Sequence, Union

import attr
from numpy.random import Generator as RandomGenerator

from ...element import Box, Image
from ...engine.image import image_engine_executor_aggregator_factory
from ...mechanism.distortion import rotate
from ...utility import PathType, rng_choice
from ..interface import PipelineStep, PipelineStepFactory
from .page_layout import PageLayoutStepOutput


@attr.define
class PageImageStepConfig:
    image_configs: Union[Sequence[Mapping[str, Any]], PathType]
    alpha_min: float = 0.25
    alpha_max: float = 1.0


@attr.define
class PageImageStepInput:
    page_layout_step_output: PageLayoutStepOutput


@attr.define
class PageImage:
    image: Image
    box: Box
    alpha: float


@attr.define
class PageImageCollection:
    height: int
    width: int
    page_images: Sequence[PageImage]


@attr.define
class PageImageStepOutput:
    page_image_collection: PageImageCollection
    # Fills inactive regions opened up by geometric distortion.
    page_bottom_layer_image: Image


class PageImageStep(
    PipelineStep[PageImageStepConfig, PageImageStepInput, PageImageStepOutput]
):

    def __init__(self, config: PageImageStepConfig):
        super().__init__(config)
        self.image_source = image_engine_executor_aggregator_factory.create(
            config.image_configs
        )

    def _photo_for(self, box: Box, rng: RandomGenerator) -> PageImage:
        return PageImage(
            image=self.image_source.run(
                {'height': box.height, 'width': box.width}, rng
            ),
            box=box,
            alpha=float(rng.uniform(self.config.alpha_min, self.config.alpha_max)),
        )

    def run(self, input: PageImageStepInput, rng: RandomGenerator):
        layout = input.page_layout_step_output.page_layout

        collection = PageImageCollection(
            height=layout.height,
            width=layout.width,
            page_images=[
                self._photo_for(entry.box, rng) for entry in layout.layout_images
            ],
        )

        # Bottom layer: an un-resized photo at a random quarter rotation.
        bottom = self.image_source.run(
            {'height': 0, 'width': 0, 'disable_resizing': True}, rng
        )
        bottom = rotate.distort_image(
            {'angle': rng_choice(rng, (0, 90, 180, 270))}, bottom
        )
        return PageImageStepOutput(
            page_image_collection=collection,
            page_bottom_layer_image=bottom,
        )


page_image_step_factory = PipelineStepFactory(PageImageStep)
