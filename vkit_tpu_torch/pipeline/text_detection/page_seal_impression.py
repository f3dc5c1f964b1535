"""Page seal-impression step: one stamp per layout slot.

Behavioral spec: vkit/pipeline/text_detection/page_seal_impression.py:29-100
(the class name keeps the reference's triple-s spelling for registry parity).
"""
from typing import Any, Mapping, Sequence, Union

import attr
from numpy.random import Generator as RandomGenerator

from ...element import Box
from ...engine.seal_impression import (
    SealImpression,
    seal_impression_engine_executor_aggregator_factory,
)
from ...utility import PathType
from ..interface import PipelineStep, PipelineStepFactory
from .page_layout import PageLayoutStepOutput


@attr.define
class PageSealImpresssionStepConfig:
    seal_impression_configs: Union[Sequence[Mapping[str, Any]], PathType]


@attr.define
class PageSealImpresssionStepInput:
    page_layout_step_output: PageLayoutStepOutput


@attr.define
class PageSealImpresssionStepOutput:
    seal_impressions: Sequence[SealImpression]
    boxes: Sequence[Box]
    angles: Sequence[int]


class PageSealImpresssionStep(
    PipelineStep[PageSealImpresssionStepConfig, PageSealImpresssionStepInput, PageSealImpresssionStepOutput]
):

    def __init__(self, config: PageSealImpresssionStepConfig):
        super().__init__(config)
        self.seal_source = seal_impression_engine_executor_aggregator_factory.create(
            config.seal_impression_configs
        )

    def run(self, input: PageSealImpresssionStepInput, rng: RandomGenerator):
        slots = input.page_layout_step_output.page_layout.layout_seal_impressions
        return PageSealImpresssionStepOutput(
            seal_impressions=[
                self.seal_source.run(
                    {'height': slot.box.height, 'width': slot.box.width}, rng
                ) for slot in slots
            ],
            boxes=[slot.box for slot in slots],
            angles=[slot.angle for slot in slots],
        )


page_seal_impresssion_step_factory = PipelineStepFactory(PageSealImpresssionStep)
