"""Page barcode step: QR + code39 activations for the layout's barcode boxes.

Behavioral spec: vkit/pipeline/text_detection/page_barcode.py:29-117.
"""
from typing import Any, Mapping, Optional, Sequence

import attr
from numpy.random import Generator as RandomGenerator

from ...element import ScoreMap
from ...engine.barcode import (
    barcode_code39_engine_executor_factory,
    barcode_qr_engine_executor_factory,
)
from ..interface import PipelineStep, PipelineStepFactory
from .page_layout import PageLayoutStepOutput


@attr.define
class PageBarcodeStepConfig:
    barcode_qr_config: Optional[Mapping[str, Any]] = None
    barcode_code39_config: Optional[Mapping[str, Any]] = None


@attr.define
class PageBarcodeStepInput:
    page_layout_step_output: PageLayoutStepOutput


@attr.define
class PageBarcodeStepOutput:
    height: int
    width: int
    barcode_qr_score_maps: Sequence[ScoreMap]
    barcode_code39_score_maps: Sequence[ScoreMap]


class PageBarcodeStep(
    PipelineStep[PageBarcodeStepConfig, PageBarcodeStepInput, PageBarcodeStepOutput]
):

    def __init__(self, config: PageBarcodeStepConfig):
        super().__init__(config)
        self.qr_engine = barcode_qr_engine_executor_factory.create(
            config.barcode_qr_config
        )
        self.code39_engine = barcode_code39_engine_executor_factory.create(
            config.barcode_code39_config
        )

    @staticmethod
    def _render(engine, boxes, rng) -> Sequence[ScoreMap]:
        return [
            engine.run({'height': box.height, 'width': box.width}, rng=rng)
            .to_box_attached(box)
            for box in boxes
        ]

    def run(self, input: PageBarcodeStepInput, rng: RandomGenerator):
        layout = input.page_layout_step_output.page_layout

        qr_boxes = [entry.box for entry in layout.layout_barcode_qrs]
        assert all(box.height == box.width for box in qr_boxes)
        code39_boxes = [entry.box for entry in layout.layout_barcode_code39s]

        return PageBarcodeStepOutput(
            height=layout.height,
            width=layout.width,
            barcode_qr_score_maps=self._render(self.qr_engine, qr_boxes, rng),
            barcode_code39_score_maps=self._render(
                self.code39_engine, code39_boxes, rng
            ),
        )


page_barcode_step_factory = PipelineStepFactory(PageBarcodeStep)
