"""Pipeline layer: the text-detection DAG + registry.

Capability parity: vkit/pipeline/__init__.py (17 registered steps under the
``text_detection`` namespace).

Counterpart of vkit_tpu/pipeline, whole: the step interface, the registry
of the 17 steps and the generation pool.  Step 15's batched region flatten
(``PageTextRegionStepConfig.device``) runs on a card unless the config asks
for the CPU.
"""
from .interface import (
    Pipeline,
    PipelinePostProcessor,
    PipelinePostProcessorFactory,
    PipelineRunRngStateOutput,
    PipelineState,
    PipelineStep,
    PipelineStepCollectionFactory,
    PipelineStepFactory,
)
from .pool import PipelinePool

from .text_detection.page_shape import (
    PageShapeStep,
    PageShapeStepConfig,
    PageShapeStepInput,
    PageShapeStepOutput,
    page_shape_step_factory,
)
from .text_detection.page_background import (
    PageBackgroundStep,
    PageBackgroundStepConfig,
    PageBackgroundStepInput,
    PageBackgroundStepOutput,
    page_background_step_factory,
)
from .text_detection.page_layout import (
    PageLayout,
    PageLayoutStep,
    PageLayoutStepConfig,
    PageLayoutStepInput,
    PageLayoutStepOutput,
    page_layout_step_factory,
)
from .text_detection.page_image import (
    PageImageCollection,
    PageImageStep,
    PageImageStepConfig,
    PageImageStepInput,
    PageImageStepOutput,
    page_image_step_factory,
)
from .text_detection.page_barcode import (
    PageBarcodeStep,
    PageBarcodeStepConfig,
    PageBarcodeStepInput,
    PageBarcodeStepOutput,
    page_barcode_step_factory,
)
from .text_detection.page_seal_impression import (
    PageSealImpresssionStep,
    PageSealImpresssionStepConfig,
    PageSealImpresssionStepInput,
    PageSealImpresssionStepOutput,
    page_seal_impresssion_step_factory,
)
from .text_detection.page_text_line import (
    PageTextLineCollection,
    PageTextLineStep,
    PageTextLineStepConfig,
    PageTextLineStepInput,
    PageTextLineStepOutput,
    page_text_line_step_factory,
)
from .text_detection.page_non_text_symbol import (
    PageNonTextSymbolStep,
    PageNonTextSymbolStepConfig,
    PageNonTextSymbolStepInput,
    PageNonTextSymbolStepOutput,
    page_non_text_symbol_step_factory,
)
from .text_detection.page_text_line_bounding_box import (
    PageTextLineBoundingBoxStep,
    PageTextLineBoundingBoxStepConfig,
    PageTextLineBoundingBoxStepInput,
    PageTextLineBoundingBoxStepOutput,
    page_text_line_bounding_box_step_factory,
)
from .text_detection.page_text_line_label import (
    PageCharPolygonCollection,
    PageTextLineLabelStep,
    PageTextLineLabelStepConfig,
    PageTextLineLabelStepInput,
    PageTextLineLabelStepOutput,
    PageTextLinePolygonCollection,
    page_text_line_label_step_factory,
)
from .text_detection.page_assembler import (
    Page,
    PageAssemblerStep,
    PageAssemblerStepConfig,
    PageAssemblerStepInput,
    PageAssemblerStepOutput,
    page_assembler_step_factory,
)
from .text_detection.page_distortion import (
    PageDistortionStep,
    PageDistortionStepConfig,
    PageDistortionStepInput,
    PageDistortionStepOutput,
    page_distortion_step_factory,
)
from .text_detection.page_resizing import (
    PageResizingStep,
    PageResizingStepConfig,
    PageResizingStepInput,
    PageResizingStepOutput,
    page_resizing_step_factory,
)
from .text_detection.page_cropping import (
    CroppedPage,
    PageCroppingStep,
    PageCroppingStepConfig,
    PageCroppingStepInput,
    PageCroppingStepOutput,
    page_cropping_step_factory,
)
from .text_detection.page_text_region import (
    PageTextRegionStep,
    PageTextRegionStepConfig,
    PageTextRegionStepInput,
    PageTextRegionStepOutput,
    page_text_region_step_factory,
)
from .text_detection.page_text_region_label import (
    PageCharRegressionLabel,
    PageCharRegressionLabelTag,
    PageTextRegionLabelStep,
    PageTextRegionLabelStepConfig,
    PageTextRegionLabelStepInput,
    PageTextRegionLabelStepOutput,
    page_text_region_label_step_factory,
)
from .text_detection.page_text_region_cropping import (
    CroppedPageTextRegion,
    PageTextRegionCroppingStep,
    PageTextRegionCroppingStepConfig,
    PageTextRegionCroppingStepInput,
    PageTextRegionCroppingStepOutput,
    page_text_region_cropping_step_factory,
)

pipeline_step_collection_factory = PipelineStepCollectionFactory()

pipeline_step_collection_factory.register_step_factories(
    'text_detection',
    [
        page_shape_step_factory,
        page_background_step_factory,
        page_layout_step_factory,
        page_image_step_factory,
        page_barcode_step_factory,
        page_seal_impresssion_step_factory,
        page_text_line_step_factory,
        page_non_text_symbol_step_factory,
        page_text_line_bounding_box_step_factory,
        page_text_line_label_step_factory,
        page_assembler_step_factory,
        page_distortion_step_factory,
        page_resizing_step_factory,
        page_cropping_step_factory,
        page_text_region_step_factory,
        page_text_region_label_step_factory,
        page_text_region_cropping_step_factory,
    ],
)
