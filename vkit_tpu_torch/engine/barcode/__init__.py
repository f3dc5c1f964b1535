from .code39 import (
    BarcodeCode39Engine,
    BarcodeCode39EngineInitConfig,
    barcode_code39_engine_executor_factory,
)
from .qr import (
    BarcodeQrEngine,
    BarcodeQrEngineInitConfig,
    barcode_qr_engine_executor_factory,
)
from .type import BarcodeEngineRunConfig
