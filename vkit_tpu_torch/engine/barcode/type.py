"""Barcode engine run config. Capability parity: vkit/engine/barcode/type.py."""
import attr


@attr.define
class BarcodeEngineRunConfig:
    height: int
    width: int
