"""Image engine run config. Capability parity: vkit/engine/image/type.py."""
import attr


@attr.define
class ImageEngineRunConfig:
    height: int
    width: int
    disable_resizing: bool = False
