"""QR barcode engine.

Behavioral spec: vkit/engine/barcode/qr.py:33-97 (re-derived).  The symbol
comes from the first-party ISO/IEC 18004 encoder (qr_encode.py, byte mode,
ECC L) rather than cv2.QRCodeEncoder; cv2 appears only in tests as the
decode oracle.
"""
import string
from typing import Optional

import attr
from numpy.random import Generator as RandomGenerator

from ...element import Mask, ScoreMap
from ...utility import rng_choice_with_size
from ..interface import Engine, EngineExecutorFactory, NoneTypeEngineInitResource
from .qr_encode import encode_qr
from .type import BarcodeEngineRunConfig

# Matches the capacity ceiling the reference imposes via cv2's encoder.
PAYLOAD_LENGTH_CEILING = 150
_ALPHABET = tuple(string.ascii_letters)


@attr.define
class BarcodeQrEngineInitConfig:
    payload_text_length_min: int = 1
    payload_text_length_max: int = PAYLOAD_LENGTH_CEILING
    alpha_min: float = 0.7
    alpha_max: float = 1.0


def _random_payload(length_min: int, length_max: int, rng: RandomGenerator) -> str:
    length = int(rng.integers(length_min, length_max + 1))
    return ''.join(rng_choice_with_size(rng, _ALPHABET, size=length))


class BarcodeQrEngine(
    Engine[BarcodeQrEngineInitConfig, NoneTypeEngineInitResource, BarcodeEngineRunConfig, ScoreMap]
):

    @classmethod
    def get_type_name(cls) -> str:
        return 'qr'

    def __init__(self, init_config, init_resource=None):
        super().__init__(init_config, init_resource)
        assert init_config.payload_text_length_max <= PAYLOAD_LENGTH_CEILING

    def run(self, run_config: BarcodeEngineRunConfig,
            rng: Optional[RandomGenerator] = None) -> ScoreMap:
        assert rng is not None
        cfg = self.init_config
        payload = _random_payload(
            cfg.payload_text_length_min, cfg.payload_text_length_max, rng
        )

        # Dark modules become alpha-weighted activations.
        modules = Mask(mat=encode_qr(payload))
        assert modules.height == modules.width
        score_map = ScoreMap.from_shapable(modules)
        score_map[modules] = float(rng.uniform(cfg.alpha_min, cfg.alpha_max))

        target = (run_config.height, run_config.width)
        if score_map.shape != target:
            score_map = score_map.to_resized_score_map(*target)
        return score_map


barcode_qr_engine_executor_factory = EngineExecutorFactory(BarcodeQrEngine)
