"""Code39 barcode engine with a first-party symbology renderer.

Capability parity: vkit/engine/barcode/code39.py:33-158 (which wraps
python-barcode; here the Code 39 element table is rendered directly to a bar
mask — each symbol is 9 elements, 3 wide, separated by a narrow gap).
"""
import string
from typing import Optional

import attr
import numpy as np
from numpy.random import Generator as RandomGenerator

from ...element import Mask, ScoreMap
from ...utility import rng_choice_with_size
from ..interface import Engine, EngineExecutorFactory, NoneTypeEngineInitResource
from .type import BarcodeEngineRunConfig

# Code 39 element patterns: 1 = wide, 0 = narrow; alternating bar/space
# starting with a bar. Public-domain symbology table.
_CODE39_PATTERNS = {
    '0': '000110100', '1': '100100001', '2': '001100001', '3': '101100000',
    '4': '000110001', '5': '100110000', '6': '001110000', '7': '000100101',
    '8': '100100100', '9': '001100100',
    'A': '100001001', 'B': '001001001', 'C': '101001000', 'D': '000011001',
    'E': '100011000', 'F': '001011000', 'G': '000001101', 'H': '100001100',
    'I': '001001100', 'J': '000011100',
    'K': '100000011', 'L': '001000011', 'M': '101000010', 'N': '000010011',
    'O': '100010010', 'P': '001010010', 'Q': '000000111', 'R': '100000110',
    'S': '001000110', 'T': '000010110',
    'U': '110000001', 'V': '011000001', 'W': '111000000', 'X': '010010001',
    'Y': '110010000', 'Z': '011010000',
    '-': '010000101', '.': '110000100', ' ': '011000100', '$': '010101000',
    '/': '010100010', '+': '010001010', '%': '000101010', '*': '010010100',
}


def render_code39_row(text: str, wide_ratio: int = 3) -> np.ndarray:
    """One row of the barcode as uint8 {0, 1}: 1 = bar."""
    symbols = f'*{text.upper()}*'
    row = []
    for idx, char in enumerate(symbols):
        pattern = _CODE39_PATTERNS[char]
        for element_idx, flag in enumerate(pattern):
            length = wide_ratio if flag == '1' else 1
            is_bar = element_idx % 2 == 0
            row.extend([1 if is_bar else 0] * length)
        if idx < len(symbols) - 1:
            row.append(0)  # inter-character narrow gap
    return np.asarray(row, dtype=np.uint8)


@attr.define
class BarcodeCode39EngineInitConfig:
    aspect_ratio: float = 0.2854396602149411
    alpha_min: float = 0.7
    alpha_max: float = 1.0


class BarcodeCode39Engine(
    Engine[BarcodeCode39EngineInitConfig, NoneTypeEngineInitResource, BarcodeEngineRunConfig, ScoreMap]
):

    @classmethod
    def get_type_name(cls) -> str:
        return 'code39'

    def __init__(self, init_config, init_resource=None):
        super().__init__(init_config, init_resource)
        self.ascii_uppercase = tuple(string.ascii_uppercase)

    def run(self, run_config: BarcodeEngineRunConfig,
            rng: Optional[RandomGenerator] = None) -> ScoreMap:
        assert rng is not None

        num_chars = max(
            1,
            round(
                run_config.width / (run_config.height * self.init_config.aspect_ratio)
            ),
        )
        text = ''.join(rng_choice_with_size(rng, self.ascii_uppercase, size=num_chars))

        row = render_code39_row(text)
        # Bars span the full height.
        bar_height = max(2, row.shape[0] // 10)
        mat = np.repeat(row[None, :], bar_height, axis=0)
        mask = Mask(mat=mat)

        score_map = ScoreMap.from_shapable(mask)
        score_map[mask] = float(
            rng.uniform(self.init_config.alpha_min, self.init_config.alpha_max)
        )
        if score_map.shape != (run_config.height, run_config.width):
            score_map = score_map.to_resized_score_map(
                resized_height=run_config.height,
                resized_width=run_config.width,
            )
        return score_map


barcode_code39_engine_executor_factory = EngineExecutorFactory(BarcodeCode39Engine)
