"""First-party QR code encoder (ISO/IEC 18004), byte mode, ECC level L.

Replaces the cv2.QRCodeEncoder dependency of the reference
(vkit/engine/barcode/qr.py:79): pure numpy, versions 1-14 (payloads up to
~290 bytes), Reed-Solomon ECC over GF(256), all 8 data masks with spec
penalty scoring.  Output: uint8 (size, size) matrix, 1 = dark module.
"""
from typing import List, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# GF(256) arithmetic (poly 0x11D).
# ---------------------------------------------------------------------------

_EXP = np.zeros(512, dtype=np.int64)
_LOG = np.zeros(256, dtype=np.int64)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= 0x11D
for _i in range(255, 512):
    _EXP[_i] = _EXP[_i - 255]


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(_EXP[_LOG[a] + _LOG[b]])


def _gen_poly(n_ec: int) -> List[int]:
    # Built lowest-degree-first, returned highest-degree-first (the division
    # below peels the leading coefficient).
    poly = [1]
    for i in range(n_ec):
        nxt = [0] * (len(poly) + 1)
        for j, c in enumerate(poly):
            nxt[j] ^= _gf_mul(c, int(_EXP[i]))
            nxt[j + 1] ^= c
        poly = nxt
    return poly[::-1]


def _rs_ec_codewords(data: Sequence[int], n_ec: int) -> List[int]:
    gen = _gen_poly(n_ec)
    rem = list(data) + [0] * n_ec
    for i in range(len(data)):
        coef = rem[i]
        if coef:
            for j in range(1, len(gen)):
                rem[i + j] ^= _gf_mul(gen[j], coef)
    return rem[len(data):]


# ---------------------------------------------------------------------------
# Version tables, ECC level L.
# (total data codewords, ec codewords per block, group1 blocks, group1 block
#  size, group2 blocks, group2 block size)
# ---------------------------------------------------------------------------

_L_TABLE = {
    1: (19, 7, 1, 19, 0, 0),
    2: (34, 10, 1, 34, 0, 0),
    3: (55, 15, 1, 55, 0, 0),
    4: (80, 20, 1, 80, 0, 0),
    5: (108, 26, 1, 108, 0, 0),
    6: (136, 18, 2, 68, 0, 0),
    7: (156, 20, 2, 78, 0, 0),
    8: (194, 24, 2, 97, 0, 0),
    9: (232, 30, 2, 116, 0, 0),
    10: (274, 18, 2, 68, 2, 69),
    11: (324, 20, 4, 81, 0, 0),
    12: (370, 24, 2, 92, 2, 93),
    13: (428, 26, 4, 107, 0, 0),
    14: (461, 30, 3, 115, 1, 116),
}

_ALIGNMENT = {
    1: [], 2: [6, 18], 3: [6, 22], 4: [6, 26], 5: [6, 30], 6: [6, 34],
    7: [6, 22, 38], 8: [6, 24, 42], 9: [6, 26, 46], 10: [6, 28, 52],
    11: [6, 30, 54], 12: [6, 32, 58], 13: [6, 34, 62], 14: [6, 26, 46, 66],
}

_VERSION_INFO = {
    7: 0x07C94, 8: 0x085BC, 9: 0x09A99, 10: 0x0A4D3, 11: 0x0BBF6,
    12: 0x0C762, 13: 0x0D847, 14: 0x0E60D,
}

# Format info for ECC L, masks 0-7 (pre-computed BCH(15,5) ^ 0x5412).
_FORMAT_INFO_L = [
    0x77C4, 0x72F3, 0x7DAA, 0x789D, 0x662F, 0x6318, 0x6C41, 0x6976,
]


def _pick_version(n_bytes: int) -> int:
    for version, row in _L_TABLE.items():
        # Byte mode header: 4 mode bits + count bits (8 for v<10, 16 for
        # v>=10); capacity check in bits.
        count_bits = 8 if version <= 9 else 16
        capacity_bits = row[0] * 8
        if 4 + count_bits + 8 * n_bytes <= capacity_bits:
            return version
    raise ValueError(f'payload of {n_bytes} bytes exceeds v14-L capacity')


def _build_codewords(payload: bytes, version: int) -> List[int]:
    total_data, n_ec, g1_blocks, g1_size, g2_blocks, g2_size = _L_TABLE[version]
    count_bits = 8 if version <= 9 else 16

    bits: List[int] = []

    def put(value: int, n: int):
        for k in range(n - 1, -1, -1):
            bits.append((value >> k) & 1)

    put(0b0100, 4)                      # byte mode
    put(len(payload), count_bits)
    for b in payload:
        put(b, 8)
    # Terminator (up to 4 zero bits), pad to byte.
    put(0, min(4, total_data * 8 - len(bits)))
    while len(bits) % 8:
        bits.append(0)
    data = [
        int(''.join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8)
    ]
    # Pad codewords 0xEC / 0x11.
    pads = (0xEC, 0x11)
    idx = 0
    while len(data) < total_data:
        data.append(pads[idx % 2])
        idx += 1

    # Split into blocks, compute EC per block.
    blocks: List[List[int]] = []
    pos = 0
    for _ in range(g1_blocks):
        blocks.append(data[pos:pos + g1_size])
        pos += g1_size
    for _ in range(g2_blocks):
        blocks.append(data[pos:pos + g2_size])
        pos += g2_size
    ec_blocks = [_rs_ec_codewords(b, n_ec) for b in blocks]

    # Interleave.
    out: List[int] = []
    max_len = max(len(b) for b in blocks)
    for i in range(max_len):
        for b in blocks:
            if i < len(b):
                out.append(b[i])
    for i in range(n_ec):
        for e in ec_blocks:
            out.append(e[i])
    return out


def _function_patterns(version: int) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (matrix, reserved_mask) with finder/timing/alignment set."""
    size = 17 + 4 * version
    mat = np.zeros((size, size), dtype=np.uint8)
    reserved = np.zeros((size, size), dtype=bool)

    def put_finder(y, x):
        for dy in range(-1, 8):
            for dx in range(-1, 8):
                yy, xx = y + dy, x + dx
                if not (0 <= yy < size and 0 <= xx < size):
                    continue
                in_outer = 0 <= dy <= 6 and 0 <= dx <= 6
                on_ring = dy in (0, 6) or dx in (0, 6)
                in_core = 2 <= dy <= 4 and 2 <= dx <= 4
                mat[yy, xx] = 1 if (in_outer and (on_ring or in_core)) else 0
                reserved[yy, xx] = True

    put_finder(0, 0)
    put_finder(0, size - 7)
    put_finder(size - 7, 0)

    # Timing.
    for i in range(8, size - 8):
        v = 1 - (i % 2)
        for (y, x) in ((6, i), (i, 6)):
            mat[y, x] = v
            reserved[y, x] = True

    # Alignment patterns.
    centers = _ALIGNMENT[version]
    for cy in centers:
        for cx in centers:
            # Skip those overlapping finders.
            if (cy < 8 and cx < 8) or (cy < 8 and cx > size - 9) \
                    or (cy > size - 9 and cx < 8):
                continue
            for dy in range(-2, 3):
                for dx in range(-2, 3):
                    mat[cy + dy, cx + dx] = int(
                        max(abs(dy), abs(dx)) != 1
                    )
                    reserved[cy + dy, cx + dx] = True

    # Dark module.
    mat[size - 8, 8] = 1
    reserved[size - 8, 8] = True

    # Reserve format info areas.
    for i in range(9):
        reserved[8, i] = True
        reserved[i, 8] = True
    for i in range(8):
        reserved[8, size - 1 - i] = True
        reserved[size - 1 - i, 8] = True

    # Reserve version info areas (v >= 7).
    if version >= 7:
        reserved[0:6, size - 11:size - 8] = True
        reserved[size - 11:size - 8, 0:6] = True

    return mat, reserved


def _place_data(mat: np.ndarray, reserved: np.ndarray, codewords: Sequence[int]):
    size = mat.shape[0]
    bits = []
    for cw in codewords:
        for k in range(7, -1, -1):
            bits.append((cw >> k) & 1)
    # Remainder bits are zeros (already implied by the iterator ending).
    bit_iter = iter(bits)

    col = size - 1
    upward = True
    while col > 0:
        if col == 6:  # skip the vertical timing column
            col -= 1
        rows = range(size - 1, -1, -1) if upward else range(size)
        for row in rows:
            for c in (col, col - 1):
                if reserved[row, c]:
                    continue
                try:
                    mat[row, c] = next(bit_iter)
                except StopIteration:
                    mat[row, c] = 0
        upward = not upward
        col -= 2


_MASK_FNS = [
    lambda y, x: (y + x) % 2 == 0,
    lambda y, x: y % 2 == 0,
    lambda y, x: x % 3 == 0,
    lambda y, x: (y + x) % 3 == 0,
    lambda y, x: (y // 2 + x // 3) % 2 == 0,
    lambda y, x: (y * x) % 2 + (y * x) % 3 == 0,
    lambda y, x: ((y * x) % 2 + (y * x) % 3) % 2 == 0,
    lambda y, x: ((y + x) % 2 + (y * x) % 3) % 2 == 0,
]


def _runs_score(grid: np.ndarray) -> int:
    """Rule-1 score over every row, vectorized: for each maximal run of
    length r >= 5 add 3 + (r - 5)."""
    n, size = grid.shape
    # Run boundaries per row via padded change-points.
    change = np.ones((n, size + 1), dtype=bool)
    change[:, 1:size] = grid[:, 1:] != grid[:, :-1]
    rows, pos = np.nonzero(change)
    score = 0
    # Per row: diff of consecutive boundary positions = run lengths.
    row_breaks = np.flatnonzero(np.diff(rows, prepend=rows[0] - 1))
    split_pos = np.split(pos, row_breaks[1:])
    for p in split_pos:
        lens = np.diff(p)
        big = lens[lens >= 5]
        if len(big):
            score += int((3 + (big - 5)).sum())
    return score


def _penalty(mat: np.ndarray) -> int:
    size = mat.shape[0]
    score = 0
    # Rule 1: runs of >= 5 same-colored modules (rows + columns).
    score += _runs_score(mat)
    score += _runs_score(np.ascontiguousarray(mat.T))
    # Rule 2: 2x2 blocks.
    same = (
        (mat[:-1, :-1] == mat[:-1, 1:])
        & (mat[:-1, :-1] == mat[1:, :-1])
        & (mat[:-1, :-1] == mat[1:, 1:])
    )
    score += 3 * int(same.sum())
    # Rule 3: finder-like 1011101 with 4 light modules on either side —
    # sliding-window equality as a stacked comparison.
    pat1 = np.array([1, 0, 1, 1, 1, 0, 1, 0, 0, 0, 0], dtype=np.uint8)
    pat2 = pat1[::-1]
    for grid in (mat, np.ascontiguousarray(mat.T)):
        windows = np.lib.stride_tricks.sliding_window_view(grid, 11, axis=1)
        hits = (
            (windows == pat1).all(axis=-1) | (windows == pat2).all(axis=-1)
        )
        score += 40 * int(hits.sum())
    # Rule 4: dark-module proportion.
    dark_pct = mat.mean() * 100.0
    score += 10 * int(abs(dark_pct - 50) // 5)
    return score


def _apply_format_info(mat: np.ndarray, mask_idx: int):
    size = mat.shape[0]
    fmt = _FORMAT_INFO_L[mask_idx]
    bits = [(fmt >> (14 - i)) & 1 for i in range(15)]

    # Around the top-left finder.
    coords_a = [
        (8, 0), (8, 1), (8, 2), (8, 3), (8, 4), (8, 5), (8, 7), (8, 8),
        (7, 8), (5, 8), (4, 8), (3, 8), (2, 8), (1, 8), (0, 8),
    ]
    # Split between the other two finders.
    coords_b = [
        (size - 1, 8), (size - 2, 8), (size - 3, 8), (size - 4, 8),
        (size - 5, 8), (size - 6, 8), (size - 7, 8),
        (8, size - 8), (8, size - 7), (8, size - 6), (8, size - 5),
        (8, size - 4), (8, size - 3), (8, size - 2), (8, size - 1),
    ]
    for (y, x), bit in zip(coords_a, bits):
        mat[y, x] = bit
    for (y, x), bit in zip(coords_b, bits):
        mat[y, x] = bit


def _apply_version_info(mat: np.ndarray, version: int):
    if version < 7:
        return
    size = mat.shape[0]
    info = _VERSION_INFO[version]
    for i in range(18):
        bit = (info >> i) & 1
        mat[i // 3, size - 11 + i % 3] = bit
        mat[size - 11 + i % 3, i // 3] = bit


def encode_qr(payload: bytes) -> np.ndarray:
    """Encode bytes to a QR matrix (uint8, 1 = dark module), ECC level L."""
    if isinstance(payload, str):
        payload = payload.encode('utf-8')
    version = _pick_version(len(payload))
    codewords = _build_codewords(payload, version)

    base, reserved = _function_patterns(version)
    _place_data(base, reserved, codewords)

    size = base.shape[0]
    ys, xs = np.mgrid[0:size, 0:size]

    best = None
    best_score = None
    for mask_idx, fn in enumerate(_MASK_FNS):
        mask = fn(ys, xs) & ~reserved
        mat = base ^ mask.astype(np.uint8)
        _apply_format_info(mat, mask_idx)
        _apply_version_info(mat, version)
        score = _penalty(mat)
        if best_score is None or score < best_score:
            best = mat
            best_score = score
    return best
