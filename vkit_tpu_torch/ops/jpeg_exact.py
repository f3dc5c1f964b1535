"""Bit-exact libjpeg (IJG) roundtrip, on the host and on the device.

The numpy half (the integer-exact per-image ``jpeg_roundtrip_exact`` and
its stages) is the reference's own code (vkit_tpu/ops/jpeg_exact.py); the
per-element ``jpeg_quality`` runs it.

``jpeg_roundtrip_exact_torch`` ports ``jpeg_roundtrip_exact_jnp``, batched
over a leading sample axis with one pair of quant tables per sample:
libjpeg's fixed-point RGB<->YCbCr conversion, the biased h2v2 chroma
downsample, the islow integer FDCT/IDCT, round-half-away quantization and
the triangular "fancy" chroma upsample.  The DCT passes are the
reference's backend-generic ``_fdct_islow_xp`` / ``_idct_islow_xp``, run
here on torch int32 tensors.  Every shift is arithmetic on int32 in both
frameworks, and the one division divides non-negative values, so libjpeg's
rounding of negative values carries over unchanged.
"""
import types

import numpy as np
import torch

# CONST_BITS = 13 fixed-point constants: round(x * 8192).
_F_0_298631336 = 2446
_F_0_390180644 = 3196
_F_0_541196100 = 4433
_F_0_765366865 = 6270
_F_0_899976223 = 7373
_F_1_175875602 = 9633
_F_1_501321110 = 12299
_F_1_847759065 = 15137
_F_1_961570560 = 16069
_F_2_053119869 = 16819
_F_2_562915447 = 20995
_F_3_072711026 = 25172

_CONST_BITS = 13
_PASS1_BITS = 2


def _fdct_islow_xp(blocks, xp):
    """jfdctint.c forward DCT on (N, 8, 8) int blocks (level-shifted).
    Functional form shared by the numpy (int64) and jnp (int32) backends;
    the operation ORDER mirrors the C code, whose intermediates are
    proven to fit 32 bits."""
    b = blocks

    def pass_core(d, axis_last, shift):
        # d indexed as rows of 8 along the chosen axis via helper lambdas.
        if axis_last:
            el = lambda i: d[:, :, i]
        else:
            el = lambda i: d[:, i, :]
        tmp0 = el(0) + el(7)
        tmp7 = el(0) - el(7)
        tmp1 = el(1) + el(6)
        tmp6 = el(1) - el(6)
        tmp2 = el(2) + el(5)
        tmp5 = el(2) - el(5)
        tmp3 = el(3) + el(4)
        tmp4 = el(3) - el(4)

        tmp10 = tmp0 + tmp3
        tmp13 = tmp0 - tmp3
        tmp11 = tmp1 + tmp2
        tmp12 = tmp1 - tmp2

        if shift is None:    # pass 1: << PASS1_BITS
            o0 = (tmp10 + tmp11) << _PASS1_BITS
            o4 = (tmp10 - tmp11) << _PASS1_BITS
            desc = _CONST_BITS - _PASS1_BITS
        else:                # pass 2: DESCALE(.., PASS1_BITS)
            half = 1 << (_PASS1_BITS - 1)
            o0 = (tmp10 + tmp11 + half) >> _PASS1_BITS
            o4 = (tmp10 - tmp11 + half) >> _PASS1_BITS
            desc = _CONST_BITS + _PASS1_BITS

        dhalf = 1 << (desc - 1)
        z1 = (tmp12 + tmp13) * _F_0_541196100
        o2 = (z1 + tmp13 * _F_0_765366865 + dhalf) >> desc
        o6 = (z1 - tmp12 * _F_1_847759065 + dhalf) >> desc

        z1 = tmp4 + tmp7
        z2 = tmp5 + tmp6
        z3 = tmp4 + tmp6
        z4 = tmp5 + tmp7
        z5 = (z3 + z4) * _F_1_175875602

        t4 = tmp4 * _F_0_298631336
        t5 = tmp5 * _F_2_053119869
        t6 = tmp6 * _F_3_072711026
        t7 = tmp7 * _F_1_501321110
        z1 = -z1 * _F_0_899976223
        z2 = -z2 * _F_2_562915447
        z3 = -z3 * _F_1_961570560 + z5
        z4 = -z4 * _F_0_390180644 + z5

        o7 = (t4 + z1 + z3 + dhalf) >> desc
        o5 = (t5 + z2 + z4 + dhalf) >> desc
        o3 = (t6 + z2 + z3 + dhalf) >> desc
        o1 = (t7 + z1 + z4 + dhalf) >> desc
        outs = [o0, o1, o2, o3, o4, o5, o6, o7]
        return xp.stack(outs, axis=2 if axis_last else 1)

    rows_done = pass_core(b, axis_last=True, shift=None)
    return pass_core(rows_done, axis_last=False, shift='p2')


def fdct_islow(blocks):
    return _fdct_islow_xp(blocks.astype(np.int64), np)


def _idct_islow_xp(coeffs, xp):
    """jidctint.c inverse DCT on (N, 8, 8) dequantized coefficients;
    returns spatial values centered at 0 (add 128 + clamp)."""
    c = coeffs

    def pass_core(d, axis_last, final):
        if axis_last:
            el = lambda i: d[:, :, i]
        else:
            el = lambda i: d[:, i, :]
        z2 = el(2)
        z3 = el(6)
        z1 = (z2 + z3) * _F_0_541196100
        tmp2 = z1 + z3 * (-_F_1_847759065)
        tmp3 = z1 + z2 * _F_0_765366865

        z2 = el(0)
        z3 = el(4)
        tmp0 = (z2 + z3) << _CONST_BITS
        tmp1 = (z2 - z3) << _CONST_BITS

        tmp10 = tmp0 + tmp3
        tmp13 = tmp0 - tmp3
        tmp11 = tmp1 + tmp2
        tmp12 = tmp1 - tmp2

        t0 = el(7)
        t1 = el(5)
        t2 = el(3)
        t3 = el(1)
        z1 = t0 + t3
        z2 = t1 + t2
        z3 = t0 + t2
        z4 = t1 + t3
        z5 = (z3 + z4) * _F_1_175875602

        t0 = t0 * _F_0_298631336
        t1 = t1 * _F_2_053119869
        t2 = t2 * _F_3_072711026
        t3 = t3 * _F_1_501321110
        z1 = -z1 * _F_0_899976223
        z2 = -z2 * _F_2_562915447
        z3 = -z3 * _F_1_961570560 + z5
        z4 = -z4 * _F_0_390180644 + z5

        t0 = t0 + z1 + z3
        t1 = t1 + z2 + z4
        t2 = t2 + z2 + z3
        t3 = t3 + z1 + z4

        shift = (
            _CONST_BITS + _PASS1_BITS + 3 if final
            else _CONST_BITS - _PASS1_BITS
        )
        half = 1 << (shift - 1)
        o0 = (tmp10 + t3 + half) >> shift
        o7 = (tmp10 - t3 + half) >> shift
        o1 = (tmp11 + t2 + half) >> shift
        o6 = (tmp11 - t2 + half) >> shift
        o2 = (tmp12 + t1 + half) >> shift
        o5 = (tmp12 - t1 + half) >> shift
        o3 = (tmp13 + t0 + half) >> shift
        o4 = (tmp13 - t0 + half) >> shift
        outs = [o0, o1, o2, o3, o4, o5, o6, o7]
        return xp.stack(outs, axis=1 if not axis_last else 2)

    cols_done = pass_core(c, axis_last=False, final=False)
    return pass_core(cols_done, axis_last=True, final=True)


def idct_islow(coeffs):
    return _idct_islow_xp(coeffs.astype(np.int64), np)


# ---------------------------------------------------------------------------
# Color conversion (jccolor.c / jdcolor.c fixed point, SCALEBITS = 16).
# ---------------------------------------------------------------------------

_SCALEBITS = 16
_ONE_HALF = 1 << (_SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


def rgb_to_ycc(r, g, b):
    """jccolor.c rgb_ycc_convert (integer-exact, vectorized)."""
    r = r.astype(np.int64)
    g = g.astype(np.int64)
    b = b.astype(np.int64)
    cbcr_offset = 128 << _SCALEBITS
    y = (
        _fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + _ONE_HALF
    ) >> _SCALEBITS
    cb = (
        -_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.50000) * b
        + cbcr_offset + _ONE_HALF - 1
    ) >> _SCALEBITS
    cr = (
        _fix(0.50000) * r - _fix(0.41869) * g - _fix(0.08131) * b
        + cbcr_offset + _ONE_HALF - 1
    ) >> _SCALEBITS
    return y, cb, cr


def ycc_to_rgb(y, cb, cr):
    """jdcolor.c ycc_rgb_convert (integer-exact, vectorized)."""
    y = y.astype(np.int64)
    cb = cb.astype(np.int64) - 128
    cr = cr.astype(np.int64) - 128
    r = y + ((_fix(1.40200) * cr + _ONE_HALF) >> _SCALEBITS)
    b = y + ((_fix(1.77200) * cb + _ONE_HALF) >> _SCALEBITS)
    g = y + (
        (-_fix(0.34414) * cb - _fix(0.71414) * cr + _ONE_HALF) >> _SCALEBITS
    )
    clamp = lambda v: np.clip(v, 0, 255)  # noqa: E731 - range_limit table
    return clamp(r), clamp(g), clamp(b)


# ---------------------------------------------------------------------------
# Chroma sampling (jcsample.c h2v2_downsample / jdsample.c
# h2v2_fancy_upsample).
# ---------------------------------------------------------------------------


def h2v2_downsample(c):
    """2x2 average with libjpeg's alternating +1/+2 bias per output col."""
    h, w = c.shape
    v = c.astype(np.int64).reshape(h // 2, 2, w // 2, 2).sum(axis=(1, 3))
    bias = np.where((np.arange(w // 2) % 2) == 0, 1, 2)[None, :]
    return (v + bias) >> 2


def h2v1_fancy_rows(sub):
    """Horizontal triangular upsample of each row (jdsample.c inner loop).

    out[2i]   = (3*s[i] + s[i-1] + 1) >> 2
    out[2i+1] = (3*s[i] + s[i+1] + 2) >> 2
    with edge columns copied."""
    h, w = sub.shape
    s = sub.astype(np.int64)
    left = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
    right = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
    even = (s * 3 + left + 1) >> 2
    odd = (s * 3 + right + 2) >> 2
    out = np.empty((h, w * 2), dtype=np.int64)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    # Edge special cases: out[0] = s[0], out[-1] = s[-1] exactly?  The C
    # code computes out[0] from (3*s0 + s0...) via the same formula with
    # the duplicated neighbour — which the padding above already does.
    return out


def h2v2_fancy_upsample(sub):
    """jdsample.c h2v2_fancy_upsample: vertical 3:1 blend of neighbouring
    input rows, then the horizontal triangular pass."""
    h, w = sub.shape
    s = sub.astype(np.int64)
    up = np.concatenate([s[:1], s[:-1]], axis=0)
    down = np.concatenate([s[1:], s[-1:]], axis=0)
    # For output row 2i (nearer row i, farther row i-1) and 2i+1.
    near_scaled = s * 3
    row_even = near_scaled + up      # input-space blend at 1/4 resolution
    row_odd = near_scaled + down
    rows = np.empty((h * 2, w), dtype=np.int64)
    rows[0::2] = row_even
    rows[1::2] = row_odd
    # Horizontal pass on the (x4-scaled) rows: thiscolsum notation of the
    # C code; out = (3*this + prev/next + 8) >> 4.
    left = np.concatenate([rows[:, :1], rows[:, :-1]], axis=1)
    right = np.concatenate([rows[:, 1:], rows[:, -1:]], axis=1)
    even = (rows * 3 + left + 8) >> 4
    odd = (rows * 3 + right + 7) >> 4
    out = np.empty((h * 2, w * 2), dtype=np.int64)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    # Leftmost/rightmost columns: (this * 4 + 8) >> 4 per the C code.
    out[:, 0] = (rows[:, 0] * 4 + 8) >> 4
    out[:, -1] = (rows[:, -1] * 4 + 7) >> 4
    return out


# ---------------------------------------------------------------------------
# Quantization (jcdctmgr.c quantize: round half away from zero).
# ---------------------------------------------------------------------------


def quantize(coeffs, qtable):
    q = qtable.astype(np.int64)[None, :, :]
    c = coeffs.astype(np.int64)
    mag = (np.abs(c) + (q >> 1)) // q
    return np.where(c < 0, -mag, mag)


def _blockify(channel):
    h, w = channel.shape
    return (
        channel.reshape(h // 8, 8, w // 8, 8)
        .transpose(0, 2, 1, 3)
        .reshape(-1, 8, 8)
    )


def _unblockify(blocks, h, w):
    return (
        blocks.reshape(h // 8, w // 8, 8, 8)
        .transpose(0, 2, 1, 3)
        .reshape(h, w)
    )


def _roundtrip_channel(channel, qtable):
    """Encode+decode one component plane (H, W multiple of 8).

    The encoder's islow divisors are the quant values PRE-SCALED by 8
    (jcdctmgr.c: qval << 3 — fdct_islow emits x8-scaled coefficients);
    the decoder dequantizes by the RAW values, with the /8 folded into
    jidctint's final descale."""
    h, w = channel.shape
    blocks = _blockify(channel.astype(np.int64) - 128)
    coeffs = fdct_islow(blocks)
    quant = quantize(coeffs, qtable << 3)
    dequant = quant * qtable.astype(np.int64)[None, :, :]
    spatial = idct_islow(dequant) + 128
    return _unblockify(np.clip(spatial, 0, 255), h, w)


def _pad_edge(x, mult):
    h, w = x.shape
    ph, pw = (-h) % mult, (-w) % mult
    if ph or pw:
        x = np.pad(x, ((0, ph), (0, pw)), mode='edge')
    return x


def jpeg_roundtrip_exact(image: np.ndarray, quality: int) -> np.ndarray:
    """Bit-exact libjpeg encode/decode simulation.

    ``image``: uint8 (H, W) grayscale or (H, W, 3) RGB.  Matches
    cv2.imencode('.jpg', x, [IMWRITE_JPEG_QUALITY, q]) + imdecode
    (baseline, 4:2:0 for color / single plane for grayscale).
    """
    from .effect import _CHROMA_QTABLE, _LUMA_QTABLE, _quality_scaled_table

    luma_q = _quality_scaled_table(_LUMA_QTABLE, quality).astype(np.int64)
    if image.ndim == 2:
        h, w = image.shape
        pad = _pad_edge(image, 8)
        out = _roundtrip_channel(pad, luma_q)
        return out[:h, :w].astype(np.uint8)

    chroma_q = _quality_scaled_table(_CHROMA_QTABLE, quality).astype(np.int64)
    h, w = image.shape[:2]
    # Edge expansion is ASYMMETRIC in libjpeg (empirically pinned against
    # cv2): COLUMNS expand at the source level before downsampling
    # (jcsample.c expand_right_edge), while bottom ROWS pad at the
    # subsampled plane's own block boundary.
    r = _pad_edge(image[..., 0], 2)
    g = _pad_edge(image[..., 1], 2)
    b = _pad_edge(image[..., 2], 2)
    y, cb, cr = rgb_to_ycc(r, g, b)

    def chroma_rt(c):
        pw = (-c.shape[1]) % 16
        if pw:
            c = np.pad(c, ((0, 0), (0, pw)), mode='edge')
        sub = h2v2_downsample(c)
        ph = (-sub.shape[0]) % 8
        if ph:
            sub = np.pad(sub, ((0, ph), (0, 0)), mode='edge')
        return _roundtrip_channel(sub, chroma_q)

    y_rt = _roundtrip_channel(_pad_edge(y, 8), luma_q)
    # The DECODER's fancy upsampler walks only the REAL downsampled
    # extent (its edge special-cases land at ceil(w/2)-1, not at the
    # coded block boundary) — crop the decoded planes before upsampling.
    ch, cw = -(-h // 2), -(-w // 2)
    cb_rt = chroma_rt(cb)[:ch, :cw]
    cr_rt = chroma_rt(cr)[:ch, :cw]

    cb_up = h2v2_fancy_upsample(cb_rt)
    cr_up = h2v2_fancy_upsample(cr_rt)

    r2, g2, b2 = ycc_to_rgb(
        y_rt[:h, :w], cb_up[:h, :w], cr_up[:h, :w]
    )
    out = np.stack([r2, g2, b2], axis=-1)
    return out.astype(np.uint8)


# ---------------------------------------------------------------------------
# Device (torch int32) twin for the batched path.
# ---------------------------------------------------------------------------

# The array namespace the reference's DCT passes call (``xp.stack``).
_XP = types.SimpleNamespace(
    stack=lambda arrays, axis: torch.stack(arrays, dim=axis)
)


def _edge_pad(x, pad_h: int, pad_w: int):
    """Edge-replicate pad of dims 1 and 2 of (N, H, W, ...) at the bottom
    and the right."""
    if pad_h:
        rows = torch.arange(x.shape[1] + pad_h, device=x.device)
        x = x.index_select(1, rows.clamp(max=x.shape[1] - 1))
    if pad_w:
        cols = torch.arange(x.shape[2] + pad_w, device=x.device)
        x = x.index_select(2, cols.clamp(max=x.shape[2] - 1))
    return x


def _pad_to(c, mult_h: int, mult_w: int):
    return _edge_pad(c, (-c.shape[1]) % mult_h, (-c.shape[2]) % mult_w)


def _down(c):
    """h2v2 downsample: 2x2 sums with libjpeg's alternating 1 / 2 bias."""
    n, hh, ww = c.shape
    v = c.reshape(n, hh // 2, 2, ww // 2, 2).sum(dim=(2, 4),
                                                 dtype=torch.int32)
    bias = torch.where(torch.arange(ww // 2, device=c.device) % 2 == 0, 1, 2)
    return (v + bias.to(torch.int32)) >> 2


def _roundtrip(c, q):
    """Encode + decode planes (N, hh, ww), multiples of 8, with per-sample
    tables ``q`` (N, 8, 8) int32."""
    n, hh, ww = c.shape
    nb = (hh // 8) * (ww // 8)
    blocks = (c - 128).reshape(n, hh // 8, 8, ww // 8, 8).permute(
        0, 1, 3, 2, 4).reshape(n * nb, 8, 8)
    coeffs = _fdct_islow_xp(blocks, _XP)
    q = q[:, None].expand(n, nb, 8, 8).reshape(n * nb, 8, 8)
    qdiv = q << 3
    mag = (torch.abs(coeffs) + (qdiv >> 1)) // qdiv
    quant = torch.where(coeffs < 0, -mag, mag)
    spatial = _idct_islow_xp(quant * q, _XP) + 128
    spatial = torch.clamp(spatial, 0, 255)
    return spatial.reshape(n, hh // 8, ww // 8, 8, 8).permute(
        0, 1, 3, 2, 4).reshape(n, hh, ww)


def _fancy_up(sub):
    """jdsample.c h2v2_fancy_upsample of (N, sh, sw) planes."""
    n, sh, sw = sub.shape
    up = torch.cat([sub[:, :1], sub[:, :-1]], dim=1)
    dn = torch.cat([sub[:, 1:], sub[:, -1:]], dim=1)
    near = sub * 3
    rows = torch.stack([near + up, near + dn], dim=2).reshape(n, sh * 2, sw)
    left = torch.cat([rows[:, :, :1], rows[:, :, :-1]], dim=2)
    right = torch.cat([rows[:, :, 1:], rows[:, :, -1:]], dim=2)
    even = (rows * 3 + left + 8) >> 4
    odd = (rows * 3 + right + 7) >> 4
    out = torch.stack([even, odd], dim=3).reshape(n, sh * 2, sw * 2)
    out[:, :, 0] = (rows[:, :, 0] * 4 + 8) >> 4
    out[:, :, -1] = (rows[:, :, -1] * 4 + 7) >> 4
    return out


def jpeg_roundtrip_exact_torch(images, luma_q, chroma_q):
    """Bit-exact libjpeg roundtrip of (N, H, W, 3) uint8 RGB images with
    per-sample (N, 8, 8) int32 quant tables; returns (N, H, W, 3) uint8.

    Pads mirror the reference's asymmetric edge expansion: columns expand
    at the source level before downsampling, bottom rows pad at the
    subsampled plane's block boundary, and the decoder's fancy upsampler
    walks only the real downsampled extent."""
    n, h, w = images.shape[:3]
    luma_q = luma_q.to(device=images.device, dtype=torch.int32)
    chroma_q = chroma_q.to(device=images.device, dtype=torch.int32)
    rgb = _edge_pad(images.to(torch.int32), h % 2, w % 2)
    r, g, b = rgb.unbind(-1)

    cbcr_offset = 128 << _SCALEBITS
    y = (
        _fix(0.29900) * r + _fix(0.58700) * g + _fix(0.11400) * b + _ONE_HALF
    ) >> _SCALEBITS
    cb = (
        -_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.50000) * b
        + cbcr_offset + _ONE_HALF - 1
    ) >> _SCALEBITS
    cr = (
        _fix(0.50000) * r - _fix(0.41869) * g - _fix(0.08131) * b
        + cbcr_offset + _ONE_HALF - 1
    ) >> _SCALEBITS

    y_rt = _roundtrip(_pad_to(y, 8, 8), luma_q)[:, :h, :w]
    ch, cw = -(-h // 2), -(-w // 2)

    def chroma(c):
        sub = _roundtrip(_pad_to(_down(_pad_to(c, 1, 16)), 8, 1), chroma_q)
        return _fancy_up(sub[:, :ch, :cw])[:, :h, :w] - 128

    cbd = chroma(cb)
    crd = chroma(cr)
    r2 = y_rt + ((_fix(1.40200) * crd + _ONE_HALF) >> _SCALEBITS)
    b2 = y_rt + ((_fix(1.77200) * cbd + _ONE_HALF) >> _SCALEBITS)
    g2 = y_rt + (
        (-_fix(0.34414) * cbd - _fix(0.71414) * crd + _ONE_HALF)
        >> _SCALEBITS
    )
    out = torch.stack([r2, g2, b2], dim=-1)
    return torch.clamp(out, 0, 255).to(torch.uint8)
