"""First-party uint8 colorspace conversions (numpy host path).

Capability parity: the cv2.cvtColor graph at vkit/element/image.py:183-212,
771-829 — RGB / RGBA / GRAYSCALE / HSV(FULL) / HSL(FULL).  "FULL" means hue
spans the whole uint8 range (H * 255 / 360), matching COLOR_RGB2HSV_FULL /
COLOR_RGB2HLS_FULL.  The jnp device twins live in vkit_tpu/ops/color.py.
"""
import numpy as np


def rgb_to_gray(mat: np.ndarray) -> np.ndarray:
    """BT.601 luma with cv2's fixed-point coefficients (bit-exact)."""
    r = mat[..., 0].astype(np.uint32)
    g = mat[..., 1].astype(np.uint32)
    b = mat[..., 2].astype(np.uint32)
    return ((r * 4899 + g * 9617 + b * 1868 + (1 << 13)) >> 14).astype(np.uint8)


def gray_to_rgb(mat: np.ndarray) -> np.ndarray:
    return np.repeat(mat[..., None], 3, axis=-1)


def rgb_to_rgba(mat: np.ndarray) -> np.ndarray:
    alpha = np.full(mat.shape[:2] + (1,), 255, dtype=np.uint8)
    return np.concatenate([mat, alpha], axis=-1)


def rgba_to_rgb(mat: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(mat[..., :3])


def rgb_to_hsv_full(mat: np.ndarray) -> np.ndarray:
    rgb = mat.astype(np.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.max(rgb, axis=-1)
    mn = np.min(rgb, axis=-1)
    diff = v - mn

    with np.errstate(divide='ignore', invalid='ignore'):
        s = np.where(v > 0, diff / np.where(v == 0, 1.0, v) * 255.0, 0.0)
        safe = np.where(diff == 0, 1.0, diff)
        h = np.where(
            v == r,
            60.0 * (g - b) / safe,
            np.where(v == g, 120.0 + 60.0 * (b - r) / safe, 240.0 + 60.0 * (r - g) / safe),
        )
    h = np.where(diff == 0, 0.0, h)
    h = np.where(h < 0, h + 360.0, h)
    h_full = h * (255.0 / 360.0)
    out = np.stack([h_full, s, v], axis=-1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def hsv_full_to_rgb(mat: np.ndarray) -> np.ndarray:
    h = mat[..., 0].astype(np.float32) * (360.0 / 255.0)
    s = mat[..., 1].astype(np.float32) / 255.0
    v = mat[..., 2].astype(np.float32)

    c = v * s
    hp = h / 60.0
    x = c * (1.0 - np.abs(np.mod(hp, 2.0) - 1.0))
    m = v - c

    sector = np.floor(hp).astype(np.int32) % 6
    z = np.zeros_like(c)
    r1 = np.choose(sector, [c, x, z, z, x, c])
    g1 = np.choose(sector, [x, c, c, x, z, z])
    b1 = np.choose(sector, [z, z, x, c, c, x])

    out = np.stack([r1 + m, g1 + m, b1 + m], axis=-1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def rgb_to_hsl_full(mat: np.ndarray) -> np.ndarray:
    """Returns channel order (H, S, L), i.e. cv2 HLS post-sliced to HSL as the
    reference does (vkit/element/image.py:183-212)."""
    rgb = mat.astype(np.float32) / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = np.max(rgb, axis=-1)
    mn = np.min(rgb, axis=-1)
    diff = mx - mn
    summ = mx + mn
    lum = summ / 2.0

    with np.errstate(divide='ignore', invalid='ignore'):
        denom = np.where(lum < 0.5, summ, 2.0 - summ)
        s = np.where(diff == 0, 0.0, diff / np.where(denom == 0, 1.0, denom))
        safe = np.where(diff == 0, 1.0, diff)
        h = np.where(
            mx == r,
            60.0 * (g - b) / safe,
            np.where(mx == g, 120.0 + 60.0 * (b - r) / safe, 240.0 + 60.0 * (r - g) / safe),
        )
    h = np.where(diff == 0, 0.0, h)
    h = np.where(h < 0, h + 360.0, h)

    out = np.stack([h * (255.0 / 360.0), s * 255.0, lum * 255.0], axis=-1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def hsl_full_to_rgb(mat: np.ndarray) -> np.ndarray:
    """Input channel order (H, S, L)."""
    h = mat[..., 0].astype(np.float32) * (360.0 / 255.0)
    s = mat[..., 1].astype(np.float32) / 255.0
    lum = mat[..., 2].astype(np.float32) / 255.0

    c = (1.0 - np.abs(2.0 * lum - 1.0)) * s
    hp = h / 60.0
    x = c * (1.0 - np.abs(np.mod(hp, 2.0) - 1.0))
    m = lum - c / 2.0

    sector = np.floor(hp).astype(np.int32) % 6
    z = np.zeros_like(c)
    r1 = np.choose(sector, [c, x, z, z, x, c])
    g1 = np.choose(sector, [x, c, c, x, z, z])
    b1 = np.choose(sector, [z, z, x, c, c, x])

    out = np.stack([r1 + m, g1 + m, b1 + m], axis=-1) * 255.0
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def equalize_hist(channel: np.ndarray) -> np.ndarray:
    """Histogram equalization matching cv2.equalizeHist semantics."""
    hist = np.bincount(channel.ravel(), minlength=256)
    nonzero = np.nonzero(hist)[0]
    if len(nonzero) == 0:
        return channel.copy()
    cdf = np.cumsum(hist)
    cdf_min = cdf[nonzero[0]]
    total = channel.size
    if total == cdf_min:
        return channel.copy()
    # cv2 lut: round((cdf - cdf_min) / (total - cdf_min) * 255)
    lut = np.round((cdf - cdf_min) / (total - cdf_min) * 255.0)
    lut = np.clip(lut, 0, 255).astype(np.uint8)
    return lut[channel]
