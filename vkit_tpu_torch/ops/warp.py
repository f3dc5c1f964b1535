"""Backward-map bilinear remap with a constant border.

Port of the bilinear branch of vkit_tpu/ops/warp.py ``remap_f32``, batched
over a leading sample axis.  Each of the four taps that falls outside the
source reads the border value (cv2 BORDER_CONSTANT per-tap masking).
``torch.nn.functional.grid_sample`` pads only with zeros or the edge pixel,
so the gather is written out.
"""
import torch


def remap_f32(images, map_y, map_x, border_value: float = 0.0):
    """Bilinear backward warp of (N, H, W, C) by (N, H', W') float maps ->
    (N, H', W', C) float32."""
    images = images.to(torch.float32)
    n, height, width, channels = images.shape
    flat = images.reshape(n, height * width, channels)

    y0f = torch.floor(map_y)
    x0f = torch.floor(map_x)
    wy = (map_y - y0f)[..., None]
    wx = (map_x - x0f)[..., None]
    y0 = y0f.to(torch.int64)
    x0 = x0f.to(torch.int64)
    border = torch.full((), border_value, dtype=torch.float32,
                        device=images.device)

    def tap(ys, xs):
        valid = (ys >= 0) & (ys < height) & (xs >= 0) & (xs < width)
        idx = ys.clamp(0, height - 1) * width + xs.clamp(0, width - 1)
        idx = idx.reshape(n, -1, 1).expand(-1, -1, channels)
        vals = torch.gather(flat, 1, idx).reshape(*ys.shape, channels)
        return torch.where(valid[..., None], vals, border)

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    return (
        v00 * (1 - wy) * (1 - wx)
        + v01 * (1 - wy) * wx
        + v10 * wy * (1 - wx)
        + v11 * wy * wx
    )


def to_image_dtype(x, dtype):
    """float32 result -> ``dtype``: integer images round and clip to
    [0, 255] (the reference's uint8 rule), float images cast."""
    if not dtype.is_floating_point:
        return torch.clamp(torch.round(x), 0, 255).to(dtype)
    return x.to(dtype)
