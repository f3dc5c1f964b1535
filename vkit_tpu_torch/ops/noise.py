"""Noise kernels drawing from a ``torch.Generator``.

Port of vkit_tpu/ops/noise.py.  Each op takes a generator on the image's own
device in place of the reference's jax PRNG key: deterministic given
(generator state, params), and equal to the reference in distribution only.
Parameters are numbers, or tensors that broadcast against the image: the
batched catalog (mechanism/batched.py) passes one value per sample of an
(N, H, W, C) batch, shaped (N, 1, 1, 1).
"""
import torch

from .common import round_u8, to_f32


def _finish(out, image):
    return round_u8(out) if image.dtype == torch.uint8 else out


def gaussian_noise(generator, image, std):
    noise = torch.randn(image.shape, generator=generator,
                        device=image.device) * std
    return _finish(to_f32(image) + noise, image)


def poisson_noise(generator, image):
    """Poisson(pixel) noise: the CDF inverted over 32 terms below lambda = 16
    and the normal approximation above, the reference catalog's construction
    (not ``torch.poisson``, whose distribution differs at the lambda = 16
    seam)."""
    lam = to_f32(image)
    u = torch.rand(lam.shape, generator=generator, device=lam.device)
    lam_s = torch.clamp(lam, max=16.0)
    p = torch.exp(-lam_s)
    c = p
    count = (u > c).to(torch.float32)
    for k in range(1, 32):
        p = p * (lam_s / k)
        c = c + p
        count = count + (u > c)
    z = torch.randn(lam.shape, generator=generator, device=lam.device)
    approx = torch.round(lam + torch.sqrt(lam) * z)
    return _finish(torch.where(lam < 16.0, count, approx), image)


def impulse_noise(generator, image, prob_salt, prob_pepper):
    """Salt and pepper, one draw per pixel shared by its channels: (H, W)
    for an (H, W) or (H, W, C) image, (N, H, W) for an (N, H, W, C) batch."""
    if image.dim() == 2:
        u = torch.rand(image.shape, generator=generator, device=image.device)
    else:
        u = torch.rand(image.shape[:-1], generator=generator,
                       device=image.device)[..., None]
    salt = u < prob_salt
    pepper = (u >= prob_salt) & (u < prob_salt + prob_pepper)
    out = torch.where(salt, image.new_full((), 255), image)
    return torch.where(pepper, image.new_zeros(()), out)


def speckle_noise(generator, image, std):
    noise = torch.randn(image.shape, generator=generator,
                        device=image.device) * std
    return _finish(to_f32(image) * (1.0 + noise), image)
