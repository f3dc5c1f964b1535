"""Flagship model: text-detection net consuming the pipeline's labels.

Port of vkit_tpu/models/text_detection.py (flax) to ``torch.nn``: a
conv-FPN with bfloat16 compute, static shapes, and three dense heads
aligned with the pipeline's downsampled labels (stride 2).  The public
layout is the reference's: images in as (N, H, W, 3) uint8, three outputs
(N, H/2, W/2, 1) float32.  Inside, tensors are NCHW in ``channels_last``
memory, which is the same bytes as the NHWC input.

Where a PyTorch default differs from the flax one, the flax one is kept:
  - ``nn.Conv`` pads 'SAME': a 3x3 stride-2 conv on an even side pads
    (0, 1), not (1, 1);
  - ``nn.gelu`` is the tanh approximation;
  - ``nn.GroupNorm`` has epsilon 1e-6, takes its statistics in float32 and
    returns the compute dtype;
  - parameters are float32 and cast to the compute dtype at each call; a
    conv's output has the compute dtype.
The convolutions are library calls (cuDNN on a card), as they are XLA
convolutions in the reference: no hand-written kernel is replaced here.

``TextDetectionNet.shard`` lays one net out over a dp x sp x tp mesh
(parallel/mesh.py): each rank then holds its rows of the activations and
its slice of the wide convs' output channels, and the convs and
GroupNorms run the collectives of parallel/layers.py.  Unsharded, the
same modules run as above.
"""
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.common import scalar
from ..parallel.layers import (
    all_reduce_sum,
    copy_to_tp,
    exchange_halo,
    gather_channels,
)
from ..parallel.mesh import MODEL_AXIS, SPATIAL_AXIS, local_slice

GROUPS = 32
GROUP_NORM_EPS = 1e-6
# A standard normal truncated to +-2 has this standard deviation; flax's
# lecun_normal divides by it so that the kernel's variance is 1 / fan_in.
_TRUNCATED_STD = 0.87962566103423978


def _same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of one axis under XLA's 'SAME' rule."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _rows_split(mesh) -> bool:
    return mesh is not None and mesh.size(SPATIAL_AXIS) > 1


class Conv(nn.Module):
    """flax ``nn.Conv`` with 'SAME' padding on an NCHW tensor: float32
    parameters, cast to the input's dtype at each call.

    On a mesh (``mesh`` set by ``TextDetectionNet.shard``) the rows of the
    'SAME' padding come from the neighbouring sp ranks, and a conv whose
    output channels are split over tp (``tp_split``) computes its slice and
    all-gathers the channels; its bias, replicated, is added after."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, use_bias: bool = True):
        super().__init__()
        self.kernel = kernel
        self.stride = stride
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.mesh = None
        self.tp_split = False

    def reset_parameters(self, generator: torch.Generator):
        """lecun_normal kernel (truncated normal, variance 1 / fan_in), zero
        bias: the distributions of flax's defaults."""
        fan_in = self.weight.shape[1] * self.kernel * self.kernel
        std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        if _rows_split(self.mesh):
            x = exchange_halo(x, self.kernel, self.stride, self.mesh)
            pad_h = (0, 0)
        else:
            pad_h = _same_padding(x.shape[2], self.kernel, self.stride)
        pad_w = _same_padding(x.shape[3], self.kernel, self.stride)
        if any(pad_h + pad_w):
            x = F.pad(x, pad_w + pad_h)
        weight = self.weight.to(x.dtype)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if not self.tp_split:
            return F.conv2d(x, weight, bias, stride=self.stride)
        x = F.conv2d(copy_to_tp(x, self.mesh), weight, stride=self.stride)
        x = gather_channels(x, self.mesh)
        return x if bias is None else x + bias[:, None, None]


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm``: statistics and affine in float32, the result
    in the input's dtype.

    With the rows split over sp the statistics come from sums over this
    rank's rows all-reduced over sp, and the variance is flax's
    ``E[x^2] - E[x]^2``."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mesh = None

    def forward(self, x):
        if not _rows_split(self.mesh):
            y = F.group_norm(x.to(torch.float32), GROUPS, self.weight,
                             self.bias, GROUP_NORM_EPS)
            return y.to(x.dtype)
        n, c, h, w = x.shape
        xf = x.to(torch.float32).permute(0, 2, 3, 1).reshape(
            n, h * w, GROUPS, c // GROUPS)
        sums = all_reduce_sum(torch.stack([
            xf.sum(dim=(1, 3)), (xf * xf).sum(dim=(1, 3))]), self.mesh)
        count = h * w * (c // GROUPS) * self.mesh.size(SPATIAL_AXIS)
        mean = sums[0] / count
        var = torch.clamp(sums[1] / count - mean * mean, min=0.0)
        inv = torch.rsqrt(var + GROUP_NORM_EPS)
        y = (xf - mean[:, None, :, None]) * inv[:, None, :, None]
        y = y.reshape(n, h, w, c) * self.weight + self.bias
        return y.permute(0, 3, 1, 2).to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate='tanh')


class ConvBlock(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(in_features, features, 3, stride, use_bias=False)
        self.norm1 = GroupNorm(features)
        self.conv2 = Conv(features, features, 3, use_bias=False)
        self.norm2 = GroupNorm(features)

    def forward(self, x):
        x = _gelu(self.norm1(self.conv1(x)))
        return _gelu(self.norm2(self.conv2(x)))


class TextDetectionNet(nn.Module):
    """Conv-FPN with char-mask / char-height / gaussian-centroid heads.

    Input: (N, H, W, 3) uint8 (H, W multiples of 16).
    Outputs at stride 2 (matching downsample_labeling_factor=2 in
    page_cropping / page_text_region_cropping):
      - char_mask_logits        (N, H/2, W/2, 1)
      - char_height_raw         (N, H/2, W/2, 1)  (softplus -> pixels)
      - char_gaussian_logits    (N, H/2, W/2, 1)
    """

    def __init__(self, stage_features: Sequence[int] = (64, 128, 256, 512),
                 fpn_features: int = 128,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.stage_features = tuple(stage_features)
        self.fpn_features = fpn_features
        self.dtype = dtype
        widths = (3,) + self.stage_features
        self.stages = nn.ModuleList(
            ConvBlock(widths[i], widths[i + 1], stride=2)
            for i in range(len(self.stage_features))
        )
        # Top-down FPN back to stride 2: one lateral and one smoothing conv
        # per skip, deepest skip first.
        self.top = Conv(widths[-1], fpn_features, 1)
        skips = self.stage_features[-2::-1]
        self.laterals = nn.ModuleList(
            Conv(features, fpn_features, 1) for features in skips)
        self.smooths = nn.ModuleList(
            Conv(fpn_features, fpn_features, 3) for _ in skips)
        self.mask_head = Conv(fpn_features, 1, 1)
        self.height_head = Conv(fpn_features, 1, 1)
        self.gaussian_head = Conv(fpn_features, 1, 1)
        self.mesh = None

    def shard(self, shardings):
        """Lay the net out over the mesh of ``shardings`` ({parameter name:
        Sharding}, as ``parallel.shard_params_for_tp`` gives them): each
        parameter becomes this rank's slice of it, and the convs and
        GroupNorms run their collectives from then on.  The net then takes
        this rank's rows of its dp slice of the images (``batch_sharding``)
        and returns its rows of the outputs.  Initialise the parameters
        before (``init_train_state``): drawn on a slice they would differ.
        """
        names = dict(self.named_parameters())
        if shardings.keys() != names.keys():
            raise ValueError('the shardings name other parameters than the '
                             'net\'s')
        for name, sharding in shardings.items():
            split = [axis for axis in sharding.spec if axis is not None]
            if split and not (names[name].dim() == 4 and split == [MODEL_AXIS]
                              and sharding.spec[0] == MODEL_AXIS):
                raise ValueError(f'{name}: only a conv\'s output channels '
                                 f'split (over tp), not {sharding.spec}')
        mesh = next(iter(shardings.values())).mesh
        self.mesh = mesh
        for prefix, module in self.named_modules():
            if isinstance(module, (Conv, GroupNorm)):
                module.mesh = mesh
            if isinstance(module, Conv):
                spec = shardings[f'{prefix}.weight'].spec
                module.tp_split = spec[:1] == (MODEL_AXIS,)
        with torch.no_grad():
            for name, param in names.items():
                param.data = local_slice(param.data, shardings[name])
        return self

    def reset_parameters(self, generator: torch.Generator):
        """Initial values from ``generator`` in flax's distributions:
        lecun_normal kernels, zero biases, GroupNorm scale 1."""
        for module in self.modules():
            if isinstance(module, Conv):
                module.reset_parameters(generator)
            elif isinstance(module, GroupNorm):
                with torch.no_grad():
                    module.weight.fill_(1.0)
                    module.bias.zero_()

    def forward(self, images):
        x = images.permute(0, 3, 1, 2).to(torch.float32)
        x = (x / scalar(127.5, x) - 1.0).to(self.dtype)

        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)

        y = self.top(feats[-1])
        for skip, lateral, smooth in zip(feats[-2::-1], self.laterals,
                                         self.smooths):
            y = F.interpolate(y, scale_factor=2, mode='nearest')
            y = _gelu(smooth(y + lateral(skip)))

        y = y.to(torch.float32)
        return tuple(
            head(y).permute(0, 2, 3, 1)
            for head in (self.mask_head, self.height_head,
                         self.gaussian_head)
        )
