"""Synth pipeline -> training batches: the real label feed.

Port of vkit_tpu/models/data.py.  Bridges synth.device.SynthBatchResult
(batched page images + warped label channels) into models.train.TrainBatch
on the batch's device: labels pool to the model's stride-2 output grid, and
the gaussian-centroid target is the per-char gaussian map where the stream
emitted one, else the char mask blurred with a separable gaussian.
"""
import torch
import torch.nn.functional as F

from ..ops.blur import filter2d, gaussian_kernel1d
from ..synth.prep import CHAR_HEIGHT, CHAR_MASK
from .train import TrainBatch


def _pool2(x):
    n, h, w = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2).amax(dim=(2, 4))


def synth_to_train_batch(images, label_stack, active_masks,
                         char_gaussians=None) -> TrainBatch:
    """(images u8 (N,H,W,3), label_stack f32 (N,H,W,4), active u8) ->
    TrainBatch with stride-2 label grids, all on the inputs' device.

    ``char_gaussians``: optional (N, H, W) per-char quad-warped gaussian
    maps from synthesize_page_batch(emit_char_gaussians=True) — the
    reference-faithful centroid target; without it the blurred char mask
    stands in."""
    char_mask = label_stack[..., CHAR_MASK]
    char_height = label_stack[..., CHAR_HEIGHT]
    active = active_masks.to(torch.float32)

    char_mask = char_mask * active
    char_height = char_height * active

    mask_2 = (_pool2(char_mask) > 0.5).to(torch.float32)
    height_2 = _pool2(char_height) * 0.5  # heights follow the 2x downsample

    if char_gaussians is not None:
        gaussian_2 = _pool2(char_gaussians * active)
    else:
        k1 = gaussian_kernel1d(2.0, 9)
        kernel = torch.from_numpy(k1[:, None] * k1[None, :]).to(
            device=mask_2.device, dtype=torch.float32)
        # One kernel for every sample, reflect-101 border: what the
        # reference's per-sample filter2d computes.
        gaussian_2 = filter2d(mask_2[..., None], kernel)[..., 0]
        gaussian_2 = gaussian_2 / torch.clamp(
            gaussian_2.amax(dim=(1, 2), keepdim=True), min=1e-6
        )

    return TrainBatch(
        images=images,
        char_masks=mask_2,
        char_heights=height_2,
        char_gaussians=gaussian_2,
    )


@torch.no_grad()
def evaluate(model, params, batches):
    """Mean eval metrics over TrainBatches: char-mask IoU@0.5, height MAE
    on text pixels, gaussian MSE."""
    totals = None
    count = 0
    for batch in batches:
        mask_logits, height_raw, gaussian_logits = torch.func.functional_call(
            model, params, (batch.images,)
        )
        pred_mask = torch.sigmoid(mask_logits[..., 0]) > 0.5
        target = batch.char_masks > 0.5
        inter = (pred_mask & target).sum()
        union = torch.clamp((pred_mask | target).sum(), min=1)

        pred_height = F.softplus(height_raw[..., 0])
        on_text = batch.char_masks
        height_mae = (
            torch.abs(pred_height - batch.char_heights) * on_text
        ).sum() / torch.clamp(on_text.sum(), min=1.0)

        gaussian = torch.sigmoid(gaussian_logits[..., 0])
        gaussian_mse = ((gaussian - batch.char_gaussians) ** 2).mean()
        one = torch.stack([inter / union, height_mae, gaussian_mse])
        totals = one if totals is None else totals + one
        count += 1
    if totals is None:
        return {'char_mask_iou': 0.0, 'char_height_mae': 0.0,
                'gaussian_mse': 0.0}
    iou, height_mae, gaussian_mse = (totals / count).tolist()
    return {
        'char_mask_iou': float(iou),
        'char_height_mae': float(height_mae),
        'gaussian_mse': float(gaussian_mse),
    }
