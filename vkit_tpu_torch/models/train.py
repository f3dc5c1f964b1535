"""Training step for the text-detection net.

Port of vkit_tpu/models/train.py (flax + optax).  Loss heads mirror the
pipeline's labels: balanced BCE on the char mask, masked smooth-L1 on char
height (log-scaled), MSE on the gaussian centroid map.

The step keeps the reference's contract: ``train_step(state, batch)``
returns a new ``TrainState`` and leaves ``state`` as it was, so a state
restored from a checkpoint continues exactly like the one that was saved.
The model and the optimizer are PyTorch's stateful ones, so each step
copies ``state`` into them and the new parameters out again: a few
parameter-sized copies, small beside the step's activations.
"""
import copy
import functools
from typing import Callable, Dict, NamedTuple

import torch
import torch.nn.functional as F

from ..convert import resolve_device, to_tensor
from .text_detection import TextDetectionNet

WEIGHT_DECAY = 1e-4


class TrainBatch(NamedTuple):
    images: torch.Tensor              # (N, H, W, 3) uint8
    char_masks: torch.Tensor          # (N, H/2, W/2) uint8/f32 {0,1}
    char_heights: torch.Tensor        # (N, H/2, W/2) f32 (pixels, 0 = bg)
    char_gaussians: torch.Tensor      # (N, H/2, W/2) f32 in [0,1]


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]   # the model's state_dict
    opt_state: dict                   # the optimizer's state_dict
    step: torch.Tensor                # () int32


def create_model(**kwargs) -> TextDetectionNet:
    return TextDetectionNet(**kwargs)


def create_optimizer(learning_rate: float = 1e-3) -> Callable:
    """parameters -> the AdamW that ``optax.adamw(learning_rate,
    weight_decay=1e-4)`` is: both decay by ``lr * wd * p`` and put ``eps``
    outside the root.  optax decays every leaf, GroupNorm scales and biases
    included, so no parameter group is exempt."""
    return functools.partial(
        torch.optim.AdamW, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=WEIGHT_DECAY,
    )


def _batch_on(batch: TrainBatch, device) -> TrainBatch:
    return TrainBatch(*(to_tensor(field, device) for field in batch))


def init_train_state(
    model: TextDetectionNet,
    optimizer: Callable,
    example_images,
    seed: int = 0,
    device='cuda',
) -> TrainState:
    """Initialise ``model`` from ``seed`` and move it to ``device``; the
    state holds copies of its parameters and a fresh optimizer state.

    The values are drawn on the host, so one seed gives the same
    parameters on the CPU and on a card.  ``example_images`` is kept for
    the reference's signature: its shape decides nothing here."""
    device = resolve_device(device)
    generator = torch.Generator()
    generator.manual_seed(seed)
    model.reset_parameters(generator)
    model.to(device)
    opt = optimizer(model.parameters())
    return TrainState(
        params=_detached(model.state_dict()),
        opt_state=opt.state_dict(),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def _detached(state_dict):
    return {name: value.detach().clone() for name, value in state_dict.items()}


def loss_fn(model: TextDetectionNet, params, batch: TrainBatch):
    """``model`` evaluated at ``params`` (name -> tensor, as in its
    state_dict) on ``batch``: (total loss, the four terms)."""
    mask_logits, height_raw, gaussian_logits = torch.func.functional_call(
        model, params, (batch.images,)
    )
    mask_logits = mask_logits[..., 0]
    height_raw = height_raw[..., 0]
    gaussian = torch.sigmoid(gaussian_logits[..., 0])

    target_mask = batch.char_masks.to(torch.float32)

    # Balanced BCE: weight positives by the inverse class frequency so the
    # sparse text pixels are not drowned out.
    pos_frac = torch.clamp(target_mask.mean(), 1e-3, 1.0 - 1e-3)
    pos_weight = (1.0 - pos_frac) / pos_frac
    bce = F.binary_cross_entropy_with_logits(
        mask_logits, target_mask, reduction='none')
    bce = bce * (target_mask * (pos_weight - 1.0) + 1.0)
    mask_loss = bce.mean()

    # Char height: smooth-L1 in log space, only on text pixels.
    pred_height = F.softplus(height_raw)
    log_err = torch.log1p(pred_height) - torch.log1p(batch.char_heights)
    huber = F.huber_loss(log_err, torch.zeros_like(log_err), delta=1.0,
                         reduction='none')
    denom = torch.clamp(target_mask.sum(), min=1.0)
    height_loss = (huber * target_mask).sum() / denom

    gaussian_loss = ((gaussian - batch.char_gaussians) ** 2).mean()

    total = mask_loss + height_loss + 10.0 * gaussian_loss
    return total, {
        'loss': total,
        'mask_loss': mask_loss,
        'height_loss': height_loss,
        'gaussian_loss': gaussian_loss,
    }


def make_train_step(model: TextDetectionNet, optimizer: Callable):
    """Returns the (state, batch) -> (state, metrics) step function.  It
    runs on the device of ``state``; the batch is moved there if need be."""
    opt = optimizer(model.parameters())

    def train_step(state: TrainState, batch: TrainBatch):
        device = state.step.device
        if next(model.parameters()).device != device:
            raise ValueError(
                f'the state is on {device}, the model on '
                f'{next(model.parameters()).device}'
            )
        batch = _batch_on(batch, device)
        # load_state_dict copies the parameters into the model's own, but
        # lets the optimizer adopt the tensors it is given: copy them, or
        # the step would update ``state`` in place.
        model.load_state_dict(state.params)
        opt.load_state_dict(copy.deepcopy(state.opt_state))
        model.train()
        opt.zero_grad(set_to_none=True)
        total, metrics = loss_fn(model, dict(model.named_parameters()), batch)
        total.backward()
        opt.step()
        metrics = {name: value.detach() for name, value in metrics.items()}
        # The next call overwrites the model's parameters, so they are
        # copied out; it replaces the optimizer's state, so that is not.
        return TrainState(
            params=_detached(model.state_dict()),
            opt_state=opt.state_dict(),
            step=state.step + 1,
        ), metrics

    return train_step
