"""Training step for the text-detection net.

Port of vkit_tpu/models/train.py (flax + optax).  Loss heads mirror the
pipeline's labels: balanced BCE on the char mask, masked smooth-L1 on char
height (log-scaled), MSE on the gaussian centroid map.

On a mesh (a net laid out by ``TextDetectionNet.shard``) the step is the
reference's sharded jit written out: each rank computes its part of the
global loss, and its gradients are summed over dp and sp (see
``make_train_step``).

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
from ..parallel.mesh import (
    DATA_AXIS,
    SPATIAL_AXIS,
    replicated,
)
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
    if model.mesh is not None:
        raise ValueError('initialise the net before TextDetectionNet.shard')
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


def _label_rows(batch: TrainBatch, mesh, rows: int):
    """The labels (N over dp only, ``data_sharding``) cut to this rank's
    ``rows`` output rows when the rows are split over sp."""
    labels = (batch.char_masks, batch.char_heights, batch.char_gaussians)
    if mesh is None or mesh.size(SPATIAL_AXIS) == 1:
        return labels
    start = mesh.coordinate(SPATIAL_AXIS) * rows
    return tuple(label[:, start:start + rows] for label in labels)


def loss_fn(model: TextDetectionNet, params, batch: TrainBatch):
    """``model`` evaluated at ``params`` (name -> tensor, as in its
    state_dict) on ``batch``: (total loss, the four terms).

    The reference's terms are over the whole batch.  On a mesh the counts
    they divide by (pixels, text pixels) are summed over dp and sp first,
    and each term is this rank's sum over them: the ranks' terms add up to
    the unsharded loss."""
    mask_logits, height_raw, gaussian_logits = torch.func.functional_call(
        model, params, (batch.images,)
    )
    mask_logits = mask_logits[..., 0]
    height_raw = height_raw[..., 0]
    gaussian = torch.sigmoid(gaussian_logits[..., 0])

    char_masks, char_heights, char_gaussians = _label_rows(
        batch, model.mesh, mask_logits.shape[1])
    target_mask = char_masks.to(torch.float32)
    counts = torch.stack([target_mask.sum().detach(),
                          target_mask.new_tensor(float(target_mask.numel()))])
    if model.mesh is not None:
        model.mesh.all_reduce_(counts, (DATA_AXIS, SPATIAL_AXIS))
    mask_sum, pixels = counts

    # Balanced BCE: weight positives by the inverse class frequency so the
    # sparse text pixels are not drowned out.
    pos_frac = torch.clamp(mask_sum / pixels, 1e-3, 1.0 - 1e-3)
    pos_weight = (1.0 - pos_frac) / pos_frac
    bce = F.binary_cross_entropy_with_logits(
        mask_logits, target_mask, reduction='none')
    bce = bce * (target_mask * (pos_weight - 1.0) + 1.0)
    mask_loss = bce.sum() / pixels

    # Char height: smooth-L1 in log space, only on text pixels.
    pred_height = F.softplus(height_raw)
    log_err = torch.log1p(pred_height) - torch.log1p(char_heights)
    huber = F.huber_loss(log_err, torch.zeros_like(log_err), delta=1.0,
                         reduction='none')
    denom = torch.clamp(mask_sum, min=1.0)
    height_loss = (huber * target_mask).sum() / denom

    gaussian_loss = ((gaussian - char_gaussians) ** 2).sum() / pixels

    total = mask_loss + height_loss + 10.0 * gaussian_loss
    return total, {
        'loss': total,
        'mask_loss': mask_loss,
        'height_loss': height_loss,
        'gaussian_loss': gaussian_loss,
    }


def _sum_gradients(parameters, mesh):
    """Every gradient summed over dp x sp: one all-reduce of one flat
    bucket."""
    grads = [p.grad for p in parameters]
    flat = torch.cat([g.reshape(-1) for g in grads])
    mesh.all_reduce_(flat, (DATA_AXIS, SPATIAL_AXIS))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def train_state_sharding(state: TrainState, param_shardings) -> TrainState:
    """The placement of a TrainState whose parameters lie as
    ``param_shardings`` says: AdamW's moments like their parameters, its
    per-parameter step counts left on the host, the step replicated."""
    mesh = next(iter(param_shardings.values())).mesh
    names = list(state.params)
    # The optimizer numbers the parameters in the net's order, which is
    # the state_dict's: the net has no buffers.
    moments = {
        index: {key: None if key == 'step' else param_shardings[names[index]]
                for key in entry}
        for index, entry in state.opt_state.get('state', {}).items()
    }
    return TrainState(
        params=param_shardings,
        opt_state={'state': moments, 'param_groups': None},
        step=replicated(mesh),
    )


def make_train_step(model: TextDetectionNet, optimizer: Callable):
    """Returns the (state, batch) -> (state, metrics) step function.  It
    runs on the device of ``state``; the batch is moved there if need be.

    On a mesh the state holds this rank's slices (``train_state_sharding``)
    and the batch its slice: images as ``batch_sharding`` places them,
    labels as ``data_sharding`` does.  After the backward pass every
    gradient is summed over dp x sp (one all-reduce of one flat bucket); tp
    needs no sum, since each tp rank holds the whole gradient of what it
    holds (parallel/layers.py).  The metrics are the global values."""
    opt = optimizer(model.parameters())

    def train_step(state: TrainState, batch: TrainBatch):
        mesh = model.mesh
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
        if mesh is not None:
            _sum_gradients(list(model.parameters()), mesh)
        opt.step()
        metrics = {name: value.detach() for name, value in metrics.items()}
        if mesh is not None:
            values = torch.stack(list(metrics.values()))
            mesh.all_reduce_(values, (DATA_AXIS, SPATIAL_AXIS))
            metrics = dict(zip(metrics, values.unbind()))
        # The next call overwrites the model's parameters, so they are
        # copied out; it replaces the optimizer's state, so that is not.
        return TrainState(
            params=_detached(model.state_dict()),
            opt_state=opt.state_dict(),
            step=state.step + 1,
        ), metrics

    return train_step
