"""Flagship flow on the PyTorch + CUDA port: synthesis feeding training.

Run from the repository root (on the card by default):
    python examples/synth_train_torch.py
    python examples/synth_train_torch.py --device cpu

One loop, three overlapping stages:
1. Host prep (background thread via synthesize_stream): layout sampling,
   char/font sampling, atlas text-line layout, pre-warp label rasters.
2. Device synthesis: glyph compositing + randomized photometric rounds +
   one warp of image AND labels (on the hand-written CUDA kernels) +
   Jacobian height correction; the batch stays on the device.
3. Training: the conv-FPN detector consumes the batch through the
   device-side label bridge (models/data.py).
Then the evaluation metrics over the batches seen, and a checkpoint that is
written and read back.
"""
import argparse
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np

from vkit_tpu_torch.models import (
    CheckpointManager,
    create_model,
    create_optimizer,
    evaluate,
    init_train_state,
    make_train_step,
    synth_to_train_batch,
)
from vkit_tpu_torch.synth import CropConfig, synthesize_stream
from vkit_tpu_torch.synth.assets import build_assets, find_font, make_planner


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--batches', type=int, default=4)
    args = parser.parse_args()

    root = REPO / 'build' / 'example_assets'
    planner = make_planner(build_assets(root, find_font(root)), 256)
    model = create_model(stage_features=(32, 64), fpn_features=32)
    optimizer = create_optimizer(1e-3)
    state = None
    train_step = make_train_step(model, optimizer)

    rng = np.random.default_rng(0)
    batches = []
    for step_idx, result in enumerate(synthesize_stream(
        planner, batch_size=4, level=4, rng=rng, num_batches=args.batches,
        crop_config=CropConfig(core_size=192, num_per_page=1),
        emit_char_gaussians=True, keep_on_device=True, device=args.device,
    )):
        batch = synth_to_train_batch(
            result.images, result.label_stack, result.active_masks,
            char_gaussians=result.char_gaussian_maps,
        )
        if result.crop_images is not None:
            print(f'  crops: {result.crop_images.shape[0]} '
                  f'{tuple(result.crop_images.shape[1:])}')
        if state is None:
            state = init_train_state(model, optimizer, batch.images,
                                     device=args.device)
        state, metrics = train_step(state, batch)
        batches.append(batch)
        print(f'step {step_idx}: loss={float(metrics["loss"]):.4f} '
              f'mask={float(metrics["mask_loss"]):.4f} '
              f'height={float(metrics["height_loss"]):.4f}')

    scores = evaluate(model, state.params, batches)
    print('eval:', {k: round(v, 4) for k, v in scores.items()})

    with tempfile.TemporaryDirectory() as tmp:
        manager = CheckpointManager(tmp)
        manager.save(state, metadata={'pages_seen': 4 * args.batches})
        restored = manager.restore(state)
        print(f'checkpoint: step {int(restored.step)} on '
              f'{restored.step.device}, {manager.read_metadata()}')


if __name__ == '__main__':
    main()
