"""End-to-end demo on the PyTorch + CUDA port: synthesize pages ->
batch-distort on the card -> train.

Run from the repository root (on the card by default):
    python examples/end_to_end_torch.py
    python examples/end_to_end_torch.py --device cpu

The twin of examples/end_to_end.py, on vkit_tpu_torch.  Three stages:
1. Host synthesis: the 17-step text-detection pipeline generates labeled
   page crops (assets from vkit_tpu_torch.synth.assets).  Step 15 flattens
   its text regions on ``--device`` (the CUDA row-shift kernels on a card).
   The pipeline runs under PipelineRunner, as the pool's workers run it: an
   attempt whose draw the warp planner refuses (a region scaled too far, see
   ops/warp_mxu.py) is retried with the rng moved on.
2. Device augmentation: the one-program distortion chain
   (parallel.synthesize_batch) at level 3 over the crop batch.
3. Training: one step of the narrow conv-FPN detector on one device (the
   multi-rank form is ``python -m vkit_tpu_torch.entry``).
"""
import argparse
import math
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import attr
import numpy as np
import torch

from vkit_tpu_torch import convert
from vkit_tpu_torch.models import (
    TrainBatch,
    create_model,
    create_optimizer,
    init_train_state,
    make_train_step,
)
from vkit_tpu_torch.parallel import sample_synthesis_params, synthesize_batch
from vkit_tpu_torch.pipeline import (
    PageCroppingStepOutput,
    Pipeline,
    PipelinePostProcessor,
    PipelinePostProcessorFactory,
    pipeline_step_collection_factory,
)
from vkit_tpu_torch.pipeline.pool import PipelineRunner
from vkit_tpu_torch.synth.assets import build_assets, build_step_configs, find_font

NUM_CROPS = 4


@attr.define
class DemoConfig:
    pass


@attr.define
class DemoInput:
    page_cropping_step_output: PageCroppingStepOutput


class DemoPostProcessor(PipelinePostProcessor[DemoConfig, DemoInput, list]):

    def generate_output(self, input: DemoInput, rng):
        out = []
        for page in input.page_cropping_step_output.cropped_pages:
            label = page.downsampled_label
            # Place the core-only downsampled labels into the full
            # stride-2 frame (pad region stays zero / unsupervised).
            h, w = label.shape
            box = label.target_core_box
            char_mask = np.zeros((h, w), dtype=np.float32)
            char_mask[box.up:box.down + 1, box.left:box.right + 1] = (
                label.page_char_mask.mat
            )
            char_height = np.zeros((h, w), dtype=np.float32)
            char_height[box.up:box.down + 1, box.left:box.right + 1] = (
                label.page_char_height_score_map.mat
            )
            out.append({
                'image': page.page_image.mat,
                'char_mask': char_mask,
                'char_height': char_height,
            })
        return out


def build_pipeline(assets: dict, device: str) -> Pipeline:
    return Pipeline(
        steps=pipeline_step_collection_factory.create(
            build_step_configs(assets, device=device)
        ),
        post_processor=PipelinePostProcessorFactory(DemoPostProcessor).create(),
    )


def synthesize_crops(pipeline: Pipeline, rng, count: int) -> list:
    """``count`` labeled crops from as many pipeline runs as it takes."""
    runner = PipelineRunner(pipeline=pipeline)
    crops = []
    while len(crops) < count:
        crops.extend(runner(0, rng, None))
    return crops[:count]


def augment(images: np.ndarray, rng, device) -> torch.Tensor:
    """The crops through the distortion chain at level 3, on ``device``."""
    params, warp_statics = sample_synthesis_params(
        rng, len(images), images.shape[1], images.shape[2], level=3
    )
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    return synthesize_batch(
        convert.to_tensor(images, device), params, generator,
        warp_statics=warp_statics,
    )


def train_one_step(augmented: torch.Tensor, crops: list, device) -> float:
    """One step of the narrow detector on the augmented crops; the loss."""
    model = create_model(stage_features=(32, 64, 128), fpn_features=64)
    optimizer = create_optimizer()
    half = augmented.shape[1] // 2
    batch = TrainBatch(
        images=augmented,
        char_masks=np.stack([c['char_mask'] for c in crops]),
        char_heights=np.stack([c['char_height'] for c in crops]),
        char_gaussians=np.zeros((len(crops), half, half), np.float32),
    )
    state = init_train_state(model, optimizer, batch.images[:1],
                             device=device)
    _, metrics = make_train_step(model, optimizer)(state, batch)
    return float(metrics['loss'])


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args()
    device = convert.resolve_device(args.device)

    # 1. Host synthesis.
    print('1) synthesizing pages (17-step pipeline)...')
    rng = np.random.default_rng(0)
    begin = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        pipeline = build_pipeline(build_assets(root, find_font(root)),
                                  args.device)
        crops = synthesize_crops(pipeline, rng, NUM_CROPS)
    images = np.stack([c['image'] for c in crops])            # (4, 320, 320, 3)
    print(f'   crops: {images.shape} in '
          f'{time.perf_counter() - begin:.1f} s')

    # 2. Device augmentation (labels co-transform via the same geometry).
    print(f'2) batch-distorting on {device}...')
    augmented = augment(images, rng, device)
    print('   augmented:', tuple(augmented.shape), augmented.dtype)

    # 3. One training step.
    print(f'3) training step on {device}...')
    loss = train_one_step(augmented, crops, device)
    print('   loss:', loss)
    if not math.isfinite(loss):
        raise SystemExit(f'the loss is not finite: {loss}')
    print('OK')


if __name__ == '__main__':
    main()
