"""examples/end_to_end_torch.py, the twin of examples/end_to_end.py on the
port, in its three stages on the CPU: the 17-step pipeline under
PipelineRunner to labeled crops through the example's post-processor, the
distortion chain over them, one train step of the narrow detector.  The
whole example takes minutes here (about two failed attempts of the
pipeline for each that succeeds, seconds each), so this test takes one
pipeline run from seed 2024, the seed of tests/pipeline/test_pipeline.py,
and its two crops.
"""
import importlib.util
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from vkit_tpu_torch.synth.assets import build_assets, find_font

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
EXAMPLE = REPO / 'examples' / 'end_to_end_torch.py'


def _example():
    spec = importlib.util.spec_from_file_location('end_to_end_torch', EXAMPLE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_example_stages_on_the_cpu(tmp_path):
    example = _example()
    pipeline = example.build_pipeline(
        build_assets(tmp_path, find_font(tmp_path)), 'cpu')
    rng = np.random.default_rng(2024)
    crops = example.synthesize_crops(pipeline, rng, 2)
    assert len(crops) == 2
    for crop in crops:
        assert crop['image'].shape == (320, 320, 3)
        assert crop['image'].dtype == np.uint8
        assert crop['char_mask'].shape == crop['char_height'].shape == (
            160, 160)
        assert set(np.unique(crop['char_mask'])) <= {0.0, 1.0}
        # Labels only inside the 128 x 128 core, the pad left unsupervised.
        core = np.zeros((160, 160), bool)
        core[16:144, 16:144] = True
        assert not crop['char_mask'][~core].any()
        assert (crop['char_height'] >= 0).all()
    assert sum(crop['char_mask'].sum() for crop in crops) > 0
    images = np.stack([c['image'] for c in crops])
    augmented = example.augment(images, rng, 'cpu')
    assert augmented.shape == (2, 320, 320, 3)
    assert augmented.dtype == torch.uint8
    loss = example.train_one_step(augmented, crops, 'cpu')
    assert math.isfinite(loss) and loss > 0


def test_the_example_asks_for_a_card():
    env = {k: v for k, v in os.environ.items() if k != 'CUDA_VISIBLE_DEVICES'}
    env['CUDA_VISIBLE_DEVICES'] = ''
    proc = subprocess.run([sys.executable, str(EXAMPLE)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert 'DeviceError' in proc.stderr and 'OK' not in proc.stdout
