"""Models layer: the text-detection consumer of the synthesis pipeline."""
from .checkpoint import CheckpointManager
from .data import evaluate, synth_to_train_batch
from .text_detection import TextDetectionNet
from .train import (
    TrainBatch,
    TrainState,
    create_model,
    create_optimizer,
    init_train_state,
    loss_fn,
    make_train_step,
)

__all__ = [
    'CheckpointManager',
    'TextDetectionNet',
    'TrainBatch',
    'TrainState',
    'create_model',
    'create_optimizer',
    'init_train_state',
    'loss_fn',
    'make_train_step',
]
