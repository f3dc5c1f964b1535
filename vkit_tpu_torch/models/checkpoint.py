"""Checkpoint / resume for training state.

Port of vkit_tpu/models/checkpoint.py with the same directory contract:
atomic, versioned save / restore of the TrainState plus the data-stream
position, so a preempted run resumes exactly.  The state is one
``torch.save`` file of tensors moved to the CPU, read back with
``weights_only=True`` onto the example state's device.

A state sharded over a mesh (``sharding=``, the parameters' placement)
round-trips as the reference's npz path does: ``save`` gathers every leaf
to its global value and rank 0 writes it in the unsharded layout, so a
single process reads it back; ``restore`` gives each rank its slices.  The
ranks share the directory.
"""
import json
import os
import shutil
from pathlib import Path
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..convert import nested_to_device
from ..parallel.mesh import gather, put
from .train import TrainState, train_state_sharding


class CheckpointManager:
    """Save/restore TrainState + metadata under ``directory/step_<N>``."""

    def __init__(self, directory, max_to_keep: int = 3):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _step_dir(self, step: int) -> Path:
        return self.directory / f'step_{step:08d}'

    def all_steps(self):
        # In-progress *.tmp directories are invisible until renamed.
        return sorted(
            int(p.name.split('_')[1])
            for p in self.directory.glob('step_*')
            if p.is_dir() and not p.name.endswith('.tmp')
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, metadata: Optional[dict] = None,
             sharding=None):
        """Write ``state`` as step ``state.step``.  With ``sharding`` (the
        parameters' {name: Sharding}) every rank of the mesh calls this:
        the leaves are gathered, rank 0 writes, and the others wait until
        the checkpoint is in place."""
        if sharding is None:
            self._write(state, metadata)
            return
        state = gather(state, train_state_sharding(state, sharding))
        if not dist.is_initialized():
            self._write(state, metadata)
            return
        if dist.get_rank() == 0:
            self._write(state, metadata)
        dist.barrier()

    def _write(self, state: TrainState, metadata: Optional[dict]):
        # Stage into step_N.tmp and os.replace() once complete, so a crash
        # mid-save can never surface a half-written checkpoint.
        step = int(state.step)
        final_path = self._step_dir(step)
        tmp_path = final_path.with_suffix('.tmp')
        if tmp_path.exists():
            shutil.rmtree(tmp_path)
        tmp_path.mkdir(parents=True, exist_ok=True)

        torch.save(nested_to_device(state._asdict(), 'cpu'), tmp_path / 'state.pt')
        (tmp_path / 'metadata.json').write_text(
            json.dumps({'step': step, **(metadata or {})})
        )

        if final_path.exists():
            shutil.rmtree(final_path)
        os.replace(tmp_path, final_path)
        self._gc()

    def restore(self, example_state: TrainState,
                step: Optional[int] = None, sharding=None) -> TrainState:
        """The saved state on the device of ``example_state``, whose
        parameter names it must have; with ``sharding`` (the parameters'
        {name: Sharding}) this rank's slices of it."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f'no checkpoints under {self.directory}')
        device = example_state.step.device
        loaded = torch.load(self._step_dir(step) / 'state.pt',
                            weights_only=True, map_location='cpu')
        if loaded['params'].keys() != example_state.params.keys():
            raise ValueError(
                'the checkpoint holds another model: parameter names differ '
                'from the example state'
            )
        # AdamW keeps its per-parameter step counts on the host: they stay
        # there, the moments follow the parameters.
        opt_state = dict(loaded['opt_state'])
        opt_state['state'] = {
            key: {name: value if name == 'step' else nested_to_device(value, device)
                  for name, value in entry.items()}
            for key, entry in opt_state.get('state', {}).items()
        }
        state = TrainState(
            params=nested_to_device(loaded['params'], device),
            opt_state=opt_state,
            step=loaded['step'].to(device),
        )
        if sharding is None:
            return state
        return put(state, train_state_sharding(state, sharding))

    def read_metadata(self, step: Optional[int] = None) -> Any:
        if step is None:
            step = self.latest_step()
        return json.loads((self._step_dir(step) / 'metadata.json').read_text())

    def _gc(self):
        steps = self.all_steps()
        for step in steps[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
