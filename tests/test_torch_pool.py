"""The port's pools (vkit_tpu_torch/utility/pool.py and
vkit_tpu_torch/pipeline/pool.py): the twins of tests/utility/test_pool.py
(thread and spawn process modes, retry with an advanced rng, PipelinePool
in both forms), and the two rules the port adds for the card:

  - a device error (``convert.is_device_error``) reaches the caller of
    ``run()`` and is not retried, in a thread, a spawned process, or
    PipelineRunner;
  - a pool that would fork a parent that has initialised CUDA raises
    before any worker starts.

This module imports neither jax nor vkit_tpu, so spawned workers that
import it start quickly.
"""
import multiprocessing

import attr
import numpy as np
import pytest
import torch

from vkit_tpu_torch import convert
from vkit_tpu_torch.pipeline import (
    Pipeline,
    PipelinePool,
    PipelinePostProcessor,
    PipelinePostProcessorFactory,
    PipelineStep,
    PipelineStepFactory,
)
from vkit_tpu_torch.pipeline.pool import PipelineRunner
from vkit_tpu_torch.utility import Pool, PoolConfig


def _produce(worker_idx, rng, config):
    return (worker_idx, float(rng.random()))


def _flaky(worker_idx, rng, config):
    value = float(rng.random())
    if value < 0.5:
        raise RuntimeError('flaky')
    return value


def _device_fault(worker_idx, rng, config):
    rng.random()
    raise convert.DeviceError('kernel launch failed with cudaError 700')


# --- a one-step pipeline, module-level so that spawned workers build it ---


@attr.define
class TinyStepConfig:
    hi: int = 1000
    fail_below: int = 0
    # The first runs of the step that meet a device fault.
    device_faults: int = 0


@attr.define
class TinyStepInput:
    pass


@attr.define
class TinyStepOutput:
    value: int


class TinyStep(PipelineStep[TinyStepConfig, TinyStepInput, TinyStepOutput]):

    def __init__(self, config: TinyStepConfig):
        super().__init__(config)
        self.runs = 0

    def run(self, input: TinyStepInput, rng):
        value = int(rng.integers(0, self.config.hi))
        self.runs += 1
        if self.runs <= self.config.device_faults:
            convert.resolve_device('cuda')
            raise convert.DeviceError('no card was asked for, yet one is')
        assert value >= self.config.fail_below, 'a draw to retry'
        return TinyStepOutput(value=value)


@attr.define
class TinyOutConfig:
    pass


@attr.define
class TinyOutInput:
    tiny_step_output: TinyStepOutput


class TinyOutProcessor(PipelinePostProcessor[TinyOutConfig, TinyOutInput,
                                             int]):

    def generate_output(self, input: TinyOutInput, rng):
        return input.tiny_step_output.value


def build_tiny_pipeline(**config) -> Pipeline:
    return Pipeline(
        steps=[PipelineStepFactory(TinyStep).create(config)],
        post_processor=PipelinePostProcessorFactory(TinyOutProcessor).create(),
    )


def build_faulty_pipeline(device_faults: int = 10**9) -> Pipeline:
    return build_tiny_pipeline(device_faults=device_faults)


# --- twins of tests/utility/test_pool.py ---------------------------------


def test_thread_pool_produces_and_cleans_up():
    pool = Pool(
        PoolConfig(inventory=4, num_processes=2, rng_seed=11, timeout=10),
        _produce,
    )
    items = [pool.run() for _ in range(8)]
    assert len(items) == 8
    assert {idx for idx, _ in items} <= {0, 1}
    pool.cleanup()
    assert not pool.workers


def test_process_pool_produces_and_cleans_up():
    pool = Pool(
        PoolConfig(inventory=4, num_processes=2, rng_seed=11, timeout=120,
                   use_processes=True),
        _produce,
    )
    items = [pool.run() for _ in range(8)]
    assert len(items) == 8
    assert {idx for idx, _ in items} <= {0, 1}
    pool.cleanup()
    assert not pool.workers


def test_pool_retries_on_exception():
    pool = Pool(
        PoolConfig(inventory=2, num_processes=1, rng_seed=0, timeout=30),
        _flaky,
    )
    values = [pool.run() for _ in range(4)]
    pool.cleanup()
    assert all(v >= 0.5 for v in values)
    # The draws the worker made: each failure advanced the rng once more.
    rng = np.random.default_rng(np.random.SeedSequence(0).spawn(1)[0])
    expected = []
    while len(expected) < 4:
        value = float(rng.random())
        if value < 0.5:
            rng.random()
        else:
            expected.append(value)
    assert values == expected


def test_pipeline_pool_threads():
    pool = PipelinePool(build_tiny_pipeline(hi=100), inventory=4,
                        num_processes=2, rng_seed=7, timeout=30,
                        use_processes=False)
    values = [pool.run() for _ in range(10)]
    pool.cleanup()
    assert len(values) == 10 and all(0 <= v < 100 for v in values)
    assert len(set(values)) > 1


def test_pipeline_pool_spawn():
    pool = PipelinePool(pipeline_factory=build_tiny_pipeline, inventory=4,
                        num_processes=2, rng_seed=3, timeout=120)
    try:
        values = [pool.run() for _ in range(6)]
    finally:
        pool.cleanup()
    assert len(values) == 6 and all(0 <= v < 1000 for v in values)


def test_pipeline_runner_retries_what_a_new_draw_can_change():
    """As the reference: an error of a draw is retried with the rng moved
    on, and the output is the first run that passes."""
    runner = PipelineRunner(pipeline=build_tiny_pipeline(fail_below=900))
    rng = np.random.default_rng(5)
    value = runner(0, rng, None)
    assert value >= 900
    replay = np.random.default_rng(5)
    while int(replay.integers(0, 1000)) < 900:
        pass
    assert rng.bit_generator.state == replay.bit_generator.state


# --- device errors reach run()'s caller ----------------------------------


def test_device_errors_are_told_apart():
    assert convert.is_device_error(convert.DeviceError('nvcc failed'))
    assert convert.is_device_error(
        RuntimeError('CUDA error: an illegal memory access was encountered'))
    assert convert.is_device_error(RuntimeError(
        'Cannot re-initialize CUDA in forked subprocess.'))
    assert convert.is_device_error(
        torch.cuda.OutOfMemoryError('CUDA out of memory.'))
    assert not convert.is_device_error(AssertionError(
        'warp too close to a 90-degree rotation for this decomposition'))
    assert not convert.is_device_error(RuntimeError('flaky'))
    assert not convert.is_device_error(ValueError('CUDA'))


@pytest.mark.parametrize('use_processes', [False, True])
def test_pool_passes_a_device_error_to_run(use_processes):
    pool = Pool(
        PoolConfig(inventory=2, num_processes=1, rng_seed=0, timeout=120,
                   use_processes=use_processes),
        _device_fault,
    )
    try:
        with pytest.raises(convert.DeviceError, match='cudaError 700') as err:
            pool.run()
    finally:
        pool.cleanup()
    assert 'raised in pool worker 0' in ''.join(err.value.__notes__)


def test_pipeline_runner_raises_a_device_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    # Only the first run meets the fault: a runner that retried it would
    # return the second run's value.
    runner = PipelineRunner(pipeline=build_faulty_pipeline(device_faults=1))
    rng = np.random.default_rng(0)
    with pytest.raises(convert.DeviceError, match='CUDA is not available'):
        runner(0, rng, None)
    # One attempt: one draw, no retry.
    replay = np.random.default_rng(0)
    replay.integers(0, 1000)
    assert rng.bit_generator.state == replay.bit_generator.state


@pytest.mark.parametrize('form', ['threads', 'spawn'])
def test_pipeline_pool_passes_a_device_error_to_run(form, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    if form == 'threads':
        pool = PipelinePool(build_faulty_pipeline(), num_processes=2,
                            timeout=30, use_processes=False)
    else:
        # The patch does not reach a spawned worker: without a card
        # resolve_device raises there, with one the step raises itself.
        # Either way the error crosses the process boundary.
        pool = PipelinePool(pipeline_factory=build_faulty_pipeline,
                            num_processes=1, timeout=120)
    try:
        with pytest.raises(convert.DeviceError):
            pool.run()
    finally:
        pool.cleanup()


# --- no fork under a CUDA parent -----------------------------------------


def test_no_fork_under_an_initialised_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_initialized', lambda: True)
    before = multiprocessing.active_children()
    with pytest.raises(RuntimeError, match='cannot use CUDA'):
        Pool(PoolConfig(inventory=2, num_processes=2, use_processes=True,
                        mp_start_method='fork'), _produce)
    with pytest.raises(RuntimeError, match='cannot use CUDA'):
        # A built pipeline and processes: the reference forks.
        PipelinePool(build_tiny_pipeline(), num_processes=2)
    assert multiprocessing.active_children() == before
    # Threads and spawn stay allowed.
    pool = PipelinePool(build_tiny_pipeline(), num_processes=1, timeout=30,
                        use_processes=False)
    assert 0 <= pool.run() < 1000
    pool.cleanup()
