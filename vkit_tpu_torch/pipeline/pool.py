"""Pipeline generation pool: retry-on-exception workers over the backpressure
pump.

Behavioral spec: vkit/pipeline/pool.py:27-124 (re-derived).  Two process
modes:

* ``pipeline_factory`` given — workers run under the **spawn** start method
  and each constructs its own Pipeline.  This is the JAX-safe mode: forking
  a process after JAX initializes its thread pools can deadlock the child.
* ``pipeline`` given without a factory — workers close over the parent's
  Pipeline and must **fork** (closures don't pickle).  Only safe before any
  JAX initialization; prefer the factory form.

Port of vkit_tpu/pipeline/pool.py.  The runner retries what a new draw can
change, as the reference does, and raises a device error
(``convert.is_device_error``) at once; the pool passes it to the caller of
``run()``.  A pool that would fork a parent that has initialised CUDA
raises before any worker starts (utility/pool.py).
"""
import logging
from typing import Callable, Generic, Optional, TypeVar

import numpy as np
from numpy.random import Generator as RandomGenerator

from ..convert import is_device_error
from ..utility import Pool, PoolConfig
from .interface import Pipeline

logger = logging.getLogger(__name__)

_T_OUTPUT = TypeVar('_T_OUTPUT')


class PipelineRunner:
    """Picklable per-worker loop: build (or adopt) a pipeline, run with
    retry-on-exception and periodic rng stream resets."""

    def __init__(self, pipeline: Optional[Pipeline] = None,
                 pipeline_factory: Optional[Callable[[], Pipeline]] = None,
                 rng_seed: int = 0,
                 num_runs_reset_rng: Optional[int] = None):
        assert (pipeline is None) != (pipeline_factory is None)
        self._pipeline = pipeline
        self._factory = pipeline_factory
        self._rng_seed = rng_seed
        self._reset_every = num_runs_reset_rng
        self._runs_by_worker: dict = {}

    def pipeline_for(self, worker_idx: int) -> Pipeline:
        if self._pipeline is None:
            assert self._factory is not None
            self._pipeline = self._factory()
        return self._pipeline

    def __call__(self, worker_idx: int, rng: RandomGenerator, _config):
        pipeline = self.pipeline_for(worker_idx)

        # Retry with a forcibly advanced rng so a deterministic failure
        # cannot loop forever.
        while True:
            state_before = rng.bit_generator.state
            try:
                output = pipeline.run(rng)
                break
            except Exception as error:
                if is_device_error(error):
                    raise
                logger.exception(
                    f'pipeline.run failed in worker {worker_idx} '
                    f'(rng_state={state_before}); retrying'
                )
                if rng.bit_generator.state == state_before:
                    rng.random()

        runs = self._runs_by_worker.get(worker_idx, 0) + 1
        self._runs_by_worker[worker_idx] = runs
        if self._reset_every and runs % self._reset_every == 0:
            # Periodic stream reset keeps replay windows bounded.
            rng.bit_generator.state = np.random.default_rng(
                self._rng_seed + worker_idx
            ).bit_generator.state
        return output


class PipelinePool(Generic[_T_OUTPUT]):

    def __init__(
        self,
        pipeline: Optional[Pipeline] = None,
        inventory: int = 4,
        num_processes: int = 1,
        rng_seed: int = 1337,
        num_runs_reset_rng: Optional[int] = None,
        timeout: int = 60,
        use_processes: bool = True,
        pipeline_factory: Optional[Callable[[], Pipeline]] = None,
    ):
        runner = PipelineRunner(
            pipeline=pipeline,
            pipeline_factory=pipeline_factory,
            rng_seed=rng_seed,
            num_runs_reset_rng=num_runs_reset_rng,
        )
        # Spawn whenever the worker is picklable (factory form): forking a
        # JAX-initialized parent risks deadlock in the child.
        start_method = 'spawn' if pipeline_factory is not None else 'fork'
        self.pool: Pool[_T_OUTPUT] = Pool(
            config=PoolConfig(
                inventory=inventory,
                num_processes=num_processes,
                rng_seed=rng_seed,
                timeout=timeout,
                use_processes=use_processes,
                mp_start_method=start_method,
            ),
            func=runner,
        )

    def run(self) -> _T_OUTPUT:
        return self.pool.run()

    def cleanup(self):
        self.pool.cleanup()
