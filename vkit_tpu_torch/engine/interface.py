"""Engine framework: pluggable generators + weighted aggregation.

An Engine is a generator parameterized by (init_config, init_resource) and
driven per call by a run_config.  Aggregators pick one of several engines by
weight for each run, with a pluggable collate hook for multi-engine outputs.
Public JSON surface: ``[{type, weight, config}]`` lists.

Behavioral spec: vkit/engine/interface.py:59-411 (re-derived: the
executor/selector indirection is collapsed — an aggregator selects engines
directly, and config classes are reflected once per engine class and
cached).
"""
import itertools
import os
from typing import (
    Any,
    Callable,
    Generic,
    List,
    Mapping,
    Optional,
    Sequence,
    Tuple,
    Type,
    TypeVar,
    Union,
)

import attr
from numpy.random import Generator as RandomGenerator

from ..utility import (
    PathType,
    dyn_structure,
    get_generic_classes,
    normalize_to_keys_and_probs,
    read_json_file,
    rng_choice,
)

_T_INIT_CONFIG = TypeVar('_T_INIT_CONFIG')
_T_INIT_RESOURCE = TypeVar('_T_INIT_RESOURCE')
_T_RUN_CONFIG = TypeVar('_T_RUN_CONFIG')
_T_RUN_OUTPUT = TypeVar('_T_RUN_OUTPUT')


@attr.define
class NoneTypeEngineInitConfig:
    pass


@attr.define
class NoneTypeEngineInitResource:
    pass


def _maybe_load_json(obj):
    if isinstance(obj, (str, os.PathLike)):
        return read_json_file(obj)
    return obj


class Engine(Generic[_T_INIT_CONFIG, _T_INIT_RESOURCE, _T_RUN_CONFIG, _T_RUN_OUTPUT]):

    # Cached (init_config_cls, init_resource_cls, run_config_cls, output_cls).
    _reflected: Optional[Tuple[type, ...]] = None

    @classmethod
    def get_type_name(cls) -> str:
        raise NotImplementedError()

    @classmethod
    def _config_classes(cls) -> Tuple[type, ...]:
        if cls.__dict__.get('_reflected') is None:
            cls._reflected = tuple(get_generic_classes(cls))
        assert cls._reflected is not None
        return cls._reflected

    @classmethod
    def init_config_cls(cls) -> type:
        return cls._config_classes()[0]

    @classmethod
    def init_resource_cls(cls) -> type:
        return cls._config_classes()[1]

    @classmethod
    def run_config_cls(cls) -> type:
        return cls._config_classes()[2]

    def __init__(self, init_config: _T_INIT_CONFIG,
                 init_resource: Optional[_T_INIT_RESOURCE] = None):
        self.init_config = init_config
        self.init_resource = init_resource

    @classmethod
    def create(cls, init_config=None, init_resource=None) -> 'Engine':
        """Structure raw configs (dict / JSON path / instance) and build."""
        init_config = dyn_structure(
            init_config, cls.init_config_cls(),
            support_path_type=True, support_none_type=True,
        )
        resource_cls = cls.init_resource_cls()
        if resource_cls is NoneTypeEngineInitResource:
            assert init_resource is None
        else:
            assert init_resource is not None
            init_resource = dyn_structure(init_resource, resource_cls)
        return cls(init_config, init_resource)

    def run(self, run_config: _T_RUN_CONFIG,
            rng: Optional[RandomGenerator] = None) -> _T_RUN_OUTPUT:
        raise NotImplementedError()


class EngineExecutor(
    Generic[_T_INIT_CONFIG, _T_INIT_RESOURCE, _T_RUN_CONFIG, _T_RUN_OUTPUT]
):
    """Structures loose run configs before dispatching to the engine."""

    def __init__(self, engine: Engine):
        self.engine = engine

    def get_run_config_cls(self) -> type:
        return type(self.engine).run_config_cls()

    def run(self, run_config, rng: Optional[RandomGenerator] = None):
        return self.engine.run(
            dyn_structure(run_config, self.get_run_config_cls()), rng
        )


class EngineExecutorFactory(
    Generic[_T_INIT_CONFIG, _T_INIT_RESOURCE, _T_RUN_CONFIG, _T_RUN_OUTPUT]
):

    def __init__(self, engine_cls: Type[Engine]):
        self.engine_cls = engine_cls

    def get_type_name(self) -> str:
        return self.engine_cls.get_type_name()

    def get_init_resource_cls(self) -> type:
        return self.engine_cls.init_resource_cls()

    def create(self, init_config=None, init_resource=None) -> EngineExecutor:
        return EngineExecutor(self.engine_cls.create(init_config, init_resource))


class EngineExecutorAggregator(Generic[_T_RUN_CONFIG, _T_RUN_OUTPUT]):
    """Weighted random selection among executors, with a collate hook.

    ``func_collate(aggregator, run_config, rng)`` may select more than one
    engine (e.g. the char-sampler concatenating loop); the default picks
    exactly one.
    """

    def __init__(self, pairs: Sequence[Tuple[EngineExecutor, float]],
                 func_collate: Optional[Callable] = None):
        self.engine_executors, self.probs = normalize_to_keys_and_probs(pairs)
        self.func_collate = func_collate

    def get_run_config_cls(self) -> type:
        return self.engine_executors[0].get_run_config_cls()

    def select_engine_executor(self, rng: RandomGenerator) -> EngineExecutor:
        return rng_choice(rng, self.engine_executors, probs=self.probs)

    def run(self, run_config, rng: RandomGenerator):
        run_config = dyn_structure(run_config, self.get_run_config_cls())
        if self.func_collate is not None:
            return self.func_collate(self, run_config, rng)
        return self.select_engine_executor(rng).run(run_config, rng)

    # Back-compat: some call sites reach for .selector.engine_executors.
    @property
    def selector(self) -> 'EngineExecutorAggregator':
        return self


class EngineExecutorAggregatorFactory(Generic[_T_RUN_CONFIG, _T_RUN_OUTPUT]):
    """Builds aggregators from ``[{type, weight, config}]`` JSON lists."""

    def __init__(self, engine_executor_factories: Sequence[EngineExecutorFactory],
                 func_collate: Optional[Callable] = None):
        self.factories_by_type = {
            factory.get_type_name(): factory
            for factory in engine_executor_factories
        }
        self.func_collate = func_collate

    def _build_one(self, entry: Mapping[str, Any], init_resource,
                   single: bool) -> Tuple[EngineExecutor, float]:
        type_name = entry['type']
        if type_name not in self.factories_by_type:
            raise KeyError(f'unknown engine type {type_name!r}')
        factory = self.factories_by_type[type_name]

        if factory.get_init_resource_cls() is NoneTypeEngineInitResource:
            assert init_resource is None
        else:
            assert init_resource is not None

        executor = factory.create(entry.get('config', {}), init_resource)
        return executor, (1.0 if single else entry['weight'])

    def create(
        self,
        factory_init_configs: Union[Sequence[Mapping[str, Any]], PathType],
        init_resources: Optional[Sequence[Any]] = None,
    ) -> EngineExecutorAggregator:
        entries = _maybe_load_json(factory_init_configs)
        single = len(entries) == 1
        pairs: List[Tuple[EngineExecutor, float]] = []
        for entry, init_resource in zip(
            entries, init_resources or itertools.repeat(None)
        ):
            pairs.append(self._build_one(entry, init_resource, single))
        return EngineExecutorAggregator(pairs, func_collate=self.func_collate)

    def create_with_repeated_init_resource(
        self,
        factory_init_configs: Union[Sequence[Mapping[str, Any]], PathType],
        init_resource: Any,
    ) -> EngineExecutorAggregator:
        entries = _maybe_load_json(factory_init_configs)
        return self.create(entries, [init_resource] * len(entries))

    def create_engine_executor(
        self,
        factory_init_config: Mapping[str, Any],
        init_resource: Optional[Any] = None,
    ) -> EngineExecutor:
        executor, _ = self._build_one(
            factory_init_config, init_resource, single=True
        )
        return executor
