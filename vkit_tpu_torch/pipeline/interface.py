"""Pipeline framework: typed state store + auto-wired step DAG.

Each step's output lands in the state under its snake-cased class name; the
next step's input attrs class is assembled by resolving every field's
annotated type from the state.  Behavioral spec:
vkit/pipeline/interface.py:46-254 (re-derived; per-class reflection is done
once and cached, and wiring lives in one resolver function).
"""
import os
import typing
from typing import (
    Any,
    Dict,
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
    convert_camel_case_name_to_snake_case_name,
    dyn_structure,
    get_generic_classes,
    read_json_file,
)

_T_VALUE = TypeVar('_T_VALUE')
_T_CONFIG = TypeVar('_T_CONFIG')
_T_INPUT = TypeVar('_T_INPUT')
_T_OUTPUT = TypeVar('_T_OUTPUT')


def _state_key(cls: type) -> str:
    return convert_camel_case_name_to_snake_case_name(cls.__name__)


@attr.define
class PipelineState:
    key_to_value: Dict[str, Any] = attr.field(factory=dict)

    def get_value(self, key: str, value_cls: Type[_T_VALUE]) -> _T_VALUE:
        try:
            value = self.key_to_value[key]
        except KeyError:
            raise KeyError(f'state has no {key!r}') from None
        if not isinstance(value, value_cls):
            raise TypeError(
                f'{key!r} holds a {type(value).__name__}, not {value_cls.__name__}'
            )
        return value

    def set_value(self, key: str, value: Any, override: bool = False) -> None:
        if not override and key in self.key_to_value:
            raise KeyError(f'{key!r} already set (pass override=True to replace)')
        self.key_to_value[key] = value

    def store_output(self, output: Any) -> None:
        self.set_value(_state_key(type(output)), output)

    def assemble(self, input_cls: Type[_T_INPUT]) -> _T_INPUT:
        """Auto-wire: each field resolves by its annotated type."""
        assert attr.has(input_cls)
        hints = typing.get_type_hints(input_cls)
        kwargs = {
            field.name: self.get_value(
                _state_key(hints[field.name]), hints[field.name]
            )
            for field in attr.fields(input_cls)
        }
        return input_cls(**kwargs)


class _Reflected:
    """Shared (config, input, output) generic-parameter reflection."""

    _generic_args: Optional[Tuple[type, ...]] = None

    @classmethod
    def _args(cls) -> Tuple[type, ...]:
        if cls.__dict__.get('_generic_args') is None:
            cls._generic_args = tuple(get_generic_classes(cls))
        assert cls._generic_args is not None
        return cls._generic_args

    @classmethod
    def get_config_cls(cls) -> type:
        return cls._args()[0]

    @classmethod
    def get_input_cls(cls) -> type:
        return cls._args()[1]

    @classmethod
    def get_output_cls(cls) -> type:
        return cls._args()[2]


class PipelineStep(_Reflected, Generic[_T_CONFIG, _T_INPUT, _T_OUTPUT]):

    @classmethod
    def get_name(cls) -> str:
        return convert_camel_case_name_to_snake_case_name(cls.__name__)

    def __init__(self, config: _T_CONFIG):
        self.config = config

    def run(self, input: _T_INPUT, rng: RandomGenerator) -> _T_OUTPUT:
        raise NotImplementedError()


def _structure_config(config, config_cls):
    return dyn_structure(
        config, config_cls, support_path_type=True, support_none_type=True
    )


class PipelineStepFactory(Generic[_T_CONFIG, _T_INPUT, _T_OUTPUT]):

    def __init__(self, pipeline_step_cls: Type[PipelineStep]):
        self.pipeline_step_cls = pipeline_step_cls

    @property
    def name(self) -> str:
        return self.pipeline_step_cls.get_name()

    def get_config_cls(self) -> type:
        return self.pipeline_step_cls.get_config_cls()

    def create(self, config=None) -> PipelineStep:
        return self.pipeline_step_cls(
            _structure_config(config, self.get_config_cls())
        )


class PipelineStepCollectionFactory:
    """Registry keyed '<namespace>.<step_name>', built from JSON lists."""

    def __init__(self):
        self.name_to_step_factory: Dict[str, PipelineStepFactory] = {}

    def register_step_factories(
        self,
        namespace: str,
        step_factories: Sequence[PipelineStepFactory],
    ) -> None:
        for factory in step_factories:
            key = f'{namespace}.{factory.name}'
            assert key not in self.name_to_step_factory
            self.name_to_step_factory[key] = factory

    def create(
        self,
        step_configs: Union[Sequence[Mapping[str, Any]], PathType],
    ) -> List[PipelineStep]:
        if isinstance(step_configs, (str, os.PathLike)):
            step_configs = read_json_file(step_configs)
        steps: List[PipelineStep] = []
        for entry in step_configs:
            name = entry['name']
            if name not in self.name_to_step_factory:
                raise KeyError(f'unknown pipeline step {name!r}')
            steps.append(
                self.name_to_step_factory[name].create(entry.get('config'))
            )
        return steps


class PipelinePostProcessor(_Reflected, Generic[_T_CONFIG, _T_INPUT, _T_OUTPUT]):

    def __init__(self, config: _T_CONFIG):
        self.config = config

    def generate_output(self, input: _T_INPUT, rng: RandomGenerator) -> _T_OUTPUT:
        raise NotImplementedError()


class PipelinePostProcessorFactory(Generic[_T_CONFIG, _T_INPUT, _T_OUTPUT]):

    def __init__(self, pipeline_post_processor_cls: Type[PipelinePostProcessor]):
        self.pipeline_post_processor_cls = pipeline_post_processor_cls

    def get_config_cls(self) -> type:
        return self.pipeline_post_processor_cls.get_config_cls()

    def create(self, config=None) -> PipelinePostProcessor:
        return self.pipeline_post_processor_cls(
            _structure_config(config, self.get_config_cls())
        )


@attr.define
class PipelineRunRngStateOutput:
    rng_state: Mapping[str, Any]


class Pipeline(Generic[_T_OUTPUT]):

    def __init__(self, steps: Sequence[PipelineStep],
                 post_processor: PipelinePostProcessor):
        self.steps = steps
        self.post_processor = post_processor

    # Back-compat alias for the classmethod form.
    @classmethod
    def build_input(cls, state: PipelineState, input_cls):
        return state.assemble(input_cls)

    def run(self, rng: RandomGenerator,
            state: Optional[PipelineState] = None) -> _T_OUTPUT:
        state = state if state is not None else PipelineState()

        # Reproducibility capture: the run's rng state is itself an output.
        state.store_output(PipelineRunRngStateOutput(rng.bit_generator.state))

        for step in self.steps:
            output = step.run(state.assemble(step.get_input_cls()), rng)
            assert isinstance(output, step.get_output_cls())
            state.store_output(output)

        return self.post_processor.generate_output(
            state.assemble(self.post_processor.get_input_cls()), rng
        )
