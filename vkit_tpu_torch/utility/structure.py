"""Dynamic config structuring: dict / JSON path / instance -> typed attrs class.

Capability parity: vkit/utility/opt.py:153-202 (``dyn_structure`` built on
cattrs GenConverter(forbid_extra_keys=True)).  cattrs is not available in this
environment, so this module implements a small recursive structurer directly on
top of ``attrs`` field introspection + ``typing`` reflection.  Semantics kept:

* accepts a mapping, a JSON file path, or an already-structured instance;
* unknown keys raise (forbid-extra-keys);
* nested attrs classes, Optional/Union, Sequence/List/Tuple/Mapping and Enum
  fields are structured recursively.
"""
import collections.abc
import functools
import json
import os
import typing
from enum import Enum
from pathlib import Path
from typing import Any, Mapping, Sequence, Type, TypeVar, Union

import attr

from .type import PathType

_T = TypeVar('_T')

NoneType = type(None)


def is_attrs_class(cls: Any) -> bool:
    return isinstance(cls, type) and attr.has(cls)


@functools.lru_cache(maxsize=None)
def _cached_type_hints(cls: type) -> Mapping[str, Any]:
    # get_type_hints re-evaluates every annotation string on each call;
    # run configs are structured once per engine invocation, so this is
    # hot (hundreds of calls per synthesized page).
    return typing.get_type_hints(cls)


def _structure_union(value: Any, args: Sequence[Any]):
    # Optional[X] and general unions: try each arm, first success wins.
    # None handled first so Optional short-circuits.
    if value is None:
        if NoneType in args:
            return None
        raise TypeError(f'None not allowed for union {args}')
    errors = []
    for arm in args:
        if arm is NoneType:
            continue
        try:
            return structure(value, arm)
        except Exception as ex:  # noqa: BLE001 - collect and re-raise below.
            errors.append(ex)
    raise TypeError(f'Cannot structure {value!r} into any of {args}: {errors}')


def structure(value: Any, cls: Type[_T]) -> _T:
    """Recursively structure ``value`` into ``cls``."""
    if cls is Any:
        return value

    origin = typing.get_origin(cls)
    args = typing.get_args(cls)

    if origin is Union:
        return _structure_union(value, args)

    if origin in (list, collections.abc.MutableSequence):
        item_cls = args[0] if args else Any
        return [structure(v, item_cls) for v in value]  # type: ignore[return-value]

    if origin is tuple:
        if not args:
            return tuple(value)  # type: ignore[return-value]
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(structure(v, args[0]) for v in value)  # type: ignore[return-value]
        if len(args) != len(value):
            raise TypeError(f'Tuple arity mismatch: {value!r} vs {args}')
        return tuple(structure(v, a) for v, a in zip(value, args))  # type: ignore[return-value]

    if origin in (dict, collections.abc.Mapping, collections.abc.MutableMapping):
        key_cls = args[0] if args else Any
        val_cls = args[1] if args else Any
        return {structure(k, key_cls): structure(v, val_cls) for k, v in value.items()}  # type: ignore[return-value]

    if origin in (set, frozenset):
        item_cls = args[0] if args else Any
        out = {structure(v, item_cls) for v in value}
        return frozenset(out) if origin is frozenset else out  # type: ignore[return-value]

    if origin in (collections.abc.Sequence, collections.abc.Iterable):
        item_cls = args[0] if args else Any
        return tuple(structure(v, item_cls) for v in value)  # type: ignore[return-value]

    if isinstance(cls, type) and issubclass(cls, Enum):
        if isinstance(value, cls):
            return value  # type: ignore[return-value]
        try:
            return cls(value)  # type: ignore[return-value]
        except ValueError:
            return cls[value]  # type: ignore[return-value]

    if is_attrs_class(cls):
        if isinstance(value, cls):
            return value
        if not isinstance(value, Mapping):
            raise TypeError(f'Expected mapping for {cls}, got {value!r}')
        fields = attr.fields(cls)
        names = {f.name for f in fields}
        extra = set(value.keys()) - names
        if extra:
            raise TypeError(f'Extra keys {sorted(extra)} for {cls.__name__}')
        hints = _cached_type_hints(cls)
        kwargs = {}
        for f in fields:
            if f.name in value:
                field_type = hints.get(f.name, f.type if f.type else Any)
                if isinstance(field_type, str):
                    field_type = Any
                kwargs[f.name] = structure(value[f.name], field_type)
        return cls(**kwargs)

    if isinstance(cls, type):
        if isinstance(value, cls):
            return value
        if cls is float and isinstance(value, int):
            return float(value)  # type: ignore[return-value]
        if cls in (int, float, str, bool, bytes):
            return cls(value)  # type: ignore[return-value]
        # Fallback: constructor call (mirrors dyn_structure's ctor fallback,
        # vkit/utility/opt.py:195-199).
        if isinstance(value, Mapping):
            return cls(**value)
        return cls(value)

    return value


def dyn_structure(
    dyn_object: Any,
    cls: Type[_T],
    support_path_type: bool = False,
    force_path_type: bool = False,
    support_none_type: bool = False,
) -> _T:
    """Structure a dict / JSON path / instance into ``cls``.

    Mirrors the contract of vkit/utility/opt.py:162-202.
    """
    if support_none_type and dyn_object is None:
        return cls()

    if support_path_type or force_path_type:
        is_pathlike = isinstance(dyn_object, (str, os.PathLike))
        if force_path_type:
            assert is_pathlike, f'Expected a path, got {dyn_object!r}'
        if is_pathlike:
            path = Path(os.path.expandvars(os.fspath(dyn_object)))
            dyn_object = json.loads(path.read_text())

    if isinstance(dyn_object, cls):
        return dyn_object
    if isinstance(dyn_object, Mapping):
        return structure(dyn_object, cls)
    raise TypeError(f'Cannot structure {dyn_object!r} into {cls}')


def read_json_file(path: PathType) -> Any:
    return json.loads(Path(os.path.expandvars(os.fspath(path))).read_text())


def get_generic_classes(cls: Type) -> typing.Tuple[Type, ...]:
    """Reflect type parameters of a Generic subclass.

    Capability parity: vkit/utility/opt.py:246-247; used by engine/pipeline
    factories to discover config/input/output classes.
    """
    bases = getattr(cls, '__orig_bases__', ())
    for base in bases:
        args = typing.get_args(base)
        if args:
            return args
    raise TypeError(f'{cls} has no generic parameters')
