from .opt import (
    clip_val,
    convert_camel_case_name_to_snake_case_name,
    get_config_class_snake_case_name,
    normalize_to_keys_and_probs,
    normalize_to_probs,
    resize_val,
    rng_choice,
    rng_choice_with_size,
    rng_shuffle,
    sample_resize_interpolation,
)
from .structure import dyn_structure, get_generic_classes, is_attrs_class, read_json_file
from .type import PathType
from .profiling import StepTimer
