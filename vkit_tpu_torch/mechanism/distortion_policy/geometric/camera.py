"""Camera policy samplers (4).

Parameter tables match the reference defaults exactly (config compat:
vkit/mechanism/distortion_policy/geometric/camera.py); sampling re-derived.
"""
import attr
import numpy as np

from ....mechanism import distortion
from ..opt import generate_grid_size, sample_float, sample_int
from ..type import policy_factory


def _sample_camera_model(knobs, level, rng) -> 'distortion.CameraModelConfig':
    rotation_theta = sample_int(level, 1, knobs.rotation_theta_max, 0.5, rng)
    theta_xy = rng.uniform(0, 2 * np.pi)
    vec = [np.cos(theta_xy), np.sin(theta_xy), 0.0]
    if level > knobs.level_1_max:
        # vec_z == 1 would degenerate to an in-plane (affine) rotation.
        vec_z = rng.uniform(0, knobs.vec_z_max)
        vec = [(1 - vec_z) * vec[0], (1 - vec_z) * vec[1], vec_z]
    return distortion.CameraModelConfig(
        rotation_unit_vec=vec, rotation_theta=rotation_theta,
    )


def _grid_size(knobs, shape) -> int:
    return generate_grid_size(knobs.grid_size_min, knobs.grid_size_ratio, shape)


def _sample_line_anchor(shape, rng):
    """Random page point + direction + out-of-plane perturb vector."""
    height, width = shape
    anchor = (int(rng.integers(0, width)), int(rng.integers(0, height)))
    direction = rng.uniform(0, 180)
    perturb_z = max(shape) / 4
    if rng.random() < 0.5:
        perturb_z = -perturb_z
    return anchor, direction, (0.0, 0.0, perturb_z)


@attr.define
class CameraPlaneOnlyConfigGeneratorConfig:
    level_1_max: int = 5
    rotation_theta_max: int = 17
    vec_z_max: float = 0.5
    grid_size_min: int = 15
    grid_size_ratio: float = 0.01


@policy_factory(distortion.camera_plane_only, CameraPlaneOnlyConfigGeneratorConfig)
def camera_plane_only_policy_factory(knobs, level, shape, rng):
    return dict(
        camera_model_config=_sample_camera_model(knobs, level, rng),
        grid_size=_grid_size(knobs, shape),
    )


@attr.define
class CameraCubicCurveConfigGeneratorConfig:
    curve_slope_range_min: float = 10.0
    curve_slope_range_max: float = 90.0
    curve_slope_max: float = 45
    level_1_max: int = 5
    rotation_theta_max: int = 17
    vec_z_max: float = 0.5
    grid_size_min: int = 15
    grid_size_ratio: float = 0.01


@policy_factory(distortion.camera_cubic_curve, CameraCubicCurveConfigGeneratorConfig)
def camera_cubic_curve_policy_factory(knobs, level, shape, rng):
    # Split a sampled slope budget between the two curve endpoints.
    budget = sample_float(level, knobs.curve_slope_range_min,
                          knobs.curve_slope_range_max, None, rng)
    split = rng.uniform()
    alpha = min(knobs.curve_slope_max, budget * split)
    beta = min(knobs.curve_slope_max, budget - budget * split)
    if rng.random() < 0.5:
        alpha = -alpha
    if rng.random() < 0.5:
        beta = -beta
    return dict(
        curve_alpha=alpha,
        curve_beta=beta,
        curve_direction=rng.uniform(0, 180),
        curve_scale=1.0,
        camera_model_config=_sample_camera_model(knobs, level, rng),
        grid_size=_grid_size(knobs, shape),
    )


@attr.define
class CameraPlaneLineFoldConfigGeneratorConfig:
    fold_alpha_min: float = 0.1
    fold_alpha_max: float = 1.25
    level_1_max: int = 5
    rotation_theta_max: int = 17
    vec_z_max: float = 0.5
    grid_size_min: int = 15
    grid_size_ratio: float = 0.01


@policy_factory(distortion.camera_plane_line_fold, CameraPlaneLineFoldConfigGeneratorConfig)
def camera_plane_line_fold_policy_factory(knobs, level, shape, rng):
    anchor, direction, perturb_vec = _sample_line_anchor(shape, rng)
    fold_alpha = sample_float(level, knobs.fold_alpha_min, knobs.fold_alpha_max,
                              None, rng, inverse_level=True)
    return dict(
        fold_point=anchor,
        fold_direction=direction,
        fold_perturb_vec=perturb_vec,
        fold_alpha=fold_alpha,
        camera_model_config=_sample_camera_model(knobs, level, rng),
        grid_size=_grid_size(knobs, shape),
    )


@attr.define
class CameraPlaneLineCurveConfigGeneratorConfig:
    curve_alpha_min: float = 1.0
    curve_alpha_max: float = 2.0
    level_1_max: int = 5
    rotation_theta_max: int = 17
    vec_z_max: float = 0.5
    grid_size_min: int = 15
    grid_size_ratio: float = 0.01


@policy_factory(distortion.camera_plane_line_curve, CameraPlaneLineCurveConfigGeneratorConfig)
def camera_plane_line_curve_policy_factory(knobs, level, shape, rng):
    anchor, direction, perturb_vec = _sample_line_anchor(shape, rng)
    curve_alpha = sample_float(level, knobs.curve_alpha_min, knobs.curve_alpha_max,
                               None, rng, inverse_level=True)
    return dict(
        curve_point=anchor,
        curve_direction=direction,
        curve_perturb_vec=perturb_vec,
        curve_alpha=curve_alpha,
        camera_model_config=_sample_camera_model(knobs, level, rng),
        grid_size=_grid_size(knobs, shape),
    )
