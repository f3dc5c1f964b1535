"""Camera-model geometric distortions: plane_only, cubic_curve,
plane_line_fold, plane_line_curve.

Each op is a planner: lift the page plane into 3-D (per-strategy z field),
project through a pinhole camera (closed-form axis-angle rotation — no
cv.Rodrigues/projectPoints), and hand the projected lattice to the shared
WarpPlan engine.  Behavioral spec:
vkit/mechanism/distortion/geometric/camera.py:58-575 (re-derived).
"""
import math
from typing import Optional, Sequence, Tuple

import attr
import numpy as np

from ..interface import DistortionConfig, GeometricDistortion
from ..warp_plan import WarpPlan, lattice_plan


@attr.define
class CameraModelConfig:
    rotation_unit_vec: Sequence[float]
    rotation_theta: float
    focal_length: Optional[float] = None
    principal_point: Optional[Sequence[float]] = None
    camera_distance: Optional[float] = None


def axis_angle_rotation(axis: np.ndarray, theta: float) -> np.ndarray:
    """Rodrigues formula, closed form."""
    x, y, z = axis
    k = np.asarray([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return np.eye(3) + math.sin(theta) * k + (1.0 - math.cos(theta)) * (k @ k)


class PinholeCamera:
    """Extrinsics are derived so the principal point (given in world
    coordinates on the page plane) lands on the optical axis at
    ``camera_distance``; intrinsics are a bare focal length."""

    def __init__(self, config: CameraModelConfig):
        assert config.focal_length and config.camera_distance and config.principal_point

        axis = np.asarray(config.rotation_unit_vec, dtype=np.float64)
        axis = axis / np.linalg.norm(axis)
        theta = math.radians(float(np.clip(config.rotation_theta, -89, 89)))
        self.rotation = axis_angle_rotation(axis, theta)

        anchor = list(config.principal_point)
        if len(anchor) == 2:
            anchor.append(0.0)
        anchor_vec = np.asarray(anchor, dtype=np.float64)

        # Solve translation t with R @ anchor + t == (0, 0, camera_distance).
        on_axis = np.asarray([0.0, 0.0, float(config.camera_distance)])
        self.translation = on_axis - self.rotation @ anchor_vec
        self.focal_length = float(config.focal_length)

    def project(self, np_3d: np.ndarray) -> np.ndarray:
        """(V, 3) world -> (V, 2) image plane."""
        cam = np_3d @ self.rotation.T + self.translation
        z = cam[:, 2:3]
        z = np.where(np.abs(z) < 1e-12, 1e-12, z)
        return self.focal_length * cam[:, :2] / z


def _fill_camera_defaults(config: CameraModelConfig,
                          shape: Tuple[int, int]) -> CameraModelConfig:
    height, width = shape
    if config.principal_point and config.focal_length and config.camera_distance:
        return config
    config = attr.evolve(config)
    if not config.principal_point:
        config.principal_point = [height // 2, width // 2]
    if not config.focal_length or not config.camera_distance:
        config.focal_length = max(height, width)
        config.camera_distance = config.focal_length
    return config


def _camera_lattice_plan(shape, grid_size, camera_model_config, z_of_xy) -> WarpPlan:
    """Shared planner: lift xy -> (xy, z), project, build the lattice plan."""
    camera = PinholeCamera(_fill_camera_defaults(camera_model_config, shape))

    def project_xy(np_xy: np.ndarray) -> np.ndarray:
        zs = z_of_xy(np_xy)
        lifted = np.concatenate([np_xy, zs.reshape(-1, 1)], axis=1)
        return camera.project(lifted)

    return lattice_plan(shape, grid_size, project_xy)


# ---------------------------------------------------------------------------
# plane_only: z == 0 everywhere (pure perspective).
# ---------------------------------------------------------------------------

@attr.define
class CameraPlaneOnlyConfig(DistortionConfig):
    camera_model_config: CameraModelConfig
    grid_size: int


def _plane_only_plan(config: CameraPlaneOnlyConfig, shape, rng) -> WarpPlan:
    return _camera_lattice_plan(
        shape, config.grid_size, config.camera_model_config,
        lambda np_xy: np.zeros(len(np_xy)),
    )


camera_plane_only = GeometricDistortion(CameraPlaneOnlyConfig, _plane_only_plan)


# ---------------------------------------------------------------------------
# cubic_curve: z follows a cubic along a projected direction.
# ---------------------------------------------------------------------------

@attr.define
class CameraCubicCurveConfig(DistortionConfig):
    curve_alpha: float
    curve_beta: float
    # Clockwise, [0, 180].
    curve_direction: float
    curve_scale: float
    camera_model_config: CameraModelConfig
    grid_size: int


def _cubic_curve_plan(config: CameraCubicCurveConfig, shape, rng) -> WarpPlan:
    height, width = shape
    slope0 = math.tan(math.radians(float(np.clip(config.curve_alpha, -80, 80))))
    slope1 = math.tan(math.radians(float(np.clip(config.curve_beta, -80, 80))))
    theta = math.radians(config.curve_direction % 180)
    # Unit direction the curve runs along.
    axis = np.asarray([math.cos(theta), math.sin(theta)])

    corners = np.asarray(
        [(0, 0), (width - 1, 0), (width - 1, height - 1), (0, height - 1)],
        dtype=np.float64,
    )
    span0 = float((corners @ axis).min())
    span = float((corners @ axis).max()) - span0

    # Cubic through (0,0) and (1,0) with endpoint slopes slope0 / slope1.
    coeffs = np.asarray([
        slope0 + slope1, -2 * slope0 - slope1, slope0, 0.0,
    ])

    def z_of_xy(np_xy: np.ndarray) -> np.ndarray:
        t = (np_xy @ axis - span0) / span
        zs = np.polyval(coeffs, t) * span * config.curve_scale
        return zs - zs.mean()

    return _camera_lattice_plan(
        shape, config.grid_size, config.camera_model_config, z_of_xy
    )


camera_cubic_curve = GeometricDistortion(CameraCubicCurveConfig, _cubic_curve_plan)


# ---------------------------------------------------------------------------
# plane_line_fold / plane_line_curve: perturb along a 3-D vector, weighted by
# (normalized) distance to a line through `point` at `direction`.
# ---------------------------------------------------------------------------

def _line_weighted_plan(shape, grid_size, camera_model_config, point, direction,
                        perturb_vec, weight_of) -> WarpPlan:
    height, width = shape
    theta = math.radians(direction % 180)
    normal = np.asarray([math.sin(theta), -math.cos(theta)])
    offset = -float(np.asarray(point, dtype=np.float64) @ normal)
    diag = math.hypot(height, width)
    perturb = np.asarray(perturb_vec, dtype=np.float64)

    camera = PinholeCamera(_fill_camera_defaults(camera_model_config, shape))

    def project_xy(np_xy: np.ndarray) -> np.ndarray:
        distances = np.abs(np_xy @ normal + offset) / diag
        weights = weight_of(distances)
        lifted = np.concatenate(
            [np_xy, np.zeros((len(np_xy), 1))], axis=1
        )
        shifts = weights[:, None] * perturb
        shifts -= shifts.mean(axis=0)
        return camera.project(lifted + shifts)

    return lattice_plan(shape, grid_size, project_xy)


@attr.define
class CameraPlaneLineFoldConfig(DistortionConfig):
    fold_point: Tuple[float, float]
    # Clockwise, [0, 180].
    fold_direction: float
    fold_perturb_vec: Tuple[float, float, float]
    fold_alpha: float
    camera_model_config: CameraModelConfig
    grid_size: int


def _plane_line_fold_plan(config: CameraPlaneLineFoldConfig, shape, rng) -> WarpPlan:
    alpha = config.fold_alpha
    return _line_weighted_plan(
        shape, config.grid_size, config.camera_model_config,
        config.fold_point, config.fold_direction, config.fold_perturb_vec,
        lambda d: alpha / (d + alpha),
    )


camera_plane_line_fold = GeometricDistortion(
    CameraPlaneLineFoldConfig, _plane_line_fold_plan
)


@attr.define
class CameraPlaneLineCurveConfig(DistortionConfig):
    curve_point: Tuple[float, float]
    # Clockwise, [0, 180].
    curve_direction: float
    curve_perturb_vec: Tuple[float, float, float]
    curve_alpha: float
    camera_model_config: CameraModelConfig
    grid_size: int


def _plane_line_curve_plan(config: CameraPlaneLineCurveConfig, shape, rng) -> WarpPlan:
    alpha = config.curve_alpha
    return _line_weighted_plan(
        shape, config.grid_size, config.camera_model_config,
        config.curve_point, config.curve_direction, config.curve_perturb_vec,
        lambda d: 1.0 - d**alpha,
    )


camera_plane_line_curve = GeometricDistortion(
    CameraPlaneLineCurveConfig, _plane_line_curve_plan
)
