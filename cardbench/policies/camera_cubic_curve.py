"""camera_cubic_curve: the page bent along a cubic and seen through a
turned pinhole camera.

``sample`` is a frozen copy of ``camera_cubic_curve_policy_factory``'s
sampler with ``_sample_camera_model``, ``_grid_size`` and the defaults of
``CameraCubicCurveConfigGeneratorConfig``
(``vkit_tpu_torch/mechanism/distortion_policy/geometric/camera.py`` at
commit 413b729).  ``geometry`` works the lattice out from the config
alone, as vkit's camera.py defines it, in plain NumPy: nodes every
``grid_size`` pixels of the page (and on its last row and column), lifted
by the cubic through 0 at both ends of the curve's direction with end
slopes tan(alpha) and tan(beta), centred on the nodes' mean height; seen
by a camera at distance max(h, w) from the principal point, with that
focal length, turned by ``rotation_theta`` degrees about
``rotation_unit_vec``; then moved so that the rounded nodes start at 0."""
import numpy as np

from cardbench.policies.common import Geometry, sample_float, sample_int

LEVEL_1_MAX = 5
CURVE_SLOPE_RANGE_MIN = 10.0
CURVE_SLOPE_RANGE_MAX = 90.0
CURVE_SLOPE_MAX = 45
ROTATION_THETA_MAX = 17
VEC_Z_MAX = 0.5
GRID_SIZE_MIN = 15
GRID_SIZE_RATIO = 0.01
# vkit clips the curve's slopes at 80 degrees and the camera's turn at 89;
# the sampler's configs stay inside both.
SLOPE_CLIP = 80
TURN_CLIP = 89


def _sample_camera_model(level, rng) -> dict:
    rotation_theta = sample_int(level, 1, ROTATION_THETA_MAX, 0.5, rng)
    theta_xy = rng.uniform(0, 2 * np.pi)
    vec = [np.cos(theta_xy), np.sin(theta_xy), 0.0]
    if level > LEVEL_1_MAX:
        vec_z = rng.uniform(0, VEC_Z_MAX)
        vec = [(1 - vec_z) * vec[0], (1 - vec_z) * vec[1], vec_z]
    return {'rotation_unit_vec': [float(v) for v in vec],
            'rotation_theta': rotation_theta}


def sample(level: int, shape, rng) -> dict:
    """One sample's config, drawn from ``rng``."""
    budget = sample_float(level, CURVE_SLOPE_RANGE_MIN,
                          CURVE_SLOPE_RANGE_MAX, rng)
    split = rng.uniform()
    alpha = min(CURVE_SLOPE_MAX, budget * split)
    beta = min(CURVE_SLOPE_MAX, budget - budget * split)
    if rng.random() < 0.5:
        alpha = -alpha
    if rng.random() < 0.5:
        beta = -beta
    return dict(
        curve_alpha=alpha,
        curve_beta=beta,
        curve_direction=rng.uniform(0, 180),
        curve_scale=1.0,
        camera_model_config=_sample_camera_model(level, rng),
        grid_size=max(GRID_SIZE_MIN, int(GRID_SIZE_RATIO * max(shape))),
    )


def _nodes(height: int, width: int, step: int) -> np.ndarray:
    """(R, C, 2) xy: every ``step`` pixels from 0, and the last pixel."""
    ys = np.unique(np.append(np.arange(0, height, step), height - 1))
    xs = np.unique(np.append(np.arange(0, width, step), width - 1))
    return np.stack(np.meshgrid(xs, ys), axis=-1).astype(np.float64)


def _turn(axis, degrees: float) -> np.ndarray:
    """The rotation by ``degrees`` about ``axis``, from its quaternion."""
    x, y, z = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    half = np.radians(degrees) / 2
    s = np.sin(half)
    w, x, y, z = np.cos(half), x * s, y * s, z * s
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def geometry(config: dict, shape) -> Geometry:
    height, width = shape
    alpha, beta = config['curve_alpha'], config['curve_beta']
    camera = config['camera_model_config']
    turn = camera['rotation_theta']
    assert max(abs(alpha), abs(beta)) <= SLOPE_CLIP and abs(turn) <= TURN_CLIP
    nodes = _nodes(height, width, config['grid_size'])
    flat = nodes.reshape(-1, 2)
    # The curve: position along its direction, 0 to 1 over the page.
    direction = np.radians(config['curve_direction'] % 180)
    along = flat @ np.asarray([np.cos(direction), np.sin(direction)])
    span = along.max() - along.min()
    t = (along - along.min()) / span
    s0, s1 = np.tan(np.radians(alpha)), np.tan(np.radians(beta))
    lift = (s0 * t * (1 - t) ** 2 + s1 * t * t * (t - 1)) * span \
        * config['curve_scale']
    lift -= lift.mean()
    # The camera: looking at the principal point (vkit puts it at
    # (h // 2, w // 2) in xy) from distance f = max(h, w).
    focal = float(max(height, width))
    anchor = np.asarray([height // 2, width // 2, 0.0])
    page = np.concatenate([flat, lift[:, None]], axis=1) - anchor
    seen = page @ _turn(camera['rotation_unit_vec'], turn).T
    seen[:, 2] += focal
    projected = focal * seen[:, :2] / seen[:, 2:3]
    projected -= np.round(projected).min(axis=0)
    corner = np.round(projected).max(axis=0).astype(np.int64)
    return Geometry(dst_shape=(int(corner[1]) + 1, int(corner[0]) + 1),
                    src_lattice=nodes,
                    dst_lattice=projected.reshape(nodes.shape),
                    grid_size=int(config['grid_size']))
