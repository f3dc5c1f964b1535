from .affine import (
    ShearHoriConfig, shear_hori,
    ShearVertConfig, shear_vert,
    RotateConfig, rotate,
    SkewHoriConfig, skew_hori,
    SkewVertConfig, skew_vert,
)
from .camera import (
    CameraModelConfig, PinholeCamera,
    CameraPlaneOnlyConfig, camera_plane_only,
    CameraCubicCurveConfig, camera_cubic_curve,
    CameraPlaneLineFoldConfig, camera_plane_line_fold,
    CameraPlaneLineCurveConfig, camera_plane_line_curve,
)
from .mls import SimilarityMlsConfig, similarity_mls
