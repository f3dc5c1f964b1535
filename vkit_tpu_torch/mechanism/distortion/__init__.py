from .interface import (
    Distortion,
    DistortionConfig,
    DistortionResult,
    GeometricDistortion,
    PhotometricDistortion,
)
from .warp_plan import WarpPlan
from . import geometric, photometric
from .photometric import (
    # color
    MeanShiftConfig, mean_shift,
    ColorShiftConfig, color_shift,
    BrightnessShiftConfig, brightness_shift,
    StdShiftConfig, std_shift,
    BoundaryEqualizationConfig, boundary_equalization,
    HistogramEqualizationConfig, histogram_equalization,
    ComplementConfig, complement,
    PosterizationConfig, posterization,
    ColorBalanceConfig, color_balance,
    ChannelPermutationConfig, channel_permutation,
    # blur
    GaussianBlurConfig, gaussian_blur,
    DefocusBlurConfig, defocus_blur,
    MotionBlurConfig, motion_blur,
    GlassBlurConfig, glass_blur,
    ZoomInBlurConfig, zoom_in_blur,
    # noise
    GaussionNoiseConfig, gaussion_noise,
    PoissonNoiseConfig, poisson_noise,
    ImpulseNoiseConfig, impulse_noise,
    SpeckleNoiseConfig, speckle_noise,
    # effect
    JpegQualityConfig, jpeg_quality,
    PixelationConfig, pixelation,
    FogConfig, fog,
    # streak
    LineStreakConfig, line_streak,
    RectangleStreakConfig, rectangle_streak,
    EllipseStreakConfig, ellipse_streak,
)
from .geometric import (
    ShearHoriConfig, shear_hori,
    ShearVertConfig, shear_vert,
    RotateConfig, rotate,
    SkewHoriConfig, skew_hori,
    SkewVertConfig, skew_vert,
    CameraModelConfig,
    CameraPlaneOnlyConfig, camera_plane_only,
    CameraCubicCurveConfig, camera_cubic_curve,
    CameraPlaneLineFoldConfig, camera_plane_line_fold,
    CameraPlaneLineCurveConfig, camera_plane_line_curve,
    SimilarityMlsConfig, similarity_mls,
)
