from .base import OutOfBoundBehavior
from .color import (
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
)
from .blur import (
    GaussianBlurConfig, gaussian_blur,
    DefocusBlurConfig, defocus_blur,
    MotionBlurConfig, motion_blur,
    GlassBlurConfig, glass_blur,
    ZoomInBlurConfig, zoom_in_blur,
)
from .noise import (
    GaussionNoiseConfig, gaussion_noise,
    PoissonNoiseConfig, poisson_noise,
    ImpulseNoiseConfig, impulse_noise,
    SpeckleNoiseConfig, speckle_noise,
)
from .effect import (
    JpegQualityConfig, jpeg_quality,
    PixelationConfig, pixelation,
    FogConfig, fog,
)
from .streak import (
    LineStreakConfig, line_streak,
    RectangleStreakConfig, rectangle_streak,
    EllipseStreakConfig, ellipse_streak,
)
