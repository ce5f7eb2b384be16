"""Post-processing extensions, port of svi_tpu/extensions/: ESRGAN
upscaling, RIFE frame interpolation and smoothing, FastBlend, and the
image-quality metrics (`image_quality`, `quality_towers`)."""

from .esrgan import ESRGAN, RRDBNetConfig, esrgan_forward
from .fastblend import FastBlendSmoother, PyramidPatchMatcher
from .rife import RIFEInterpolater, RIFESmoother, ifnet_forward

__all__ = [
    "ESRGAN",
    "FastBlendSmoother",
    "PyramidPatchMatcher",
    "RRDBNetConfig",
    "esrgan_forward",
    "RIFEInterpolater",
    "RIFESmoother",
    "ifnet_forward",
]
