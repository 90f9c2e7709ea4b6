"""Image operations (``openpano_tpu.ops``'s public names); the window
kernels are ``ops.windows``."""

from .gaussian import blur, gauss_kernel
from .imgproc import (
    INVALID,
    crop_to_largest_rect,
    hconcat,
    resize,
    rgb2grey,
    sample_bilinear,
    vconcat,
    working_size,
)

__all__ = [
    "blur", "gauss_kernel", "resize", "rgb2grey", "sample_bilinear",
    "crop_to_largest_rect", "hconcat", "vconcat", "working_size", "INVALID",
]
