"""Image IO (``openpano_tpu.io``'s public names); the transport is
``io.wirecodec`` and ``io.transfer``, the stage artifacts
``io.artifacts``."""

from .image import INVALID, read_img, write_rgb

__all__ = ["read_img", "write_rgb", "INVALID"]
