"""Host-side image IO.

Counterpart of ``openpano_tpu/io/image.py``.  The reference decodes with
vendored CImg/lodepng into float RGB in [0, 1] (lib/imgio.cc:25-113), with
-1 ("Color::NO") marking invalid pixels and written out as white
(imgio.cc:98-113).  PNG goes through the repository's zlib codec
(``native/png_codec.c``, built and loaded by ``_build.png_library``); other
formats, and the PNG variants the codec skips (16-bit, interlaced), go
through PIL, imported only when such a file comes.
"""

from __future__ import annotations

import ctypes

import numpy as np

INVALID = -1.0  # Color::NO sentinel (lib/color.hh)


def _png_decode(data: bytes) -> np.ndarray | None:
    """uint8 RGB [H, W, 3] of a PNG, or None where the codec declines."""
    from .._build import png_library

    lib = png_library()
    buf = np.frombuffer(data, dtype=np.uint8)
    w, h = ctypes.c_int64(0), ctypes.c_int64(0)
    ptr = lib.png_decode_rgb8(buf.ctypes.data_as(ctypes.c_void_p), buf.size,
                              ctypes.byref(w), ctypes.byref(h))
    if not ptr:
        return None
    try:
        return np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
            shape=(h.value, w.value, 3)).copy()
    finally:
        lib.pano_free(ptr)


def _png_encode(rgb: np.ndarray) -> bytes:
    from .._build import png_library

    lib = png_library()
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    n = ctypes.c_int64(0)
    ptr = lib.png_encode_rgb8(rgb.ctypes.data_as(ctypes.c_void_p), w, h,
                              ctypes.byref(n))
    if not ptr:
        raise RuntimeError(f"PNG encode of a {w}x{h} image failed")
    try:
        return ctypes.string_at(ptr, n.value)
    finally:
        lib.pano_free(ptr)


def read_img(path: str) -> np.ndarray:
    """Decode an image file to float32 RGB in [0, 1], shape [H, W, 3]."""
    return read_img_u8(path).astype(np.float32) / 255.0


def read_img_u8(path: str) -> np.ndarray:
    """Decode an image file to uint8 RGB [H, W, 3]."""
    if path.lower().endswith(".png"):
        with open(path, "rb") as f:
            arr = _png_decode(f.read())
        if arr is not None:
            return arr
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"unsupported image {path}: shape {arr.shape}")
    return arr


def write_rgb(path: str, img: np.ndarray) -> None:
    """Encode float RGB in [0, 1] (invalid -1 pixels become white, as the
    reference writer does, imgio.cc:83-96) or uint8 RGB to a file."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.asarray(img, dtype=np.float32)
        invalid = img.min(axis=-1, keepdims=True) < 0
        img = np.where(invalid, 1.0, img)
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if path.lower().endswith(".png"):
        data = _png_encode(img)
        with open(path, "wb") as f:
            f.write(data)
        return
    from PIL import Image

    Image.fromarray(img, mode="RGB").save(path)
