"""Core image ops: grey conversion, resize, sentinel-aware bilinear
sampling, crop.

Counterparts of ``openpano_tpu/ops/imgproc.py`` and of the reference's
scalar loops in lib/imgproc.cc (resize_bilinear at :22-80, interpolate at
:135-156, crop at :200-235, rgb2grey at :237-249), vectorized over whole
images and coordinate grids.  The resize is the gather form
(``_resize_gather`` there); the JAX package's matmul form exists only for
the TPU's matrix unit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

INVALID = -1.0  # Color::NO sentinel


def rgb2grey(img: torch.Tensor) -> torch.Tensor:
    """Mean of channels (reference: imgproc.cc:237-249).
    [..., H, W, 3] -> [..., H, W]."""
    return (img[..., 0] + img[..., 1] + img[..., 2]) / 3.0


def working_size(w: int, h: int, target: int) -> tuple[int, int]:
    """Resize target so (w+h)/2 == SIFT_WORKING_SIZE, preserving aspect
    (reference: feature.cc:31-36: ratio = target*2/(w+h), floor dims)."""
    ratio = target * 2.0 / (w + h)
    return int(h * ratio), int(w * ratio)


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """f32 a*b + c with the one rounding of a fused multiply-add.  The
    product of two f32 values is exact in f64; its f64 sum with c may
    round, and a second rounding to f32 would then miss on ties.  So the
    sum rounds to odd: its error (TwoSum) is exact, and an inexact sum
    whose last bit is even moves one f64 ulp toward it.  With 29 bits to
    spare, the cast to f32 then rounds as the exact sum would."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _resize_coords(n_out: int, n_in: int, dev) -> torch.Tensor:
    a = torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5
    scale = torch.tensor(n_in / n_out, dtype=torch.float32, device=dev)
    return _fma(a, scale, torch.full_like(a, -0.5))


def resize(img: torch.Tensor, out_h: int, out_w: int,
           rgb: bool = False) -> torch.Tensor:
    """Bilinear resize with half-pixel centers and edge clamping, matching
    the reference's resize_bilinear (imgproc.cc:22-80).

    The source coordinates and the lerps round as fused multiply-adds, as
    XLA:CPU contracts the JAX package's expressions (``(i + 0.5) * s -
    0.5`` and each ``a * p + b * q`` as fma(a, p, b * q)); rounded apart,
    the coordinates move by an ulp of the pixel index (1.5e-5 px at x=130)
    and the resized image by up to 7e-6, enough to flip a DoG extremum
    test downstream.  The result equals the JAX package's jitted CPU
    resize bit for bit, ties included.

    img: [..., H, W] planes, or [..., H, W, C] with ``rgb=True``; leading
    dims are batched."""
    hd, wd = (-3, -2) if rgb else (-2, -1)
    h, w = img.shape[hd], img.shape[wd]
    dev = img.device
    ry = _resize_coords(out_h, h, dev)
    rx = _resize_coords(out_w, w, dev)
    sy = torch.floor(ry)
    sx = torch.floor(rx)
    fy = ry - sy
    fx = rx - sx
    fy = torch.where(sy < 0, 0.0, torch.where(sy + 1 >= h, 1.0, fy))
    fx = torch.where(sx < 0, 0.0, torch.where(sx + 1 >= w, 1.0, fx))
    sy = torch.clamp(sy, 0, h - 2).long()
    sx = torch.clamp(sx, 0, w - 2).long()
    row0 = img.index_select(hd, sy)
    row1 = img.index_select(hd, sy + 1)
    p00 = row0.index_select(wd, sx)
    p01 = row0.index_select(wd, sx + 1)
    p10 = row1.index_select(wd, sx)
    p11 = row1.index_select(wd, sx + 1)
    if rgb:
        fy = fy[:, None, None]
        fx = fx[None, :, None]
    else:
        fy = fy[:, None]
        fx = fx[None, :]
    top = _fma(1 - fx, p00, fx * p01)
    bot = _fma(1 - fx, p10, fx * p11)
    return _fma(1 - fy, top, fy * bot)


def bilinear_prologue(h: int, w: int, y: torch.Tensor, x: torch.Tensor):
    """Shared bounds/index/fraction computation for every bilinear sampler
    (they must agree on the boundary rule).  h/w are the ORIGINAL image
    dims.  Returns (inb, iy, ix, ry, rx) with ry/rx already expanded for
    channel broadcasting."""
    fy = torch.floor(y)
    fx = torch.floor(x)
    inb = (fy >= 0) & (fx >= 0) & (fy + 1 <= h - 1) & (fx + 1 <= w - 1)
    iy = torch.clamp(fy, 0, h - 2).long()
    ix = torch.clamp(fx, 0, w - 2).long()
    return inb, iy, ix, (y - fy)[..., None], (x - fx)[..., None]


def sample_bilinear(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor):
    """Sentinel-aware bilinear sampling (reference: interpolate,
    imgproc.cc:135-156).

    img: [H, W, C] float with INVALID (-1) marking empty pixels; y, x:
    broadcast-equal float sample coordinates (row, col in pixel units).
    Returns (color [..., C], valid [...]): valid is False when the sample is
    out of bounds or any of its 4 neighbors is INVALID, and invalid colors
    are INVALID (Color::NO propagation)."""
    h, w = img.shape[0], img.shape[1]
    inb, iy, ix, ry, rx = bilinear_prologue(h, w, y, x)
    p00 = img[iy, ix]
    p10 = img[iy + 1, ix]
    p01 = img[iy, ix + 1]
    p11 = img[iy + 1, ix + 1]
    ok = (p00[..., 0] >= 0) & (p10[..., 0] >= 0) & (p01[..., 0] >= 0) \
        & (p11[..., 0] >= 0)
    valid = inb & ok
    color = (
        p00 * (1 - ry) * (1 - rx)
        + p10 * ry * (1 - rx)
        + p01 * (1 - ry) * rx
        + p11 * ry * rx
    )
    return torch.where(valid[..., None], color, INVALID), valid


def largest_valid_rect(valid: np.ndarray) -> tuple[int, int, int, int]:
    """(y0, x0, h, w) of the largest all-valid axis-aligned rectangle of a
    [H, W] mask (reference: crop, imgproc.cc:200-235), by the native C DP
    (native/crop_largest_rect.c)."""
    from .._build import crop_library

    v = np.ascontiguousarray(np.asarray(valid, dtype=bool), dtype=np.uint8)
    if v.ndim != 2:
        raise ValueError(f"mask must be [H, W], got {v.shape}")
    out = np.zeros(4, np.int64)
    crop_library().largest_valid_rect(
        v.ctypes.data_as(ctypes.c_void_p), v.shape[0], v.shape[1],
        out.ctypes.data_as(ctypes.c_void_p))
    return tuple(int(a) for a in out)


def crop_with_mask(img: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Crop a host image to the largest all-valid rectangle of ``valid``."""
    y0, x0, h, w = largest_valid_rect(valid)
    if h == 0 or w == 0:
        return img[:0, :0]
    return img[y0 : y0 + h, x0 : x0 + w]


def crop_to_largest_rect(img: np.ndarray) -> np.ndarray:
    """Crop a host float image to the largest rectangle containing no
    INVALID pixel (reference: crop, imgproc.cc:200-235)."""
    img = np.asarray(img)
    return crop_with_mask(img, img.max(axis=-1) >= 0)


def hconcat(mats: list[np.ndarray]) -> np.ndarray:
    """Horizontal concat with zero padding to the tallest (imgproc.cc:86-110);
    a host-side debug helper."""
    hmax = max(m.shape[0] for m in mats)
    out = np.zeros((hmax, sum(m.shape[1] for m in mats), mats[0].shape[2]),
                   dtype=np.float32)
    x = 0
    for m in mats:
        out[: m.shape[0], x : x + m.shape[1]] = m
        x += m.shape[1]
    return out


def vconcat(mats: list[np.ndarray]) -> np.ndarray:
    """Vertical concat with zero padding to the widest (imgproc.cc:112-133);
    a host-side debug helper."""
    wmax = max(m.shape[1] for m in mats)
    out = np.zeros((sum(m.shape[0] for m in mats), wmax, mats[0].shape[2]),
                   dtype=np.float32)
    y = 0
    for m in mats:
        out[y : y + m.shape[0], : m.shape[1]] = m
        y += m.shape[0]
    return out
