"""Cylindrical pre-warp (CYLINDER mode).

Reference: stitch/warp.{hh,cc}; counterpart of ``openpano_tpu/stitch/warp.py``.
The projector maps source pixel p to
``(atan((x-cx)/r), (y-cy)/hypot(x-cx, r))`` scaled by ``sizefactor`` (= r),
with radius ``r = int(hypot(w,h) * FOCAL_LENGTH / 43.266)`` (35mm-diagonal;
warp.cc:70-75) and center ``(w//2, (h//2)*h_factor, r)``.  Image warping is
inverse mapping through ``proj_r`` + bilinear (warp.cc:25-44).

The projected bbox is closed-form on the host (the reference scans every
pixel, warp.cc:49-53; the extrema lie on the borders and the x=cx column),
keypoint warping is one elementwise map, and an image warp is one inverse
map shared by every image of a stack plus one bilinear gather per image.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..ops.imgproc import INVALID, sample_bilinear


class CylinderProjector(NamedTuple):
    """Per-image cylinder projection parameters (all Python floats; the
    projector for image k depends only on its shape and h_factor)."""

    r: float       # integer-truncated radius (reference keeps int, warp.cc:71)
    cx: float      # w // 2
    cy: float      # (h // 2) * h_factor
    sizefactor: float  # == r
    # projected-bbox offset and warped size (host-computed)
    offset_x: float
    offset_y: float
    out_w: int
    out_h: int


def make_projector(w: int, h: int, h_factor: float, cfg: Config) -> CylinderProjector:
    r = float(int(math.hypot(w, h) * (cfg.FOCAL_LENGTH / 43.266)))
    cx = float(w // 2)
    cy = float(h // 2) * h_factor

    # closed-form bbox of proj over the pixel grid [0,w) x [0,h): x-extremes
    # at j=0 / j=w-1 (atan monotonic); y-extremes on the top/bottom rows, at
    # j as close to cx as possible (hypot minimal) for the larger |dy| side
    # and at the row corners for the smaller side
    xs = np.array([0.0, w - 1.0])
    px = np.arctan((xs - cx) / r)
    min_x, max_x = px.min() * r, px.max() * r

    jcands = np.array([0.0, np.clip(cx, 0, w - 1.0), w - 1.0])
    ys = np.array([0.0, h - 1.0])
    py = (ys[:, None] - cy) / np.hypot(jcands[None, :] - cx, r)
    min_y, max_y = py.min() * r, py.max() * r

    offset_x, offset_y = float(-min_x), float(-min_y)
    return CylinderProjector(
        r=r, cx=cx, cy=cy, sizefactor=r,
        offset_x=offset_x, offset_y=offset_y,
        out_w=int(max_x - min_x), out_h=int(max_y - min_y),
    )


def warp_keypoints(proj: CylinderProjector, pts: torch.Tensor, w: int,
                   h: int) -> torch.Tensor:
    """Warp half-shifted keypoint coords [..., 2] (f32) into warped-image
    half-shifted coords (CylinderProject::project's point loop,
    warp.cc:57-63: f = proj(f + (w/2, h/2)) * sizefactor + offset - size/2)."""
    dx = pts[..., 0] + w / 2.0 - proj.cx
    y = pts[..., 1] + h / 2.0
    px = torch.atan(dx / proj.r)
    py = (y - proj.cy) / torch.hypot(dx, torch.full_like(dx, proj.r))
    nx = px * proj.sizefactor + proj.offset_x - proj.out_w // 2
    ny = py * proj.sizefactor + proj.offset_y - proj.out_h // 2
    return torch.stack([nx, ny], dim=-1)


def warp_image(proj: CylinderProjector, img: torch.Tensor, out_h: int,
               out_w: int, src_w: int, src_h: int) -> torch.Tensor:
    """Inverse-map warp one [H, W, 3] f32 image into an [out_h, out_w, 3]
    canvas (warp.cc:25-44); pixels outside the source get INVALID.  out_h /
    out_w may exceed the projector's own size (padding for batching)."""
    return warp_images(proj, img[None], out_h, out_w, src_w, src_h)[0]


def warp_images(proj: CylinderProjector, imgs: torch.Tensor, out_h: int,
                out_w: int, src_w: int, src_h: int) -> torch.Tensor:
    """:func:`warp_image` over an [N, H, W, 3] stack, uint8 (taken as
    value / 255) or f32; the inverse map is computed once for all."""
    dev = imgs.device
    jj = torch.arange(out_w, dtype=torch.float32, device=dev)
    ii = torch.arange(out_h, dtype=torch.float32, device=dev)
    px = (jj - proj.offset_x) / proj.sizefactor
    py = (ii - proj.offset_y) / proj.sizefactor
    # proj_r (warp.cc:19-23)
    ox = (proj.r * torch.tan(px) + proj.cx).expand(out_h, out_w)
    oy = py[:, None] * (proj.r / torch.cos(px))[None, :] + proj.cy
    inb = (ox >= 0) & (ox < src_w) & (oy >= 0) & (oy < src_h)
    inb &= (jj < proj.out_w)[None, :] & (ii < proj.out_h)[:, None]
    out = torch.empty(imgs.shape[0], out_h, out_w, 3, dtype=torch.float32,
                      device=dev)
    for k in range(imgs.shape[0]):
        img = imgs[k].to(torch.float32)
        if imgs.dtype == torch.uint8:
            img = img / 255.0
        color, valid = sample_bilinear(img, oy, ox)
        out[k] = torch.where((inb & valid)[..., None], color, INVALID)
    return out
