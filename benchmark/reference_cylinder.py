"""The plain reference of the CYLINDER configurations: OpenPano's
CylinderStitcher (stitch/cylstitcher.cc:20-180) with its CylinderProject
(stitch/warp.cc:13-75), written from their semantics in plain PyTorch and
NumPy, importing nothing of the port.

The match, the refit and the canvas plan are ``reference.py``'s; this
module adds the two pieces that the mode changes, both at the h-factor the
program chose (the judge hands it in):

- ``view_map``: a point of one view carried into another through the
  final transforms, which in this mode map cylinder-warped views: the
  forward projection of the view (warp.cc:13-18), the pair's transforms,
  and the inverse projection (warp.cc:19-23) of the other view;
- ``canvas``: each view warped onto the cylinder by inverse mapping and
  bilinear sampling (warp.cc:25-44), the warped views blended on the flat
  plane of the final transforms with LinearBlender's x weight (the input
  is ordered), and the perspective correction: the four end corners of the
  first and last views mapped into the canvas, the exact homography from
  the output rectangle onto them, and the canvas sampled once more
  (cylstitcher.cc:139-180); rounded to u8 half to even.

The projector (warp.cc:46-75): radius ``r = int(hypot(w, h) *
FOCAL_LENGTH / 43.266)``, centre ``(w // 2, (h // 2) * h_factor)``,
``proj(x, y) = (atan((x - cx) / r), (y - cy) / hypot(x - cx, r))`` scaled
by r, and the warped size and offset from the projected box of every
pixel of the view, which this module scans as warp.cc does.  A keypoint's
warped coordinate is half-shifted by the integer half of the warped size
(warp.cc:57-63); the blender half-shifts by half the size, as for any
image (``reference.blend_linear``).

Every bilinear sample takes its four taps inside the image and valid
(imgproc.cc:135-156), in the warp, the blend and the correction.  Each
step computes in the ``dtype`` it is given: float64 for the reference,
bfloat16 for the control (``judge.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import apply_h, match_pairs, plan, refit  # noqa: F401


def projector(w: int, h: int, hfactor: float, focal_length: float) -> dict:
    """The CylinderProject of a w x h view (warp.cc:46-75): radius, centre,
    and the offset and size of the projected box of every pixel."""
    r = float(int(math.hypot(w, h) * (focal_length / 43.266)))
    cx, cy = float(w // 2), float(h // 2) * hfactor
    x = np.arange(w, dtype=np.float64)[None, :]
    y = np.arange(h, dtype=np.float64)[:, None]
    px = np.broadcast_to(np.arctan((x - cx) / r), (h, w)) * r
    py = (y - cy) / np.hypot(x - cx, r) * r
    return {"r": r, "cx": cx, "cy": cy, "offset": (-px.min(), -py.min()),
            "size": (int(px.max() - px.min()), int(py.max() - py.min()))}


def _half(pr: dict) -> np.ndarray:
    """The integer half of the warped size: a keypoint's half-shift."""
    return np.array([pr["size"][0] // 2, pr["size"][1] // 2], np.float64)


def project(pr: dict, pts: np.ndarray) -> np.ndarray:
    """View pixels [..., 2] to warped pixels (warp.cc:13-18, 57-63)."""
    dx = pts[..., 0] - pr["cx"]
    return np.stack([np.arctan(dx / pr["r"]) * pr["r"] + pr["offset"][0],
                     (pts[..., 1] - pr["cy"]) / np.hypot(dx, pr["r"])
                     * pr["r"] + pr["offset"][1]], -1)


def unproject(pr: dict, q: np.ndarray) -> np.ndarray:
    """Warped pixels [..., 2] back to view pixels (proj_r, warp.cc:19-23)."""
    ax = (q[..., 0] - pr["offset"][0]) / pr["r"]
    ay = (q[..., 1] - pr["offset"][1]) / pr["r"]
    return np.stack([pr["r"] * np.tan(ax) + pr["cx"],
                     ay * pr["r"] / np.cos(ax) + pr["cy"]], -1)


def view_map(homos: np.ndarray, a: int, b: int, pts: np.ndarray, size,
             settings: dict, hfactor: float) -> np.ndarray:
    """Half-shifted points [P, 2] of view b carried into view a: onto b's
    cylinder, through the final transforms ``homos`` (warped half-shifted
    coordinates to the middle view's) into a's warped frame, and back off
    a's cylinder.  ``size`` is the views' (w, h)."""
    w, h = size
    pr = projector(w, h, hfactor, settings["FOCAL_LENGTH"])
    half_view = np.array([w / 2.0, h / 2.0])
    q = project(pr, pts + half_view) - _half(pr)
    q = apply_h(np.linalg.inv(homos[a]) @ homos[b], q)
    return unproject(pr, q + _half(pr)) - half_view


def _bilinear(img: torch.Tensor, ok: torch.Tensor | None, sy: torch.Tensor,
              sx: torch.Tensor):
    """Bilinear samples of ``img`` [h, w, 3] at (sy, sx): (colour, valid),
    valid where the four taps lie inside and, given ``ok`` [h, w], are all
    valid."""
    h, w = img.shape[0], img.shape[1]
    # a point that maps nowhere (at a low precision) is outside
    sx = torch.nan_to_num(sx, -1.0, -1.0, -1.0)
    sy = torch.nan_to_num(sy, -1.0, -1.0, -1.0)
    fx, fy = torch.floor(sx), torch.floor(sy)
    valid = (fx >= 0) & (fy >= 0) & (fx + 1 <= w - 1) & (fy + 1 <= h - 1)
    # clamped as integers: a low precision rounds the bound itself
    ix = torch.clamp(fx.long(), 0, w - 2)
    iy = torch.clamp(fy.long(), 0, h - 2)
    if ok is not None:
        valid &= ok[iy, ix] & ok[iy, ix + 1] & ok[iy + 1, ix] \
            & ok[iy + 1, ix + 1]
    rx = (sx - fx)[..., None]
    ry = (sy - fy)[..., None]
    top = img[iy, ix] * (1 - rx) + img[iy, ix + 1] * rx
    bot = img[iy + 1, ix] * (1 - rx) + img[iy + 1, ix + 1] * rx
    return top * (1 - ry) + bot * ry, valid


def warp(view: torch.Tensor, pr: dict, dtype=torch.float64):
    """One u8 view [H, W, 3] warped onto the cylinder (warp.cc:25-44):
    (colour [oh, ow, 3] in [0, 1], valid [oh, ow])."""
    dev = view.device
    ow, oh = pr["size"]
    img = view.to(dtype) / 255.0
    ax = (torch.arange(ow, device=dev).to(dtype) - pr["offset"][0]) / pr["r"]
    ay = (torch.arange(oh, device=dev).to(dtype) - pr["offset"][1]) / pr["r"]
    ox = pr["r"] * torch.tan(ax) + pr["cx"]
    oy = ay[:, None] * (pr["r"] / torch.cos(ax))[None, :] + pr["cy"]
    return _bilinear(img, None, oy, ox.expand(oh, ow))


def _blend_warped(views: torch.Tensor, pl: dict, pr: dict, dtype,
                  rows: int = 512):
    """LinearBlender over the plan ``pl`` of the warped views, ordered
    input (the x weight alone): (colour [h, w, 3], valid [h, w])."""
    dev = views.device
    H_, W_ = pl["out_h"], pl["out_w"]
    ow, oh = pr["size"]
    color = torch.zeros(H_, W_, 3, dtype=dtype, device=dev)
    wsum = torch.zeros(H_, W_, dtype=dtype, device=dev)
    lo = torch.as_tensor(pl["proj_min"], dtype=dtype, device=dev)
    res = torch.as_tensor(pl["resolution"], dtype=dtype, device=dev)
    for i, x0, y0, x1, y1 in pl["items"]:
        if x1 <= x0 or y1 <= y0:
            continue
        img, ok = warp(views[i], pr, dtype)
        hinv = torch.as_tensor(pl["homo_invs"][i], dtype=dtype, device=dev)
        cx = torch.arange(x0, x1, device=dev).to(dtype) * res[0] + lo[0]
        for r0 in range(y0, y1, rows):
            r1 = min(r0 + rows, y1)
            cy = torch.arange(r0, r1, device=dev).to(dtype) * res[1] + lo[1]
            px, py = torch.broadcast_tensors(cx[None, :], cy[:, None])
            m = [px * hinv[d, 0] + py * hinv[d, 1] + hinv[d, 2]
                 for d in range(3)]
            z = m[2]
            zs = torch.where(z.abs() > 1e-20, z, torch.full_like(z, 1e-20))
            sx, sy = m[0] / zs + ow * 0.5, m[1] / zs + oh * 0.5
            c, valid = _bilinear(img, ok, sy, sx)
            wt = 0.5 - torch.abs(sx / ow - 0.5)
            wt = torch.where(valid & (z > 0), wt, torch.zeros_like(wt))
            color[r0:r1, x0:x1] += c * wt[..., None]
            wsum[r0:r1, x0:x1] += wt
    has = wsum > 0
    return color / torch.where(has, wsum, 1)[..., None], has


def _correction(homos: np.ndarray, pl: dict, whs: np.ndarray, h: int,
                w: int) -> np.ndarray:
    """The homography from output-rectangle pixels onto the four projected
    end corners of the first and last views in canvas pixels
    (cylstitcher.cc:139-166), solved exactly in float64 with h22 = 1."""
    last = len(homos) - 1

    def to_canvas(i, cx, cy):
        p = homos[i] @ np.array([cx * whs[i, 0], cy * whs[i, 1], 1.0])
        return (p[:2] / p[2] - pl["proj_min"]) / pl["resolution"]

    dst = [to_canvas(0, -0.5, -0.5), to_canvas(0, -0.5, 0.5),
           to_canvas(last, 0.5, -0.5), to_canvas(last, 0.5, 0.5)]
    src = [(0.0, 0.0), (0.0, float(h)), (float(w), 0.0), (float(w), float(h))]
    A, b = [], []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -x * u, -y * u])
        A.append([0, 0, 0, x, y, 1, -x * v, -y * v])
        b += [u, v]
    return np.append(np.linalg.solve(np.array(A), np.array(b)), 1.0) \
        .reshape(3, 3)


def canvas(views: torch.Tensor, homos: np.ndarray, settings: dict,
           hfactor: float, dtype=torch.float64, rows: int = 512):
    """CylinderStitcher's canvas of the u8 views [N, H, W, 3] on the
    device under the final transforms ``homos``: warped at ``hfactor``,
    planned flat on the warped size (the middle view the identity,
    MAX_OUTPUT_SIZE as ``reference.plan``), blended and corrected.
    Returns (u8 [h, w, 3], valid [h, w]) on the device; 255 where
    nothing lands."""
    n, H, W = views.shape[0], views.shape[1], views.shape[2]
    pr = projector(W, H, hfactor, settings["FOCAL_LENGTH"])
    whs = np.repeat([[float(pr["size"][0]), float(pr["size"][1])]], n, 0)
    pl = plan(homos, whs, n >> 1, "flat", settings["MAX_OUTPUT_SIZE"])
    blended, has = _blend_warped(views, pl, pr, dtype, rows)
    h, w = pl["out_h"], pl["out_w"]
    Hc = torch.as_tensor(_correction(homos, pl, whs, h, w), dtype=dtype,
                         device=views.device)
    dev = views.device
    jj = torch.arange(w, device=dev).to(dtype)[None, :]
    u8 = torch.full((h, w, 3), 255, dtype=torch.uint8, device=dev)
    valid = torch.zeros(h, w, dtype=torch.bool, device=dev)
    for r0 in range(0, h, rows):
        r1 = min(r0 + rows, h)
        ii = torch.arange(r0, r1, device=dev).to(dtype)[:, None]
        m = [jj * Hc[d, 0] + ii * Hc[d, 1] + Hc[d, 2] for d in range(3)]
        z = m[2]
        zs = torch.where(z.abs() > 1e-20, z, torch.full_like(z, 1e-20))
        c, ok = _bilinear(blended, has, m[1] / zs, m[0] / zs)
        ok &= z > 0
        c = torch.round(torch.clamp(c.to(torch.float64), 0, 1) * 255)
        u8[r0:r1] = torch.where(ok[..., None], c.to(torch.uint8), 255)
        valid[r0:r1] = ok
    return u8, valid
