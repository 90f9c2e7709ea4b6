"""The plain reference of the multiband configurations: OpenPano's
Burt-Adelson blender (MultiBandBlender, stitch/multiband.cc:19-151), written
from its semantics in plain PyTorch, importing nothing of the port.

The match, the refit, the transforms and the canvas plan are
``reference.py``'s; ``blend`` runs ``MultiBandBlender::run`` with
``settings["MULTIBAND"]`` levels over the plan's render items:

- first level (multiband.cc:19-57): each item's own bounding box, every
  canvas pixel of it lifted to a ray, mapped into its image and sampled
  bilinearly with ``reference.blend_linear``'s rule (all four taps inside,
  z > 0); colour and weight ``max(0, (0.5 - |nx|)(0.5 - |ny|)) + EPS``
  where the sample is valid, colour 0 and weight 0 where it is not;
- the seam (update_weight_map, multiband.cc:125-143): per canvas pixel,
  the first item in item order whose weight is the largest keeps weight
  1, every other item 0; the first level's validity is the mask at every
  level;
- the levels (multiband.cc:75-108, 145-151): for l < L - 1 the next level
  is each item's 4-channel plane (colour and weight) blurred with sigma
  sqrt(2 l + 1) * 4, the taps of feature/gaussian.cc:17-40 with
  GAUSS_WINDOW_FACTOR (``sift_ref.blur``: the column pass first, the
  item's box edge replicated, gaussian.hh:52-60); each level adds
  sum (cur - next) w / sum w per canvas pixel where sum w >= EPS, the
  last level sum cur w / sum w;
- the output (multiband.cc:113-121): clamped to [0, 1], rounded to u8 half
  to even; 255 where no level added anything, as ``blend_linear``.

Departures from multiband.cc:

- an image across the +-pi seam is two render items (``reference.plan``),
  each blurred over its own box, where OpenPano shifts the negative
  angular range; the port does the same (PARITY.md, "+-pi wrap-split
  multiband strips");
- an invalid pixel (weight 0) takes no part in the seam; where no item
  is valid the pixel is outside the mask at every level, so nothing of it
  reaches the canvas.

The JAX package departs from this reference in one known way: it pads
every item's plane with zeros to the largest item's box, rounded up to 8
rows and 128 columns, so its blur sees zeros past an item's right and
bottom box edges where this reference sees the box's edge pixels.  The
port fills that padding with the box's last row and column before each
blur, and so blurs as this reference does.

The first levels of all items are held for the seam (0.65 GB in float64
at the multiband cell's size); then each item's levels are worked one
item after the other into the per-level canvas sums.  Every step computes
in the ``dtype`` it is given: float64 for the reference, bfloat16 for the
control (``judge.py``); TF32 is off while it runs.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark import sift_ref
from benchmark.reference import apply_h, match_pairs, plan, refit  # noqa: F401

EPS = 1e-6


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for matrix products and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def first_level(views: torch.Tensor, pl: dict, item, dtype) -> torch.Tensor:
    """The first level of render item ``item`` = (image, x0, y0, x1, y1)
    over its own box: [y1 - y0, x1 - x0, 4] (colour, weight), weight 0
    where the sample is invalid."""
    dev = views.device
    i, x0, y0, x1, y1 = (int(v) for v in item)
    img = views[i].to(dtype) / 255.0
    h, w = img.shape[0], img.shape[1]
    lo = torch.as_tensor(pl["proj_min"], dtype=dtype, device=dev)
    res = torch.as_tensor(pl["resolution"], dtype=dtype, device=dev)
    hinv = torch.as_tensor(pl["homo_invs"][i], dtype=dtype, device=dev)
    cx = torch.arange(x0, x1, device=dev).to(dtype) * res[0] + lo[0]
    cy = torch.arange(y0, y1, device=dev).to(dtype) * res[1] + lo[1]
    px, py = torch.broadcast_tensors(cx[None, :], cy[:, None])
    if pl["proj"] == "flat":
        ray = (px, py, torch.ones_like(px))
    else:
        ray = (torch.sin(px), torch.tan(py), torch.cos(px))
    m = [ray[0] * hinv[d, 0] + ray[1] * hinv[d, 1] + ray[2] * hinv[d, 2]
         for d in range(3)]
    z = m[2]
    zs = torch.where(z.abs() > 1e-20, z, torch.full_like(z, 1e-20))
    # a point that maps nowhere (at a low precision) is outside
    sx = torch.nan_to_num(m[0] / zs + w * 0.5, -1.0, -1.0, -1.0)
    sy = torch.nan_to_num(m[1] / zs + h * 0.5, -1.0, -1.0, -1.0)
    fx, fy = torch.floor(sx), torch.floor(sy)
    valid = ((fx >= 0) & (fy >= 0) & (fx + 1 <= w - 1) & (fy + 1 <= h - 1)
             & (z > 0))
    # clamped as integers: a low precision rounds the bound itself
    ix = torch.clamp(fx.long(), 0, w - 2)
    iy = torch.clamp(fy.long(), 0, h - 2)
    rx = (sx - fx)[..., None]
    ry = (sy - fy)[..., None]
    top = img[iy, ix] * (1 - rx) + img[iy, ix + 1] * rx
    bot = img[iy + 1, ix] * (1 - rx) + img[iy + 1, ix + 1] * rx
    color = top * (1 - ry) + bot * ry
    wt = torch.clamp((0.5 - torch.abs(sx / w - 0.5))
                     * (0.5 - torch.abs(sy / h - 0.5)), min=0) + EPS
    zero = torch.zeros((), dtype=dtype, device=dev)
    return torch.cat([torch.where(valid[..., None], color, zero),
                      torch.where(valid, wt, zero)[..., None]], -1)


def blur_planes(planes: torch.Tensor, sigma: float,
                factor: int) -> torch.Tensor:
    """Each channel of [h, w, C] blurred with replicated edges."""
    return torch.stack([sift_ref.blur(planes[..., c], sigma, factor)
                        for c in range(planes.shape[-1])], -1)


def blend(views: torch.Tensor, pl: dict, settings: dict,
          dtype=torch.float64):
    """MultiBandBlender over the plan ``pl`` with ``settings["MULTIBAND"]``
    levels (``settings["GAUSS_WINDOW_FACTOR"]``: the blur's window).
    views: [N, H, W, 3] u8 on the device.  Returns (u8 [h, w, 3], valid
    [h, w]) on the device; 255 where nothing lands."""
    levels = int(settings["MULTIBAND"])
    factor = int(settings["GAUSS_WINDOW_FACTOR"])
    dev = views.device
    H_, W_ = pl["out_h"], pl["out_w"]
    items = [it for it in pl["items"] if it[3] > it[1] and it[4] > it[2]]
    box = lambda it: (slice(int(it[2]), int(it[4])),
                      slice(int(it[1]), int(it[3])))
    with _no_tf32():
        firsts = [first_level(views, pl, it, dtype) for it in items]
        # the seam: the first item attaining the largest weight wins
        maxw = torch.zeros(H_, W_, dtype=dtype, device=dev)
        for it, p in zip(items, firsts):
            r = maxw[box(it)]
            r.copy_(torch.maximum(r, p[..., 3]))
        winner = torch.full((H_, W_), len(items), dtype=torch.long,
                            device=dev)
        for k, (it, p) in enumerate(zip(items, firsts)):
            r = winner[box(it)]
            hit = ((p[..., 3] >= maxw[box(it)]) & (p[..., 3] > 0)
                   & (r == len(items)))
            r.masked_fill_(hit, k)
        del maxw
        isum = torch.zeros(levels, H_, W_, 3, dtype=dtype, device=dev)
        wsum = torch.zeros(levels, H_, W_, dtype=dtype, device=dev)
        for k, it in enumerate(items):
            cur = firsts[k]
            firsts[k] = None
            valid = cur[..., 3] > 0
            won = (winner[box(it)] == k) & valid
            cur = torch.cat([cur[..., :3], won.to(dtype)[..., None]], -1)
            for level in range(levels):
                if level == levels - 1:
                    band = cur[..., :3]
                    nxt = cur
                else:
                    nxt = blur_planes(cur, float(np.sqrt(level * 2 + 1.0) * 4),
                                      factor)
                    band = cur[..., :3] - nxt[..., :3]
                w = torch.where(valid, cur[..., 3],
                                torch.zeros_like(cur[..., 3]))
                isum[level][box(it)] += band * w[..., None]
                wsum[level][box(it)] += w
                cur = nxt
        del winner
    target = torch.zeros(H_, W_, 3, dtype=torch.float64, device=dev)
    has_any = torch.zeros(H_, W_, dtype=torch.bool, device=dev)
    for level in range(levels):
        has = wsum[level] >= EPS
        mean = isum[level].to(torch.float64) / torch.where(
            has, wsum[level], 1).to(torch.float64)[..., None]
        target += torch.where(has[..., None], mean, 0.0)
        has_any |= has
    u8 = torch.round(torch.clamp(target, 0, 1) * 255).to(torch.uint8)
    return torch.where(has_any[..., None], u8, 255), has_any
