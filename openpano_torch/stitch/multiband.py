"""Burt-Adelson multiband blender.

Reference: stitch/multiband.{hh,cc}; counterpart of the single-device
``blend_multiband`` of ``openpano_tpu/stitch/multiband.py``.
  1. First level: each render item is sampled into its output-bbox RoI as
     (color, weight) with border-distance weight
     w = max(0,(0.5-|nx|)(0.5-|ny|))+EPS and a validity mask; invalid pixels
     get (BLACK, 0) so they don't poison the blur (multiband.cc:19-57).
  2. update_weight_map: winner-take-all seam — per canvas pixel only the
     max-weight item keeps w=1 (multiband.cc:125-143).
  3. band_level iterations: next level = Gaussian blur sigma=sqrt(2l+1)*4 of
     the 4-channel (RGB+w) planes (multiband.cc:145-151); accumulate
     (cur-next)*w normalized per level, last level accumulates cur*w
     (multiband.cc:75-108); final clamp to [0,1] (multiband.cc:113-121).

Planes live in one [M, Rh, Rw, 4] buffer, one per render item (a
wrap-straddling image contributes one item per canvas-edge strip), with
Rh / Rw the largest item bbox rounded up to 8 / 128 rows / columns as in
the JAX package.  That rounding is semantics, not layout: the blur
replicates the plane's edge, so the zero padding decides what the blur
sees near an item's RoI edge.  Validity at every level is the first-level
w>0 mask, as in the reference.  Items add into the canvas accumulators one
after the other in item order, so the f32 sums are the same on every
device (no atomics).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.gaussian import blur
from ..ops.imgproc import INVALID
from .projection import PROJECTIONS
from .render import RenderPlan, _sample_bilinear_paired, pair_imgs_x

EPS = 1e-6


def _roi_sizes(plan: RenderPlan) -> tuple[int, int]:
    r = plan.items[:, 1:5]
    rh = int(np.maximum(r[:, 3] - r[:, 1], 1).max())
    rw = int(np.maximum(r[:, 2] - r[:, 0], 1).max())
    return -(-rh // 8) * 8, -(-rw // 128) * 128


def _origins(ranges: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """[M, 2] (x0, y0) where each item's [Rh, Rw] slab sits in the
    [out_h + Rh, out_w + Rw] accumulators: its bbox origin, clamped into
    [0, out] as a dynamic slice clamps its start."""
    r = np.asarray(ranges, np.int64)
    return np.stack([np.clip(r[:, 0], 0, out_w), np.clip(r[:, 1], 0, out_h)], 1)


def _first_level(imgs6: torch.Tensor, homo_invs: torch.Tensor,
                 whs: torch.Tensor, item_idx, ranges, proj_min: torch.Tensor,
                 resolution: torch.Tensor, proj: str, rh: int,
                 rw: int) -> torch.Tensor:
    """[M, Rh, Rw, 4] (RGB + w) planes; w = 0 marks invalid / padding
    pixels.  imgs6: the x-paired [N, H, W-1, 6] f32 stack (``pair_imgs_x``);
    homo_invs [N, 3, 3], whs [N, 2], proj_min and resolution [2] f32;
    item_idx [M] and ranges [M, 4] (x0, y0, x1, y1) host integers.  Items
    are sampled one after the other: the live set is one item's plane."""
    _, proj2homo = PROJECTIONS[proj]
    dev = imgs6.device
    t_h = torch.arange(rh, device=dev)
    t_w = torch.arange(rw, device=dev)
    out = torch.empty(len(item_idx), rh, rw, 4, dtype=torch.float32,
                      device=dev)
    for m in range(len(item_idx)):
        i = int(item_idx[m])
        x0, y0, x1, y1 = (int(v) for v in ranges[m])
        hinv, wh = homo_invs[i], whs[i]
        cx = (t_w + x0).to(torch.float32) * resolution[0] + proj_min[0]
        cy = (t_h + y0).to(torch.float32) * resolution[1] + proj_min[1]
        grid = torch.stack(torch.broadcast_tensors(cx[None, :], cy[:, None]),
                           -1)
        hm = proj2homo(grid)
        # the 3x3 inverse map as explicit f32 products (no tensor cores,
        # hence no TF32 on the card)
        ret = [hm[..., 0] * hinv[d, 0] + hm[..., 1] * hinv[d, 1]
               + hm[..., 2] * hinv[d, 2] for d in range(3)]
        z = ret[2]
        zsafe = torch.where(torch.abs(z) > 1e-20, z, 1e-20)
        sx = ret[0] / zsafe + wh[0] * 0.5
        sy = ret[1] / zsafe + wh[1] * 0.5
        color, ok = _sample_bilinear_paired(imgs6[i], sy, sx)
        in_roi = (t_w + x0 < x1)[None, :] & (t_h + y0 < y1)[:, None]
        valid = ok & (z > 0) & in_roi
        nx = sx / wh[0] - 0.5
        ny = sy / wh[1] - 0.5
        w = torch.clamp((0.5 - torch.abs(nx)) * (0.5 - torch.abs(ny)),
                        min=0.0) + EPS
        out[m, ..., 3] = torch.where(valid, w, 0.0)
        out[m, ..., :3] = torch.where(valid[..., None], color, 0.0)
    return out


def _winner_take_all(planes: torch.Tensor, ranges, out_h: int,
                     out_w: int) -> torch.Tensor:
    """Max-weight seam (multiband.cc:125-143): per canvas pixel, w = 1 for
    the first item attaining the max weight, 0 for the rest.  Returns new
    planes; ``planes`` is left as it was."""
    n, rh, rw = planes.shape[0], planes.shape[1], planes.shape[2]
    org = _origins(ranges, out_h, out_w)
    dev = planes.device
    slab = lambda a, i: a[org[i, 1] : org[i, 1] + rh, org[i, 0] : org[i, 0] + rw]
    maxw = torch.zeros(out_h + rh, out_w + rw, dtype=torch.float32, device=dev)
    for i in range(n):
        r = slab(maxw, i)
        torch.maximum(r, planes[i, ..., 3], out=r)
    # first-attainer tie-break: among items with w == maxw, smallest index
    winner = torch.full((out_h + rh, out_w + rw), n, dtype=torch.int32,
                        device=dev)
    for i in range(n):
        r, w = slab(winner, i), planes[i, ..., 3]
        hit = (w >= slab(maxw, i)) & (w > 0) & (r == n)
        r.masked_fill_(hit, i)
    out = planes.clone()
    for i in range(n):
        won = (slab(winner, i) == i) & (planes[i, ..., 3] > 0)
        out[i, ..., 3] = won.to(torch.float32)
    return out


def _accumulate_level(cur, nxt, valid, ranges, target, visited, out_h: int,
                      out_w: int, is_last: bool):
    """One level's contribution (multiband.cc:75-108): per canvas pixel,
    sum_item (cur-next)*w / sum_item w (cur*w for the last level), added
    into (target, visited), which it returns."""
    n, rh, rw = cur.shape[0], cur.shape[1], cur.shape[2]
    org = _origins(ranges, out_h, out_w)
    dev = cur.device
    isum = torch.zeros(out_h + rh, out_w + rw, 3, dtype=torch.float32,
                       device=dev)
    wsum = torch.zeros(out_h + rh, out_w + rw, dtype=torch.float32,
                       device=dev)
    for i in range(n):
        ys, xs = slice(org[i, 1], org[i, 1] + rh), slice(org[i, 0], org[i, 0] + rw)
        w = cur[i, ..., 3] * valid[i]
        band = cur[i, ..., :3] if is_last else cur[i, ..., :3] - nxt[i, ..., :3]
        isum[ys, xs] += band * w[..., None]
        wsum[ys, xs] += w
    isum = isum[:out_h, :out_w]
    wsum = wsum[:out_h, :out_w]
    has = wsum >= EPS
    contrib = torch.where(has[..., None],
                          isum / torch.clamp(wsum, min=EPS)[..., None], 0.0)
    target = torch.where((has & ~visited)[..., None], contrib,
                         torch.where(has[..., None], target + contrib, target))
    return target, visited | has


def blend_multiband(imgs: torch.Tensor, plan: RenderPlan,
                    band_level: int) -> torch.Tensor:
    """Full multiband run (multiband.cc:59-123).  imgs: [N, H, W, 3] f32
    with INVALID marking empty pixels; returns the [out_h, out_w, 3] canvas
    with INVALID where empty."""
    dev = imgs.device
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=dev)
    rh, rw = _roi_sizes(plan)
    ranges = plan.items[:, 1:5]
    planes = _first_level(
        pair_imgs_x(imgs.to(torch.float32)), f32(plan.homo_invs),
        f32(plan.whs), plan.items[:, 0], ranges, f32(plan.proj_min),
        f32(plan.resolution), plan.proj, rh, rw)
    valid = (planes[..., 3] > 0).to(torch.float32)
    planes = _winner_take_all(planes, ranges, plan.out_h, plan.out_w)

    target = torch.zeros(plan.out_h, plan.out_w, 3, dtype=torch.float32,
                         device=dev)
    visited = torch.zeros(plan.out_h, plan.out_w, dtype=torch.bool,
                          device=dev)
    cur = planes
    for level in range(band_level):
        is_last = level == band_level - 1
        if is_last:
            nxt = cur
        else:
            sigma = float(np.sqrt(level * 2 + 1.0) * 4)
            nxt = blur(cur.movedim(-1, 1), sigma).movedim(1, -1)
        target, visited = _accumulate_level(
            cur, nxt, valid, ranges, target, visited, plan.out_h, plan.out_w,
            is_last)
        cur = nxt
    out = torch.clamp(target, 0.0, 1.0)
    return torch.where(visited[..., None], out, INVALID)
