"""Render planning + linear blending.

Reference: stitch/stitcher_image.{hh,cc} (ConnectedImages) and
stitch/blender.cc (LinearBlender); counterpart of
``openpano_tpu/stitch/render.py``.  ``blend`` hands a multiband run to
``multiband.py``.

Host side (``plan_render``, numpy): project 400 sampled border points of each
image through its homography, take per-image and global bboxes
(stitcher_image.cc:41-77), and calibrate the output resolution so that the
identity image keeps its native resolution (:79-114, with the 80000 px /
1e9 px failure gates and the MAX_OUTPUT_SIZE downscale).

Device side (``blend_linear``): the canvas is covered by jobs, one per
render item, each a [TH, TW] slab at the item's bbox origin, split into
column bands (``_tile_jobs``).  Each job inverse-maps its slab through
proj2homo -> homo_inv -> perspective divide (z > 0 only) -> half-shift,
samples the source bilinearly with Color::NO propagation (the x-paired
layout of the JAX package), weights by the center distance
w = 0.5 - |c/w - 0.5| (times the vertical factor for unordered input;
blender.cc:27-36), and adds into the canvas accumulators.  Jobs add in the
JAX package's order (bands, then items), so the canvas is the same sum.
``blend_linear_host_stream`` runs the same jobs band by band from an image
stack in host memory, carrying each band's spill columns to the next;
``blend_linear_sharded`` runs them one band per rank, the spill columns
sent to the next rank.

``blend_linear_stream_u8`` (the JAX package's default u8 blend) runs the
in-memory jobs in column bands and, once band g has run, finalizes strip g
to u8 on the device and starts its download while later bands compute: as
the download codec's planes (``io.wirecodec.CodedFetch``, under
``OPENPANO_CODED_DOWNLOAD=1``, the default) or as raw RGBA.  It equals
``blend_linear`` followed by ``f32_to_u8`` bit for bit.  ``packed_gather``
(``OPENPANO_PACKED_GATHER=1`` in the stitcher) samples an R|G|B|valid int32
image instead of the x-paired f32 one: exact for u8 sources up to the
order of the lerp, so within one u8 level.

Knobs, read at each call: ``OPENPANO_TILE_H`` / ``OPENPANO_TILE_W`` (256
each, as in the JAX package) size the tile jobs of ``item_slabs=False``;
``OPENPANO_BLEND_GRID=1`` (off by default) replaces the exact inverse map
of every linear blend (in memory, streamed, host stream, sharded) with
``_inverse_map_grid``: exact at the corners of a 16 x 16 px grid, bilinear
in between.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..geometry.polygon import convex_hull
from ..ops.imgproc import INVALID, bilinear_prologue
from ..utils.timer import span
from .projection import PROJECTIONS

BLEND_GROUPS = 4
_GS = 16   # the grid map's cell, in canvas px
# the grid map's canvas against the exact map's where both are valid, as
# tests/test_torch_tools.py measured it on a 5-view spherical plan (focal
# 558 px): largest 0.313 (a hard texture edge), mean 7.6e-4
GRID_MAX_ABS = 0.35
GRID_MEAN_ABS = 1e-3


def tile_size() -> tuple[int, int]:
    """(TH, TW) of the tile jobs: ``OPENPANO_TILE_H`` / ``OPENPANO_TILE_W``,
    256 each unset.  A value below 1 raises."""
    out = []
    for name in ("OPENPANO_TILE_H", "OPENPANO_TILE_W"):
        v = int(os.environ.get(name, "256"))
        if v < 1:
            raise ValueError(f"{name}={v}: must be at least 1")
        out.append(v)
    return tuple(out)


def blend_grid() -> bool:
    """``OPENPANO_BLEND_GRID=1``: the linear blends take the grid map."""
    return os.environ.get("OPENPANO_BLEND_GRID", "0") == "1"


class RenderPlan(NamedTuple):
    proj: str                # projection method name
    homos: np.ndarray        # [N,3,3] image half-shifted px -> identity frame
    homo_invs: np.ndarray    # [N,3,3]
    whs: np.ndarray          # [N,2] per-image (w,h), float
    proj_min: np.ndarray     # (2,) projection-plane bbox min
    resolution: np.ndarray   # (2,) projection units per output pixel
    out_w: int
    out_h: int
    ranges: np.ndarray       # [N,4] per-image canvas bbox (x0,y0,x1,y1), int
    items: np.ndarray        # [M,5] (img, x0,y0,x1,y1) render items; an image
                             # whose angular span crosses the +-pi seam
                             # becomes one item per canvas-edge strip
    hulls: tuple             # per-item convex hull of the projected border
                             # in canvas px, [K,2] float arrays


def _np_homo2proj(proj: str, h: np.ndarray) -> np.ndarray:
    x, y, z = h[..., 0], h[..., 1], h[..., 2]
    if proj == "flat":
        return np.stack([x / z, y / z], -1)
    if proj == "cylindrical":
        return np.stack([np.arctan2(x, z), y / np.hypot(x, z)], -1)
    return np.stack([np.arctan2(x, z), np.arctan2(y, np.hypot(x, z))], -1)


def plan_render(homos: np.ndarray, whs: np.ndarray, identity_idx: int,
                proj: str, max_output_size: int) -> RenderPlan:
    """homos: [N,3,3] mapping half-shifted pixel coords of image i into the
    identity frame; whs: [N,2] image sizes."""
    n = homos.shape[0]
    t = np.arange(100) / 100.0 - 0.5
    border = np.concatenate([
        np.stack([t, np.full(100, -0.5)], -1),
        np.stack([t, np.full(100, 0.5)], -1),
        np.stack([np.full(100, -0.5), t], -1),
        np.stack([np.full(100, 0.5), t], -1),
    ])                                                    # [400,2] normalized

    ranges = np.zeros((n, 4))
    proj_min = np.full(2, np.inf)
    proj_max = np.full(2, -np.inf)
    per_min = np.zeros((n, 2))
    per_max = np.zeros((n, 2))
    per_pp = []
    for i in range(n):
        pts = border * whs[i]                             # half-shifted px
        hpt = np.concatenate([pts, np.ones((400, 1))], -1) @ homos[i].T
        pp = _np_homo2proj(proj, hpt)
        per_pp.append(pp)
        per_min[i] = pp.min(0)
        per_max[i] = pp.max(0)
        proj_min = np.minimum(proj_min, per_min[i])
        proj_max = np.maximum(proj_max, per_max[i])

    # get_final_resolution (stitcher_image.cc:79-114)
    refw, refh = whs[identity_idx]
    Hi = homos[identity_idx]
    c2 = Hi @ np.array([refw / 2.0, refh / 2.0, 1.0])
    c1 = Hi @ np.array([-refw / 2.0, -refh / 2.0, 1.0])
    id_range = _np_homo2proj(proj, c2) - _np_homo2proj(proj, c1)
    if proj != "flat":
        if id_range[0] < 0:
            id_range[0] += 2 * np.pi
        if id_range[1] < 0:
            id_range[1] += np.pi
    resolution = np.abs(id_range) / np.array([refw, refh])
    target = (proj_max - proj_min) / resolution
    max_edge = target.max()
    if max_edge > 80000 or target[0] * target[1] > 1e9:
        raise RuntimeError(
            "Target size too large. Looks like a stitching failure!"
        )  # stitcher_image.cc:105-106
    if max_edge > max_output_size:
        resolution = resolution * (max_edge / max_output_size)
    size = ((proj_max - proj_min) / resolution).astype(int)

    items = []
    hulls = []
    for i in range(n):
        tl = ((per_min[i] - proj_min) / resolution).astype(int)
        br = ((per_max[i] - proj_min) / resolution).astype(int)
        ranges[i] = [tl[0], tl[1], min(br[0], size[0]), min(br[1], size[1])]
        pp = per_pp[i]
        if proj != "flat" and per_max[i][0] - per_min[i][0] > np.pi:
            # angular-wrap split: one item per edge strip
            for sel in (pp[:, 0] < 0, pp[:, 0] >= 0):
                if not sel.any():
                    continue
                smin = pp[sel].min(0)
                smax = pp[sel].max(0)
                stl = ((smin - proj_min) / resolution).astype(int)
                sbr = ((smax - proj_min) / resolution).astype(int)
                items.append([i, stl[0], stl[1],
                              min(sbr[0], size[0]), min(sbr[1], size[1])])
                hulls.append(convex_hull((pp[sel] - proj_min) / resolution))
        else:
            items.append([i, *ranges[i].astype(int)])
            hulls.append(convex_hull((pp - proj_min) / resolution))

    return RenderPlan(
        proj=proj,
        homos=homos.astype(np.float64),
        homo_invs=np.linalg.inv(homos).astype(np.float64),
        whs=whs.astype(np.float64),
        proj_min=proj_min,
        resolution=resolution,
        out_w=int(size[0]),
        out_h=int(size[1]),
        ranges=ranges.astype(np.int32),
        items=np.asarray(items, np.int32).reshape(-1, 5),
        hulls=tuple(hulls),
    )


def _poly_rect_intersects(poly: np.ndarray, x0, y0, x1, y1,
                          margin=8.0) -> bool:
    """Convex polygon vs axis-aligned rect (separating axes); the rect is
    dilated by ``margin`` px to absorb the sagitta of the sampled hull."""
    x0, y0, x1, y1 = x0 - margin, y0 - margin, x1 + margin, y1 + margin
    if poly.shape[0] < 3:
        px0, py0 = poly.min(0)
        px1, py1 = poly.max(0)
        return not (px1 < x0 or px0 > x1 or py1 < y0 or py0 > y1)
    if poly[:, 0].max() < x0 or poly[:, 0].min() > x1:
        return False
    if poly[:, 1].max() < y0 or poly[:, 1].min() > y1:
        return False
    corners = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
    nv = poly.shape[0]
    edges = poly[(np.arange(nv) + 1) % nv] - poly
    normals = np.stack([-edges[:, 1], edges[:, 0]], -1)       # [E,2]
    pp = normals @ poly.T                                     # [E,V]
    pc = normals @ corners.T                                  # [E,4]
    sep = (pp.max(1) < pc.min(1)) | (pp.min(1) > pc.max(1))
    return not sep.any()


def _tile_jobs(plan: RenderPlan, groups: int, TH: int | None = None,
               TW: int | None = None, item_slabs: bool = True,
               exact: bool = False):
    """Jobs partitioned into ``groups`` column bands by x-origin (a band-g
    job never writes columns < g*SW).  ``item_slabs=True``: one job per
    render item sized to the largest item bbox (TH/TW ignored); otherwise
    each item's bbox is covered by [TH, TW] tiles its hull touches (TH / TW
    unset: ``tile_size()``).

    ``exact=True`` (the banded host-stream blends) keeps G == groups even
    when bands come out empty and forces SW >= TW, so that a band-g job
    spills into strip g+1 at most; otherwise G drops to 1 below
    2 * groups items and shrinks until the last strip is non-empty.

    Returns (G, SW, Hp, Wp, TH, TW, band_jobs), band_jobs[g] =
    (img [J] int32, bbox [J,4] f32, origin [J,2] int32, item [J] int32),
    as the JAX package's ``_tile_jobs``."""
    it = plan.items
    r = it[:, 1:5]
    dh, dw = tile_size()
    TH = dh if TH is None else TH
    TW = dw if TW is None else TW
    if item_slabs:
        TH = -(-int(np.maximum(r[:, 3] - r[:, 1], 1).max()) // 8) * 8
        TW = -(-int(np.maximum(r[:, 2] - r[:, 0], 1).max()) // 128) * 128
    oy_max = -(-plan.out_h // 8) * 8
    ox_max = -(-plan.out_w // 128) * 128
    Hp = oy_max + TH
    Wp = ox_max + TW

    G = groups if (exact or len(it) >= 2 * groups) else 1
    SW = -(-(-(-Wp // G)) // 128) * 128  # ceil(Wp/G) rounded up to 128
    if exact or item_slabs:
        SW = max(SW, -(-TW // 128) * 128)  # one job spills <= one strip
    if not exact:
        while (G - 1) * SW >= Wp:  # last strip must be non-empty
            G -= 1
    Wp = G * SW

    jobs: list[list[tuple]] = [[] for _ in range(G)]
    for s in range(len(it)):
        x0, y0, x1, y1 = r[s]
        if item_slabs:
            ox = min(max(int(x0), 0), ox_max)
            oy = min(max(int(y0), 0), oy_max)
            jobs[min(ox // SW, G - 1)].append((it[s, 0], r[s], (ox, oy), s))
            continue
        hull = plan.hulls[s] if plan.hulls else None
        for oy in range(max(int(y0), 0), max(int(min(y1, plan.out_h)), 0), TH):
            oy = min(oy, oy_max)
            for ox in range(max(int(x0), 0),
                            max(int(min(x1, plan.out_w)), 0), TW):
                ox = min(ox, ox_max)
                if hull is not None and not _poly_rect_intersects(
                        hull, ox, oy, ox + TW, oy + TH):
                    continue
                jobs[min(ox // SW, G - 1)].append((it[s, 0], r[s], (ox, oy), s))

    band_jobs = []
    for band in jobs:
        band_jobs.append((
            np.asarray([j[0] for j in band], np.int32),
            np.asarray([j[1] for j in band], np.float32).reshape(-1, 4),
            np.asarray([j[2] for j in band], np.int32).reshape(-1, 2),
            np.asarray([j[3] for j in band], np.int32),
        ))
    return G, SW, Hp, Wp, TH, TW, band_jobs


def pair_imgs_x(imgs: torch.Tensor) -> torch.Tensor:
    """[N,H,W,3] -> [N,H,W-1,6] with img6[y,x] = img[y,x] | img[y,x+1]: one
    6-channel tap per bilinear row."""
    return torch.cat([imgs[:, :, :-1], imgs[:, :, 1:]], dim=-1)


def _sample_bilinear_paired(img6: torch.Tensor, y: torch.Tensor,
                            x: torch.Tensor):
    """Sentinel-aware bilinear sampling over the x-paired layout: img6 is
    [H, W-1, 6] and the bounds follow the original width.  The lerp is
    associated as (top, bottom) rows, like the JAX package's paired form."""
    h = img6.shape[0]
    w = img6.shape[1] + 1
    inb, iy, ix, ry, rx = bilinear_prologue(h, w, y, x)
    a = img6[iy, ix]          # p00 | p01
    b = img6[iy + 1, ix]      # p10 | p11
    ok = (a[..., 0] >= 0) & (a[..., 3] >= 0) & (b[..., 0] >= 0) \
        & (b[..., 3] >= 0)
    valid = inb & ok
    top = a[..., :3] * (1 - rx) + a[..., 3:] * rx
    bot = b[..., :3] * (1 - rx) + b[..., 3:] * rx
    color = top * (1 - ry) + bot * ry
    return torch.where(valid[..., None], color, INVALID), valid


def pack_imgs_u8(imgs: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] f32 in [0, 1] (INVALID < 0 = empty) -> [N, H, W] int32
    with R | G | B | valid bytes, 0 where empty: one element a bilinear
    tap.  Exact for u8 sources (u8 -> f32 / 255 -> u8 round-trips)."""
    valid = imgs[..., 0] >= 0
    u8 = torch.round(torch.clamp(imgs, 0.0, 1.0) * 255.0).to(torch.int32)
    packed = (u8[..., 0] | (u8[..., 1] << 8) | (u8[..., 2] << 16)
              | (valid.to(torch.int32) << 24))
    return torch.where(valid, packed, 0)


def _sample_bilinear_packed(img_i32: torch.Tensor, y: torch.Tensor,
                            x: torch.Tensor):
    """Bilinear sampling over an R|G|B|valid-packed int32 image
    (``pack_imgs_u8``): (color [..., 3], valid [...]); a sample is valid
    when it is in bounds and its four taps are."""
    h, w = img_i32.shape[0], img_i32.shape[1]
    inb, iy, ix, ry, rx = bilinear_prologue(h, w, y, x)
    p00 = img_i32[iy, ix]
    p10 = img_i32[iy + 1, ix]
    p01 = img_i32[iy, ix + 1]
    p11 = img_i32[iy + 1, ix + 1]
    ok = inb & (((p00 & p10 & p01 & p11) >> 24) > 0)

    def rgb(p):
        return torch.stack([p & 0xFF, (p >> 8) & 0xFF, (p >> 16) & 0xFF],
                           -1).to(torch.float32) / 255.0

    color = (rgb(p00) * (1 - ry) * (1 - rx) + rgb(p10) * ry * (1 - rx)
             + rgb(p01) * (1 - ry) * rx + rgb(p11) * ry * rx)
    return color, ok


def _inverse_map(proj2homo, hinv, wh, cx, cy):
    """(sx, sy, z) [len(cy), len(cx)]: the canvas points (cx, cy) in
    projection units through proj2homo, the 3x3 inverse map and the
    perspective divide, half-shifted to source pixels."""
    cgrid = torch.stack(torch.broadcast_tensors(cx[None, :], cy[:, None]), -1)
    hm = proj2homo(cgrid)
    # the 3x3 inverse map as explicit f32 products (no tensor cores, hence
    # no TF32 on the card)
    ret = [hm[..., 0] * hinv[d, 0] + hm[..., 1] * hinv[d, 1]
           + hm[..., 2] * hinv[d, 2] for d in range(3)]
    z = ret[2]
    zsafe = torch.where(torch.abs(z) > 1e-20, z, 1e-20)
    return ret[0] / zsafe + wh[0] * 0.5, ret[1] / zsafe + wh[1] * 0.5, z


def _inverse_map_grid(proj2homo, hinv, wh, ox: int, oy: int, res, proj_min,
                      TH: int, TW: int):
    """(sx, sy, z) [TH, TW] of the job at canvas (ox, oy), the JAX
    package's ``_inverse_map_grid``: the exact map at the corners of
    ``_GS`` px cells, bilinear in between (an error of about GS^2 / (8 f)
    px at focal f).  z only feeds the z > 0 test, and interpolated across a
    sign change it would let garbage coordinates through, so each cell
    takes the least z of its corners.  A side that is no multiple of
    ``_GS`` (the JAX package's reshape refuses it) is covered by whole
    cells and cut."""
    dev = hinv.device
    ngy, ngx = -(-TH // _GS) + 1, -(-TW // _GS) + 1
    gx = ox + torch.arange(ngx, dtype=torch.float32, device=dev) * _GS
    gy = oy + torch.arange(ngy, dtype=torch.float32, device=dev) * _GS
    sxg, syg, zg = _inverse_map(proj2homo, hinv, wh,
                                gx * res[0] + proj_min[0],
                                gy * res[1] + proj_min[1])
    f = torch.arange(_GS, dtype=torch.float32, device=dev) / _GS
    fy, fx = f[:, None, None, None], f[None, :, None, None]

    def up(g):
        v = (g[:-1, :-1] * (1 - fy) * (1 - fx) + g[:-1, 1:] * (1 - fy) * fx
             + g[1:, :-1] * fy * (1 - fx) + g[1:, 1:] * fy * fx)
        return v.permute(2, 0, 3, 1).reshape((ngy - 1) * _GS,
                                             (ngx - 1) * _GS)[:TH, :TW]

    zc = torch.minimum(torch.minimum(zg[:-1, :-1], zg[:-1, 1:]),
                       torch.minimum(zg[1:, :-1], zg[1:, 1:]))
    z = zc.repeat_interleave(_GS, 0).repeat_interleave(_GS, 1)[:TH, :TW]
    return up(sxg), up(syg), z


def _run_jobs(color_acc: torch.Tensor, w_acc: torch.Tensor,
              imgs6: torch.Tensor, hinvs: torch.Tensor, whs: torch.Tensor,
              jobs, plan: RenderPlan, ordered: bool, TH: int, TW: int,
              x0: int = 0):
    """Add the jobs ``(img, bbox, origin, item)`` in their order into the
    (color [*, *, 3], weight) f32 accumulators, whose column 0 is canvas
    column ``x0``.  ``img`` indexes ``imgs6`` (x-paired, ``pair_imgs_x``,
    or [*, H, W] int32 from ``pack_imgs_u8``), ``hinvs`` [*, 3, 3] and
    ``whs`` [*, 2]."""
    dev = imgs6.device
    _, proj2homo = PROJECTIONS[plan.proj]
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=dev)
    proj_min, res = f32(plan.proj_min), f32(plan.resolution)
    t_h = torch.arange(TH, dtype=torch.float32, device=dev)
    t_w = torch.arange(TW, dtype=torch.float32, device=dev)
    grid = blend_grid()
    idx, rng, org = jobs[0], jobs[1], jobs[2]
    for k in range(len(idx)):
        i, (ox, oy) = int(idx[k]), (int(org[k, 0]), int(org[k, 1]))
        bx0, by0, bx1, by1 = (float(v) for v in rng[k])
        hinv, wh = hinvs[i], whs[i]
        if grid:
            sx, sy, z = _inverse_map_grid(proj2homo, hinv, wh, ox, oy, res,
                                          proj_min, TH, TW)
        else:
            sx, sy, z = _inverse_map(proj2homo, hinv, wh,
                                     (ox + t_w) * res[0] + proj_min[0],
                                     (oy + t_h) * res[1] + proj_min[1])
        sample = (_sample_bilinear_packed if imgs6.dim() == 3
                  else _sample_bilinear_paired)
        color, ok = sample(imgs6[i], sy, sx)
        w = 0.5 - torch.abs(sx / wh[0] - 0.5)
        if not ordered:  # blend both directions (blender.cc:33-35)
            w = w * (0.5 - torch.abs(sy / wh[1] - 0.5))
        ax = ox + t_w[None, :]
        ay = oy + t_h[:, None]
        in_bbox = (ax >= bx0) & (ax < bx1) & (ay >= by0) & (ay < by1)
        m = ok & (z > 0) & in_bbox
        wm = torch.where(m, w, 0.0)
        wc = torch.where(m[..., None], color, 0.0) * wm[..., None]
        xs = slice(ox - x0, ox - x0 + TW)
        color_acc[oy : oy + TH, xs] += wc
        w_acc[oy : oy + TH, xs] += wm


def _band_runner(imgs: torch.Tensor, plan: RenderPlan, ordered: bool,
                 packed_gather: bool, item_slabs: bool, min_width: int = 0):
    """The in-memory blend's jobs in ``BLEND_GROUPS`` column bands: (G, SW,
    the (color [Hp, Wp, 3], weight [Hp, Wp]) f32 accumulators, at least
    ``min_width`` wide, run(g), which adds band g's jobs into them)."""
    G, SW, Hp, Wp, TH, TW, band_jobs = _tile_jobs(plan, BLEND_GROUPS,
                                                  item_slabs=item_slabs)
    Wp = max(Wp, min_width)
    dev = imgs.device
    imgs = imgs.to(torch.float32)
    src = pack_imgs_u8(imgs) if packed_gather else pair_imgs_x(imgs)
    hinvs = torch.as_tensor(plan.homo_invs, dtype=torch.float32, device=dev)
    whs = torch.as_tensor(plan.whs, dtype=torch.float32, device=dev)
    color_acc = torch.zeros(Hp, Wp, 3, dtype=torch.float32, device=dev)
    w_acc = torch.zeros(Hp, Wp, dtype=torch.float32, device=dev)

    def run(g: int):
        _run_jobs(color_acc, w_acc, src, hinvs, whs, band_jobs[g], plan,
                  ordered, TH, TW)
    return G, SW, color_acc, w_acc, run


def _normalize(color: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """color / w where w > 0, INVALID elsewhere (``_finalize_canvas``
    there)."""
    has = w > 0
    out = color / torch.where(has, w, 1.0)[..., None]
    return torch.where(has[..., None], out, INVALID)


def blend_linear(imgs: torch.Tensor, plan: RenderPlan, ordered: bool,
                 packed_gather: bool = False,
                 item_slabs: bool = True) -> torch.Tensor:
    """imgs: [N, H, W, 3] float in [0, 1] (INVALID marks empty pixels).
    Returns the [out_h, out_w, 3] f32 canvas, INVALID where nothing was
    rendered.  ``packed_gather`` samples the ``pack_imgs_u8`` form;
    ``item_slabs=False`` covers each item's bbox with 256x256 tiles its
    hull touches instead of one slab per item."""
    G, _, color_acc, w_acc, run = _band_runner(imgs, plan, ordered,
                                               packed_gather, item_slabs)
    for g in range(G):
        run(g)
    return _normalize(color_acc[: plan.out_h, : plan.out_w],
                      w_acc[: plan.out_h, : plan.out_w])


def _strip_rgb_has(color_acc: torch.Tensor, w_acc: torch.Tensor, start: int,
                   out_h: int, SW: int):
    """Columns [start, start + SW) of the accumulators normalized and
    rounded to u8 (``f32_to_u8``'s values): (rgb int32 [out_h, SW, 3], 255
    where empty; has [out_h, SW])."""
    c = color_acc[:out_h, start:start + SW]
    w = w_acc[:out_h, start:start + SW]
    has = w > 0
    out = c / torch.where(has, w, 1.0)[..., None]
    u8 = torch.round(torch.clamp(out, 0.0, 1.0) * 255.0).to(torch.int32)
    return torch.where(has[..., None], u8, 255), has


def _strip_planes_u8(color_acc: torch.Tensor, w_acc: torch.Tensor,
                     start: int, out_h: int, SW: int) -> torch.Tensor:
    """A finished column strip as the download codec's planes [4*out_h, SW]
    u8: G, R-G, B-G (mod 256) and A stacked along rows; the chroma
    differences delta-code tighter than raw R and B, and the codec's deltas
    never cross rows.  ``_planes_to_rgba`` inverts it."""
    rgb, has = _strip_rgb_has(color_acc, w_acc, start, out_h, SW)
    g = rgb[..., 1]
    rg = (rgb[..., 0] - g) & 0xFF
    bg = (rgb[..., 2] - g) & 0xFF
    return torch.cat([g, rg, bg, has.to(torch.int32)], dim=0).to(torch.uint8)


def _planes_to_rgba(planes: np.ndarray, out_h: int) -> np.ndarray:
    """Inverse of ``_strip_planes_u8`` on the host: [4*out_h, SW] u8 ->
    RGBA u8 [out_h, SW, 4]."""
    g = planes[:out_h]
    rg = planes[out_h: 2 * out_h]
    bg = planes[2 * out_h: 3 * out_h]
    a = planes[3 * out_h:]
    rgba = np.empty((out_h, planes.shape[1], 4), np.uint8)
    rgba[..., 0] = g + rg  # u8 wraparound == mod 256
    rgba[..., 1] = g
    rgba[..., 2] = g + bg
    rgba[..., 3] = a
    return rgba


def _strip_u8_i32(color_acc: torch.Tensor, w_acc: torch.Tensor, start: int,
                  out_h: int, SW: int) -> torch.Tensor:
    """A finished column strip as RGBA u8 viewed as int32 [out_h, SW] (one
    element a pixel)."""
    rgb, has = _strip_rgb_has(color_acc, w_acc, start, out_h, SW)
    rgba = torch.cat([rgb, has[..., None].to(torch.int32)], -1)
    return rgba.to(torch.uint8).view(torch.int32)[..., 0]


def blend_linear_stream_u8(imgs: torch.Tensor, plan: RenderPlan,
                           ordered: bool, groups: int = 4,
                           packed_gather: bool = False,
                           item_slabs: bool = True) -> np.ndarray:
    """The linear blend straight to a host RGBA uint8 canvas [out_h, out_w,
    4] (alpha 1 where rendered), equal to ``blend_linear`` then
    ``f32_to_u8`` bit for bit.

    The canvas is cut into ``groups`` column strips (``_tile_jobs(plan,
    groups)``'s, as the JAX package cuts them).  The jobs run in
    ``blend_linear``'s bands and order, whatever ``groups`` is, so every
    pixel sums the same terms in the same order; a later band never writes
    a column left of its own start, so once a band has run, each strip
    left of the next band's start is final: it is rounded to u8 on the
    device and its copy to the host starts while later bands compute.
    (The JAX package runs its jobs in the strips' bands, which orders the
    sums by ``groups``.)  Under ``OPENPANO_CODED_DOWNLOAD=1`` (the default)
    a strip moves as the download codec's planes (``CodedFetch``), else as
    raw RGBA; the strips are waited for in order after the last band."""
    from ..io.transfer import HostCopy
    from ..io.wirecodec import CodedFetch, count

    G, SW = _tile_jobs(plan, groups, item_slabs=item_slabs)[:2]
    GB, SWB, color_acc, w_acc, run = _band_runner(
        imgs, plan, ordered, packed_gather, item_slabs, min_width=G * SW)
    coded = os.environ.get("OPENPANO_CODED_DOWNLOAD", "1") == "1"
    strips = []
    for b in range(GB):
        run(b)
        final = G * SW if b == GB - 1 else (b + 1) * SWB
        while len(strips) < G and (len(strips) + 1) * SW <= final:
            g = len(strips)
            if coded:
                strips.append(CodedFetch(_strip_planes_u8(
                    color_acc, w_acc, g * SW, plan.out_h, SW)))
            else:
                strips.append(HostCopy(_strip_u8_i32(
                    color_acc, w_acc, g * SW, plan.out_h, SW)))
                count(down_bytes=plan.out_h * SW * 4,
                      down_plain_bytes=plan.out_h * SW * 4)
    with span("blend.download"):
        if coded:
            parts = [_planes_to_rgba(s.wait(), plan.out_h) for s in strips]
        else:
            parts = [s.wait().view(np.uint8).reshape(plan.out_h, SW, 4)
                     for s in strips]
        return np.concatenate(parts, axis=1)[:, : plan.out_w]


def _device_put_planar_coded(band: np.ndarray, dev) -> torch.Tensor:
    """Upload a [NI, H, W, 3] u8 band slice through the 4-bit wire codec:
    channel-planar rows ([NI*3*H, W], deltas never cross rows) encode in
    threaded C and decode on the device, then go back to [NI, H, W, 3]; a
    slice that defeats the nibble budget moves raw."""
    from ..io.wirecodec import upload_u8_rows

    ni, h, w, _ = band.shape
    planar = np.ascontiguousarray(np.moveaxis(band, 3, 1)).reshape(-1, w)
    return torch.movedim(upload_u8_rows(planar, dev).reshape(ni, 3, h, w),
                         1, 3)


def band_slice(imgs: np.ndarray, img_ids: np.ndarray, dev,
               coded: bool = False) -> torch.Tensor:
    """Upload the host images ``img_ids`` of a band ([NI, H, W, 3], u8 or
    f32) and return them x-paired in f32 on ``dev`` (u8 taken as v / 255,
    as the stitcher converts an uploaded stack).  ``coded``: a u8 slice goes
    through the wire codec (``_device_put_planar_coded``), with the same
    result."""
    host = np.ascontiguousarray(imgs[img_ids])
    if coded and imgs.dtype == np.uint8:
        band = _device_put_planar_coded(host, dev)
    else:
        band = torch.from_numpy(host).to(dev)
    band = band.to(torch.float32)
    if imgs.dtype == np.uint8:
        band = band / 255.0
    return pair_imgs_x(band)


def band_paired(imgs, img_ids: np.ndarray, dev,
                coded: bool = False) -> torch.Tensor:
    """A band's images x-paired in f32 on ``dev``: uploaded from a host
    stack (``band_slice``, the upload a test can count; through the wire
    codec when ``coded``), or gathered from a stack already on the device
    (u8 taken as v / 255 either way)."""
    if isinstance(imgs, np.ndarray):
        return band_slice(imgs, img_ids, dev, coded)
    band = imgs[torch.as_tensor(img_ids, device=imgs.device)]
    band = band.to(torch.float32)
    if imgs.dtype == torch.uint8:
        band = band / 255.0
    return pair_imgs_x(band)


def band_jobs_local(jobs, img_ids: np.ndarray):
    """A band's jobs with their image indices remapped into its slice."""
    return (np.searchsorted(img_ids, jobs[0]), *jobs[1:])


def _band_accumulate(imgs, jobs, plan: RenderPlan, g: int, ordered: bool,
                     TH: int, TW: int, Hp: int, SW: int, dev,
                     coded: bool = False):
    """Band g's jobs from its own images into a [Hp, SW + TW] (colour,
    weight) accumulator pair whose column 0 is canvas column g * SW
    (``coded``: a host slice uploads through the wire codec)."""
    c = torch.zeros(Hp, SW + TW, 3, dtype=torch.float32, device=dev)
    w = torch.zeros(Hp, SW + TW, dtype=torch.float32, device=dev)
    ids = np.unique(jobs[0])
    if len(ids):
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        _run_jobs(c, w, band_paired(imgs, ids, dev, coded),
                  f32(plan.homo_invs[ids]), f32(plan.whs[ids]),
                  band_jobs_local(jobs, ids), plan, ordered, TH, TW, g * SW)
    return c, w


def _spill(c, w, SW: int) -> torch.Tensor:
    """A band's spill columns past SW as one [Hp, TW, 4] (colour, weight)
    halo for the next band."""
    return torch.cat([c[:, SW:], w[:, SW:, None]], -1)


def _band_finish(c, w, halo, TW: int, SW: int, u8_out: bool):
    """Fold the previous band's spill ``halo`` (None: nothing spills in)
    into the head columns and normalize the strip: [Hp, SW, 3] f32
    (INVALID where empty), or with ``u8_out`` the download codec's planes
    [4*Hp, SW] u8 (``_strip_planes_u8``: the rounded colour, 255 and alpha
    0 where empty)."""
    if halo is not None:
        c[:, :TW] += halo[..., :3]
        w[:, :TW] += halo[..., 3]
    if u8_out:
        return _strip_planes_u8(c, w, 0, c.shape[0], SW)
    return _normalize(c[:, :SW], w[:, :SW])


def blend_linear_host_stream(imgs: np.ndarray, plan: RenderPlan,
                             ordered: bool, groups: int,
                             u8_out: bool = False,
                             coded_wire: bool | None = None,
                             device=None) -> np.ndarray:
    """Linear blend of an image stack that stays in host memory, on one
    device (``render.blend_linear_host_stream`` there): the canvas is cut
    into ``groups`` column bands of the in-memory blend's jobs, one slab per
    render item (``_tile_jobs(exact=True)``); band g uploads only the images
    its jobs read, blends them, adds the spill columns that band g-1
    carried over, and moves its finished strip to the host.  Device memory
    holds one band's images and one [Hp, SW + TW] accumulator pair,
    whatever the number of images.  The JAX package covers each item with
    256x256 tiles here; the port keeps the item slabs, 12x fewer jobs on
    the headline, since a job's cost on the card is mostly its host-side
    dispatch (PERF.md).  Jobs add in band order, then item order, and the
    halo after the band's own jobs, so the sum differs from the in-memory
    one only in f32 order.

    imgs: host numpy [N, H, W, 3], u8 or f32.  ``device``: the card unless
    another is named.  Returns the [out_h, out_w, 3] f32 canvas (INVALID
    where empty), or with ``u8_out`` the [out_h, out_w, 4] RGBA u8 canvas,
    whose strips move to the host through the download codec
    (``CodedFetch``), each waited for one band later, so that its device
    buffers go while the next band computes.  ``coded_wire`` (default: as
    ``u8_out``, for a u8 stack) uploads the band slices through the wire
    codec."""
    from ..io.wirecodec import CodedFetch
    from .stitcher import resolve_device

    dev = resolve_device(device)
    G, SW, Hp, Wp, TH, TW, band_jobs = _tile_jobs(plan, groups, exact=True)
    assert G == groups, (G, groups)
    if coded_wire is None:
        coded_wire = u8_out
    coded_wire = coded_wire and imgs.dtype == np.uint8
    halo, strips = None, []
    for g, jobs in enumerate(band_jobs):
        c, w = _band_accumulate(imgs, jobs, plan, g, ordered, TH, TW, Hp,
                                SW, dev, coded_wire)
        strip = _band_finish(c, w, halo, TW, SW, u8_out)
        halo = _spill(c, w, SW)
        if u8_out:
            strips.append(CodedFetch(strip))
            if len(strips) >= 2:
                strips[-2] = _planes_to_rgba(strips[-2].wait(), Hp)
        else:
            strips.append(strip[: plan.out_h].cpu().numpy())
    if u8_out:
        strips[-1] = _planes_to_rgba(strips[-1].wait(), Hp)
    return np.concatenate(strips, axis=1)[: plan.out_h, : plan.out_w]


def blend_linear_sharded(imgs, plan: RenderPlan, ordered: bool,
                         mesh) -> torch.Tensor:
    """The linear blend over the ranks of ``mesh``, one canvas column band
    each (``render.blend_linear_sharded`` there): rank g runs the band-g
    jobs of ``_tile_jobs(exact=True)`` (one slab per render item, as the
    host stream) into a [Hp, SW + TW] strip, sends its spill columns to rank
    g + 1, adds the halo rank g - 1 sent, normalizes its strip, and the
    strips are all-gathered into the canvas, which every rank returns
    ([out_h, out_w, 3] f32 on the rank's device, INVALID where empty).  A
    band-g job spills into strip g + 1 at most (SW >= TW), so one halo
    completes the sums; the arithmetic is the host stream's over the same
    bands, in the same order.

    imgs: a host numpy stack [N, H, W, 3] (u8 or f32): each rank uploads
    only its band's images (one ``band_slice`` call), so no rank holds the
    stack; or a stack on the rank's device, from which each band gathers
    its images."""
    from ..parallel.mesh import all_gather, halo_right, mesh_device

    nd, g, dev = mesh.size(), mesh.get_local_rank(), mesh_device(mesh)
    G, SW, Hp, Wp, TH, TW, band_jobs = _tile_jobs(plan, nd, exact=True)
    assert G == nd, (G, nd)
    c, w = _band_accumulate(imgs, band_jobs[g], plan, g, ordered, TH, TW, Hp,
                            SW, dev)
    halo = halo_right(mesh, _spill(c, w, SW), "blend")
    strip = _band_finish(c, w, halo, TW, SW, False)
    canvas = all_gather(mesh, strip.transpose(0, 1), "blend").transpose(0, 1)
    return canvas[: plan.out_h, : plan.out_w]


def blend(imgs: torch.Tensor, plan: RenderPlan, ordered: bool,
          multiband: int) -> torch.Tensor:
    """Blender dispatch (ConnectedImages::blend, stitcher_image.cc:131-136):
    the multiband blender with ``multiband`` levels when it is > 0, else
    the linear one (``OPENPANO_PACKED_GATHER=1``: on the packed form)."""
    if multiband > 0:
        from .multiband import blend_multiband

        return blend_multiband(imgs, plan, multiband)
    return blend_linear(imgs, plan, ordered, packed_gather=packed_gather())


def packed_gather() -> bool:
    """Whether the linear blend samples the packed int32 form:
    ``OPENPANO_PACKED_GATHER=1`` (off by default)."""
    return os.environ.get("OPENPANO_PACKED_GATHER", "0") == "1"


def f32_to_u8(canvas: torch.Tensor):
    """f32 canvas -> (u8 [H, W, 3], valid [H, W]): round-half-even of
    clip(c, 0, 1) * 255 where valid, 255 elsewhere (cvt_f2uc,
    imgproc.cc:328-337)."""
    valid = canvas[..., 0] >= 0
    u8 = torch.round(torch.clamp(canvas, 0.0, 1.0) * 255.0).to(torch.uint8)
    return torch.where(valid[..., None], u8, 255), valid
