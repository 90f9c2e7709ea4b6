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
``blend_linear`` followed by ``f32_to_u8`` bit for bit.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from ..ops.imgproc import INVALID, bilinear_prologue
from ..utils.timer import span
from .projection import PROJECTIONS

BLEND_GROUPS = 4


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
        else:
            items.append([i, *ranges[i].astype(int)])

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
    )


def _tile_jobs(plan: RenderPlan, groups: int, exact: bool = False):
    """Jobs partitioned into ``groups`` column bands by x-origin (a band-g
    job never writes columns < g*SW): one job per render item, a [TH, TW]
    slab at the item's bbox origin sized to the largest item bbox, with
    SW >= TW, so that a band-g job spills into strip g+1 at most.

    ``exact=True`` (the banded host-stream blends) keeps G == groups even
    when bands come out empty; otherwise G drops to 1 below 2 * groups
    items and shrinks until the last strip is non-empty.

    Returns (G, SW, Hp, Wp, TH, TW, band_jobs), band_jobs[g] =
    (img [J] int32, bbox [J,4] f32, origin [J,2] int32, item [J] int32),
    as the JAX package's ``_tile_jobs`` in its one-slab-per-item layout."""
    it = plan.items
    r = it[:, 1:5]
    TH = -(-int(np.maximum(r[:, 3] - r[:, 1], 1).max()) // 8) * 8
    TW = -(-int(np.maximum(r[:, 2] - r[:, 0], 1).max()) // 128) * 128
    oy_max = -(-plan.out_h // 8) * 8
    ox_max = -(-plan.out_w // 128) * 128
    Hp = oy_max + TH
    Wp = ox_max + TW

    G = groups if (exact or len(it) >= 2 * groups) else 1
    SW = -(-(-(-Wp // G)) // 128) * 128  # ceil(Wp/G) rounded up to 128
    SW = max(SW, TW)  # one job spills <= one strip
    if not exact:
        while (G - 1) * SW >= Wp:  # last strip must be non-empty
            G -= 1
    Wp = G * SW

    jobs: list[list[tuple]] = [[] for _ in range(G)]
    for s in range(len(it)):
        x0, y0 = r[s, :2]
        ox = min(max(int(x0), 0), ox_max)
        oy = min(max(int(y0), 0), oy_max)
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


def _run_jobs(color_acc: torch.Tensor, w_acc: torch.Tensor,
              imgs6: torch.Tensor, hinvs: torch.Tensor, whs: torch.Tensor,
              jobs, plan: RenderPlan, ordered: bool, TH: int, TW: int,
              x0: int = 0):
    """Add the jobs ``(img, bbox, origin, item)`` in their order into the
    (color [*, *, 3], weight) f32 accumulators, whose column 0 is canvas
    column ``x0``.  ``img`` indexes ``imgs6`` (x-paired, ``pair_imgs_x``),
    ``hinvs`` [*, 3, 3] and ``whs`` [*, 2]."""
    dev = imgs6.device
    _, proj2homo = PROJECTIONS[plan.proj]
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=dev)
    proj_min, res = f32(plan.proj_min), f32(plan.resolution)
    t_h = torch.arange(TH, dtype=torch.float32, device=dev)
    t_w = torch.arange(TW, dtype=torch.float32, device=dev)
    idx, rng, org = jobs[0], jobs[1], jobs[2]
    for k in range(len(idx)):
        i, (ox, oy) = int(idx[k]), (int(org[k, 0]), int(org[k, 1]))
        bx0, by0, bx1, by1 = (float(v) for v in rng[k])
        hinv, wh = hinvs[i], whs[i]
        sx, sy, z = _inverse_map(proj2homo, hinv, wh,
                                 (ox + t_w) * res[0] + proj_min[0],
                                 (oy + t_h) * res[1] + proj_min[1])
        color, ok = _sample_bilinear_paired(imgs6[i], sy, sx)
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
                 min_width: int = 0):
    """The in-memory blend's jobs in ``BLEND_GROUPS`` column bands: (G, SW,
    the (color [Hp, Wp, 3], weight [Hp, Wp]) f32 accumulators, at least
    ``min_width`` wide, run(g), which adds band g's jobs into them)."""
    G, SW, Hp, Wp, TH, TW, band_jobs = _tile_jobs(plan, BLEND_GROUPS)
    Wp = max(Wp, min_width)
    dev = imgs.device
    src = pair_imgs_x(imgs.to(torch.float32))
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


def blend_linear(imgs: torch.Tensor, plan: RenderPlan,
                 ordered: bool) -> torch.Tensor:
    """imgs: [N, H, W, 3] float in [0, 1] (INVALID marks empty pixels).
    Returns the [out_h, out_w, 3] f32 canvas, INVALID where nothing was
    rendered."""
    G, _, color_acc, w_acc, run = _band_runner(imgs, plan, ordered)
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
                           ordered: bool, groups: int = 4) -> np.ndarray:
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

    G, SW = _tile_jobs(plan, groups)[:2]
    GB, SWB, color_acc, w_acc, run = _band_runner(imgs, plan, ordered,
                                                  min_width=G * SW)
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
    the linear one."""
    if multiband > 0:
        from .multiband import blend_multiband

        return blend_multiband(imgs, plan, multiband)
    return blend_linear(imgs, plan, ordered)


def f32_to_u8(canvas: torch.Tensor):
    """f32 canvas -> (u8 [H, W, 3], valid [H, W]): round-half-even of
    clip(c, 0, 1) * 255 where valid, 255 elsewhere (cvt_f2uc,
    imgproc.cc:328-337)."""
    valid = canvas[..., 0] >= 0
    u8 = torch.round(torch.clamp(canvas, 0.0, 1.0) * 255.0).to(torch.uint8)
    return torch.where(valid[..., None], u8, 255), valid
