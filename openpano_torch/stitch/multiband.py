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

``blend_multiband_host_stream`` runs the same blend band by band from a
host image stack, with the cross-band terms carried from band to band;
``blend_multiband_sharded`` runs one band per rank, the cross-band terms
sent to the neighbouring ranks.

Planes live in one [M, Rh, Rw, 4] buffer, one per render item (a
wrap-straddling image contributes one item per canvas-edge strip), with
Rh / Rw the largest item bbox rounded up to 8 / 128 rows / columns as in
the JAX package.  Before each blur a plane's padding past its item's box
takes the box's last row and column (``_replicate_box_edges``), so the
blur replicates the item's own box edge as the reference's does
(gaussian.hh:52-60); the JAX package leaves the padding zero, and its
canvas departs from this one within the blurs' reach of an item's right
and bottom box edges.  Validity at every level is the first-level w>0
mask, as in the reference.  Items add into the canvas accumulators one
after the other in item order, so the f32 sums are the same on every
device (no atomics).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.gaussian import blur
from ..ops.imgproc import INVALID
from ..utils.timer import span, total_timer
from .projection import PROJECTIONS
from .render import RenderPlan, _sample_bilinear_paired, _tile_jobs, \
    band_jobs_local, band_paired, pair_imgs_x

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


def _box_sizes(ranges, rh: int, rw: int) -> np.ndarray:
    """[M, 2] (rows, columns) of each item's box (x0, y0, x1, y1) inside
    its [Rh, Rw] plane."""
    r = np.asarray(ranges, np.int64)
    return np.stack([np.clip(r[:, 3] - r[:, 1], 0, rh),
                     np.clip(r[:, 2] - r[:, 0], 0, rw)], 1)


def _replicate_box_edges(planes: torch.Tensor, sizes) -> torch.Tensor:
    """Fill each plane's padding past its item's box with the box's last
    row, then its last column, in place: the blur then sees the box's edge
    replicated (gaussian.hh:52-60), not the zeros of the shared layout.
    The accumulations read only in-box pixels, so they are unchanged."""
    rh, rw = planes.shape[1], planes.shape[2]
    for m, (h, w) in enumerate(sizes):
        if h == 0 or w == 0:
            continue
        if h < rh:
            planes[m, h:, :w] = planes[m, h - 1 : h, :w]
        if w < rw:
            planes[m, :, w:] = planes[m, :, w - 1 : w]
    return planes


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
    with INVALID where empty.  Two stage timers (each waits for the card at
    its end): ``multiband.first_level`` (the planes and the seam) and
    ``multiband.levels`` (the band loop and the clamp), with the spans
    ``multiband.blur`` and ``multiband.accumulate`` of each level inside."""
    dev = imgs.device
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=dev)
    rh, rw = _roi_sizes(plan)
    ranges = plan.items[:, 1:5]
    sizes = _box_sizes(ranges, rh, rw)
    with total_timer("multiband.first_level"):
        planes = _first_level(
            pair_imgs_x(imgs.to(torch.float32)), f32(plan.homo_invs),
            f32(plan.whs), plan.items[:, 0], ranges, f32(plan.proj_min),
            f32(plan.resolution), plan.proj, rh, rw)
        valid = (planes[..., 3] > 0).to(torch.float32)
        planes = _winner_take_all(planes, ranges, plan.out_h, plan.out_w)

    with total_timer("multiband.levels"):
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
                with span("multiband.blur", f"level {level}"):
                    nxt = blur(_replicate_box_edges(cur, sizes).movedim(-1, 1),
                               sigma).movedim(1, -1)
            with span("multiband.accumulate", f"level {level}"):
                target, visited = _accumulate_level(
                    cur, nxt, valid, ranges, target, visited, plan.out_h,
                    plan.out_w, is_last)
            cur = nxt
        return torch.where(visited[..., None], torch.clamp(target, 0.0, 1.0),
                           INVALID)


# min-item-id sentinel of the seam state (no item has this id)
_NO_ITEM = 1 << 30


def _band_planes(imgs, plan: RenderPlan, jobs, rh: int, rw: int,
                 dev) -> torch.Tensor:
    """First-level planes [J, Rh, Rw, 4] of a band's items from its own
    images (``band_paired``: uploaded from a host stack, or gathered from
    one on the device); each RoI grid starts at the item's placement
    origin, as there."""
    ids = np.unique(jobs[0])
    if not len(ids):
        return torch.zeros(0, rh, rw, 4, dtype=torch.float32, device=dev)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                    device=dev)
    idx = band_jobs_local(jobs, ids)[0]
    return _first_level(band_paired(imgs, ids, dev), f32(plan.homo_invs[ids]),
                        f32(plan.whs[ids]), idx, _band_ranges(jobs),
                        f32(plan.proj_min), f32(plan.resolution), plan.proj,
                        rh, rw)


def _band_ranges(jobs) -> np.ndarray:
    """[J, 4] (x0, y0, x1, y1) of a band's items, each box starting at the
    item's placement origin."""
    return np.concatenate([jobs[2], jobs[1][:, 2:]], 1).astype(np.int64)


def _fold_seam(maxw: torch.Tensor, minid: torch.Tensor, w: torch.Tensor,
               wid):
    """Fold weights ``w`` of item (or per-pixel item id) ``wid`` into the
    seam state (max weight, min item id among those attaining it) in
    place: the in-memory first-attainer rule, whatever the fold order."""
    tie = (w == maxw) & (w > 0)
    minid.copy_(torch.where(w > maxw, wid, torch.where(
        tie, torch.clamp(minid, max=wid), minid)))
    torch.maximum(maxw, w, out=maxw)


def _fold_band_items(planes: torch.Tensor, org, gid, maxw: torch.Tensor,
                     minid: torch.Tensor, rh: int, rw: int):
    """Fold a band's items, at origins ``org`` of the seam frame, in."""
    for i, ((ox, oy), g) in enumerate(zip(org, gid)):
        _fold_seam(maxw[oy : oy + rh, ox : ox + rw],
                   minid[oy : oy + rh, ox : ox + rw], planes[i, ..., 3],
                   int(g))


def _mb_host_band_step(planes: torch.Tensor, org, gid, sizes,
                       minid: torch.Tensor, halo, band_level: int, Hp: int,
                       SW: int, rh: int, rw: int):
    """One column band of the host-stream (and sharded) multiband blend.
    The band's items sit at strip-local origins ``org`` in a [Hp, SW + rw]
    frame, their boxes ``sizes`` (``_box_sizes``) in their planes;
    ``minid`` is the canvas seam's winner over that frame.  At each
    level ``halo(level, spill)`` hands on this band's (sum w * band, sum w)
    over the last rw columns, [Hp, rw, 4], and returns band g-1's over the
    first rw (None: nothing spills in), which is added after the band's
    own items.  Per-item blurs are item-local, so the band decomposition
    is exact up to the f32 order of the halo additions.  Returns the strip
    [Hp, SW, 3] f32, INVALID where empty."""
    dev = minid.device
    BW = SW + rw
    J = len(gid)
    slab = lambda a, i: a[org[i, 1] : org[i, 1] + rh,
                          org[i, 0] : org[i, 0] + rw]
    valid = (planes[..., 3] > 0).to(torch.float32)
    for i in range(J):
        won = (slab(minid, i) == int(gid[i])) & (planes[i, ..., 3] > 0)
        planes[i, ..., 3] = won.to(torch.float32)

    target = torch.zeros(Hp, SW, 3, dtype=torch.float32, device=dev)
    visited = torch.zeros(Hp, SW, dtype=torch.bool, device=dev)
    cur = planes
    for level in range(band_level):
        is_last = level == band_level - 1
        if is_last or J == 0:
            nxt = cur
        else:
            sigma = float(np.sqrt(level * 2 + 1.0) * 4)
            nxt = blur(_replicate_box_edges(cur, sizes).movedim(-1, 1),
                       sigma).movedim(1, -1)
        isum = torch.zeros(Hp, BW, 3, dtype=torch.float32, device=dev)
        wsum = torch.zeros(Hp, BW, dtype=torch.float32, device=dev)
        for i in range(J):
            w = cur[i, ..., 3] * valid[i]
            band = cur[i, ..., :3]
            if not is_last:
                band = band - nxt[i, ..., :3]
            slab(isum, i).add_(band * w[..., None])
            slab(wsum, i).add_(w)
        got = halo(level, torch.cat([isum[:, SW:], wsum[:, SW:, None]], -1))
        if got is not None:
            isum[:, :rw] += got[..., :3]
            wsum[:, :rw] += got[..., 3]
        isum, wsum = isum[:, :SW], wsum[:, :SW]
        has = wsum >= EPS
        contrib = torch.where(has[..., None],
                              isum / torch.clamp(wsum, min=EPS)[..., None],
                              0.0)
        target = torch.where((has & ~visited)[..., None], contrib,
                             torch.where(has[..., None], target + contrib,
                                         target))
        visited = visited | has
        cur = nxt
    return torch.where(visited[..., None], torch.clamp(target, 0.0, 1.0),
                       INVALID)


def blend_multiband_host_stream(imgs: np.ndarray, plan: RenderPlan,
                                band_level: int, groups: int,
                                device=None) -> np.ndarray:
    """Multiband blend of an image stack that stays in host memory, on one
    device (``multiband.blend_multiband_host_stream`` there).  Render items
    are assigned to ``groups`` column bands by their RoI origin
    (``_tile_jobs(exact=True)``, strip width >= Rw, so an item's RoI spills
    into the next band at most).  Two passes over the
    bands, each uploading only a band's images:
      1. the seam: every item's first-level weights fold into one canvas
         frame of (max weight, min item id), the in-memory first-attainer
         rule whatever the order;
      2. the levels: each band's strip blends with the seam's winners and
         carries one additive halo per level to the next band
         (``_mb_host_band_step``).
    The JAX package carries the seam as a halo too, which leaves an item
    that spills into the next band blind to that band's items (ROADMAP
    Queue 3); the first pass makes the seam the in-memory one.  Device
    memory holds one band's images, its [J, Rh, Rw, 4] planes, the strip
    accumulators and the seam frame, whatever the number of images.

    imgs: host numpy [N, H, W, 3], u8 or f32.  ``device``: the card unless
    another is named.  Returns the [out_h, out_w, 3] f32 canvas (host,
    INVALID where empty)."""
    from .stitcher import resolve_device

    dev = resolve_device(device)
    rh, rw = _roi_sizes(plan)
    G, SW, Hp, Wp, TH, TW, band_jobs = _tile_jobs(plan, groups, exact=True)
    assert G == groups and SW >= rw, (G, groups, SW, rw)

    maxw = torch.zeros(Hp, Wp + rw, dtype=torch.float32, device=dev)
    minid = torch.full((Hp, Wp + rw), _NO_ITEM, dtype=torch.int32, device=dev)
    for jobs in band_jobs:
        _fold_band_items(_band_planes(imgs, plan, jobs, rh, rw, dev),
                         jobs[2], jobs[3], maxw, minid, rh, rw)
    del maxw

    lvl = [torch.zeros(Hp, rw, 4, dtype=torch.float32, device=dev)
           for _ in range(band_level)]

    def carry(level, spill):
        # band g-1's spill in, band g's out for band g+1
        got, lvl[level] = lvl[level], spill
        return got

    strips = []
    for g, jobs in enumerate(band_jobs):
        org = jobs[2].astype(np.int64) - [g * SW, 0]     # strip-local
        strip = _mb_host_band_step(
            _band_planes(imgs, plan, jobs, rh, rw, dev), org, jobs[3],
            _box_sizes(_band_ranges(jobs), rh, rw),
            minid[:, g * SW : (g + 1) * SW + rw], carry, band_level, Hp, SW,
            rh, rw)
        strips.append(strip[: plan.out_h].cpu().numpy())
    return np.concatenate(strips, axis=1)[:, : plan.out_w]


def blend_multiband_sharded(imgs, plan: RenderPlan, band_level: int,
                            mesh) -> torch.Tensor:
    """The multiband blend over the ranks of ``mesh``, one canvas column band
    each (``multiband.blend_multiband_sharded`` there), on the bands and
    band step of the host stream.  Rank g takes the render items whose RoI
    origin lies in its band (``_tile_jobs(exact=True)``, SW >= Rw, so an
    item spills into band g + 1 at most) and uploads (or gathers) only
    their images.

      1. The seam: rank g folds its items into a [Hp, SW + Rw] frame of (max
         weight, min item id), sends the spill columns right, folds the
         ones it receives into its head columns, and sends the combined
         head back left, where it replaces the sender's spill columns.
         Only bands g - 1 and g reach band g's head columns, so every
         column then holds the fold of every item that covers it: the
         in-memory seam, which the JAX package's one-way halo is not
         (ROADMAP Queue 3).
      2. The levels: ``_mb_host_band_step``, each level's spill sent right
         as an additive halo.
    The strips are all-gathered: every rank returns the [out_h, out_w, 3]
    canvas (f32 on its device, INVALID where empty).  Device memory per
    rank holds one band's images, planes and frames.

    imgs: a host numpy stack [N, H, W, 3] (u8 or f32), or a stack on the
    rank's device."""
    from ..parallel.mesh import all_gather, halo_left, halo_right, \
        mesh_device

    nd, g, dev = mesh.size(), mesh.get_local_rank(), mesh_device(mesh)
    rh, rw = _roi_sizes(plan)
    G, SW, Hp, Wp, TH, TW, band_jobs = _tile_jobs(plan, nd, exact=True)
    assert G == nd and SW >= rw, (G, nd, SW, rw)
    jobs = band_jobs[g]
    org = jobs[2].astype(np.int64) - [g * SW, 0]         # strip-local
    planes = _band_planes(imgs, plan, jobs, rh, rw, dev)

    maxw = torch.zeros(Hp, SW + rw, dtype=torch.float32, device=dev)
    minid = torch.full((Hp, SW + rw), _NO_ITEM, dtype=torch.int32,
                       device=dev)
    _fold_band_items(planes, org, jobs[3], maxw, minid, rh, rw)
    # the weights' f32 bits travel as int32 beside the ids: one message
    got = halo_right(mesh, torch.stack([maxw[:, SW:].view(torch.int32),
                                        minid[:, SW:]], -1), "blend")
    if got is not None:
        _fold_seam(maxw[:, :rw], minid[:, :rw],
                   got[..., 0].contiguous().view(torch.float32), got[..., 1])
    back = halo_left(mesh, minid[:, :rw], "blend")
    if back is not None:
        minid[:, SW:] = back
    del maxw

    strip = _mb_host_band_step(
        planes, org, jobs[3], _box_sizes(_band_ranges(jobs), rh, rw), minid,
        lambda level, spill: halo_right(mesh, spill, "blend"), band_level,
        Hp, SW, rh, rw)
    canvas = all_gather(mesh, strip.transpose(0, 1), "blend").transpose(0, 1)
    return canvas[: plan.out_h, : plan.out_w]
