"""The plain reference that decides ``correct``: plain PyTorch and NumPy,
written from OpenPano's semantics, importing nothing of the port.

It works out again, at the timed sizes, what each stage of a stitch must
give for the inputs that stage got, and compares:

- ``match``: the mutual 2-NN ratio-test matching of each matched pair
  (matcher.cc:100-125: forward ratio, mutual best, reverse ratio against
  the target's second neighbour, the first ``M`` queries kept in order);
- ``refit``: the least-squares fit of a pair's transform to its inliers
  with the scale-only normalisation of transform_estimate.cc:99-129
  (perspective with h22 = 1, or affine);
- ``plan`` and ``blend_linear``: the canvas of the final transforms
  (stitcher_image.cc:41-114: 400 border samples an image, the identity
  image at its native resolution, the MAX_OUTPUT_SIZE downscale, images
  across the +-pi seam split at it) and LinearBlender's weighted sum
  (blender.cc:27-36), rounded to u8 half to even;
- geometry against the truth the scene generator made.

Each function takes the precision it computes in: float64 for the
reference, a lower one for the control (``PERF.md``, "How correct is
decided").  A configuration names its reference module (its file's
``"reference"``, this module's name by default); another module with the
same functions can stand beside this one for a configuration whose stages
differ.
"""

from __future__ import annotations

import numpy as np
import torch

PAD_DIST = 1e19


def _top2(d: torch.Tensor):
    """Indices of the two smallest along the last axis, first on ties."""
    i1 = torch.argmin(d, -1)
    masked = d.scatter(-1, i1[..., None], float("inf"))
    return i1, torch.argmin(masked, -1)


def _rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return a.gather(1, idx[..., None].expand(-1, -1, a.shape[-1]))


def match_pairs(desc: torch.Tensor, valid: torch.Tensor, ii, jj,
                ratio: float, max_matches: int, dtype=torch.float64,
                chunk: int = 16) -> list[torch.Tensor]:
    """For each pair (ii[p], jj[p]), the accepted matches as int64 codes
    ``query * K + target`` (query in image ii[p], target in jj[p]), the
    first ``max_matches`` queries in order.  desc [N, K, 128], valid
    [N, K]; the distances in ``dtype``."""
    K = desc.shape[1]
    r2 = float(np.float32(ratio * ratio))
    out = []
    for lo in range(0, len(ii), chunk):
        i = torch.as_tensor(ii[lo:lo + chunk], device=desc.device)
        j = torch.as_tensor(jj[lo:lo + chunk], device=desc.device)
        da, db = desc[i].to(dtype), desc[j].to(dtype)
        va, vb = valid[i], valid[j]
        na = torch.where(va, (da * da).sum(-1), PAD_DIST)
        nb = torch.where(vb, (db * db).sum(-1), PAD_DIST)
        d2 = na[:, :, None] + nb[:, None, :] \
            - 2 * torch.matmul(da, db.transpose(1, 2))
        d2 = torch.clamp(d2, min=0)
        f1, f2 = _top2(d2)
        r1, r2nd = _top2(d2.transpose(1, 2))
        del d2
        fd1 = ((da - _rows(db, f1)) ** 2).sum(-1)
        fd2 = ((da - _rows(db, f2)) ** 2).sum(-1)
        rd2 = ((db - _rows(da, r2nd)) ** 2).sum(-1)
        q = torch.arange(K, device=desc.device)
        ok = fd1 <= r2 * fd2
        ok &= r1.gather(1, f1) == q
        ok &= fd1 <= r2 * rd2.gather(1, f1)
        ok &= va & vb.gather(1, f1) & vb.gather(1, f2)
        for p in range(ok.shape[0]):
            qs = torch.nonzero(ok[p]).flatten()[:max_matches]
            out.append(qs * K + f1[p, qs])
    return out


def refit(to_pos: np.ndarray, from_pos: np.ndarray, w: np.ndarray,
          affine: bool, dtype=torch.float64, device="cpu") -> np.ndarray:
    """Least-squares transforms [P, 3, 3] mapping ``from_pos`` onto
    ``to_pos`` ([P, M, 2] each) over the rows where ``w`` [P, M] is set:
    each point set scaled by sqrt(2 / mean |p|^2), the normal equations
    (with a 1e-9 ridge) formed in ``dtype`` and solved, the fit scaled
    back.  Returned as float64."""
    p1 = torch.as_tensor(to_pos, device=device, dtype=torch.float64)
    p2 = torch.as_tensor(from_pos, device=device, dtype=torch.float64)
    wt = torch.as_tensor(w, device=device, dtype=torch.float64)
    cnt = torch.clamp(wt.sum(-1), min=1.0)

    def scale(p):
        ms = ((p * p).sum(-1) * wt).sum(-1) / cnt
        return torch.sqrt(2.0 / torch.clamp(ms, min=1e-12))

    s1, s2 = scale(p1), scale(p2)
    q1 = (p1 * s1[:, None, None]).to(dtype)
    q2 = (p2 * s2[:, None, None]).to(dtype)
    x1, y1, x2, y2 = q1[..., 0], q1[..., 1], q2[..., 0], q2[..., 1]
    z, o = torch.zeros_like(x1), torch.ones_like(x1)
    if affine:
        rx = torch.stack([x2, y2, o, z, z, z], -1)
        ry = torch.stack([z, z, z, x2, y2, o], -1)
    else:
        rx = torch.stack([x2, y2, o, z, z, z, -x2 * x1, -y2 * x1], -1)
        ry = torch.stack([z, z, z, x2, y2, o, -x2 * y1, -y2 * y1], -1)
    A = torch.cat([rx, ry], 1)
    b = torch.cat([x1, y1], 1)
    ww = torch.cat([wt, wt], 1).to(dtype)
    Aw = A * ww[..., None]
    AtA = torch.matmul(Aw.transpose(1, 2), A)
    Atb = torch.matmul(Aw.transpose(1, 2), b[..., None])[..., 0]
    n = A.shape[-1]
    AtA = AtA.to(torch.float64) + 1e-9 * torch.eye(n, dtype=torch.float64,
                                                   device=device)
    h = torch.linalg.solve(AtA, Atb.to(torch.float64))
    P = h.shape[0]
    if affine:
        Hn = torch.cat([h, torch.tensor([0.0, 0.0, 1.0], dtype=h.dtype,
                                        device=device).expand(P, 3)], 1)
    else:
        Hn = torch.cat([h, torch.ones(P, 1, dtype=h.dtype, device=device)], 1)
    Hn = Hn.view(P, 3, 3)
    one = torch.ones_like(s1)
    left = torch.diag_embed(torch.stack([1 / s1, 1 / s1, one], -1))
    right = torch.diag_embed(torch.stack([s2, s2, one], -1))
    return (left @ Hn @ right).cpu().numpy()


def apply_h(H: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Points [..., 2] through the homography H [3, 3] (or [..., 3, 3])."""
    hp = np.concatenate([pts, np.ones(pts.shape[:-1] + (1,))], -1)
    q = np.einsum("...ij,...nj->...ni", H, hp)
    return q[..., :2] / q[..., 2:3]


# ---------------------------------------------------------------- canvas

def _homo2proj(proj: str, h: np.ndarray) -> np.ndarray:
    x, y, z = h[..., 0], h[..., 1], h[..., 2]
    if proj == "flat":
        return np.stack([x / z, y / z], -1)
    return np.stack([np.arctan2(x, z), np.arctan2(y, np.hypot(x, z))], -1)


def plan(homos: np.ndarray, whs: np.ndarray, identity: int, proj: str,
         max_output_size: int) -> dict:
    """The canvas of the transforms ``homos`` [N, 3, 3] (half-shifted
    image px to the identity frame): its size, the projection-plane origin
    and resolution, and the render items (image, x0, y0, x1, y1)."""
    n = homos.shape[0]
    t = np.arange(100) / 100.0 - 0.5
    border = np.concatenate([
        np.stack([t, np.full(100, -0.5)], -1),
        np.stack([t, np.full(100, 0.5)], -1),
        np.stack([np.full(100, -0.5), t], -1),
        np.stack([np.full(100, 0.5), t], -1)])
    pps = []
    for i in range(n):
        hpt = np.concatenate([border * whs[i], np.ones((400, 1))], -1) \
            @ homos[i].T
        pps.append(_homo2proj(proj, hpt))
    lo = np.min([pp.min(0) for pp in pps], 0)
    hi = np.max([pp.max(0) for pp in pps], 0)
    refw, refh = whs[identity]
    Hi = homos[identity]
    span = (_homo2proj(proj, Hi @ np.array([refw / 2.0, refh / 2.0, 1.0]))
            - _homo2proj(proj, Hi @ np.array([-refw / 2.0, -refh / 2.0,
                                               1.0])))
    if proj != "flat":
        if span[0] < 0:
            span[0] += 2 * np.pi
        if span[1] < 0:
            span[1] += np.pi
    res = np.abs(span) / np.array([refw, refh])
    target = (hi - lo) / res
    if target.max() > 80000 or target[0] * target[1] > 1e9:
        raise RuntimeError("canvas too large: a stitching failure")
    if target.max() > max_output_size:
        res = res * (target.max() / max_output_size)
    size = ((hi - lo) / res).astype(int)
    items = []
    for i, pp in enumerate(pps):
        parts = [pp]
        if proj != "flat" and pp[:, 0].max() - pp[:, 0].min() > np.pi:
            parts = [pp[pp[:, 0] < 0], pp[pp[:, 0] >= 0]]
        for part in parts:
            if len(part) == 0:
                continue
            tl = ((part.min(0) - lo) / res).astype(int)
            br = ((part.max(0) - lo) / res).astype(int)
            items.append((i, tl[0], tl[1], min(br[0], size[0]),
                          min(br[1], size[1])))
    return {"proj": proj, "out_w": int(size[0]), "out_h": int(size[1]),
            "proj_min": lo, "resolution": res, "items": items,
            "homo_invs": np.linalg.inv(homos), "whs": whs}


def blend(views: torch.Tensor, pl: dict, settings: dict,
          dtype=torch.float64):
    """The configuration's blender over the plan ``pl``: the linear one
    (a configuration with another blender names its own reference
    module)."""
    return blend_linear(views, pl, settings["ORDERED_INPUT"], dtype)


def blend_linear(views: torch.Tensor, pl: dict, ordered: bool,
                 dtype=torch.float64, rows: int = 512):
    """LinearBlender over the plan ``pl``: each canvas pixel of an item's
    box lifted to a ray, mapped into the image, sampled bilinearly (all
    four taps inside), weighted by (0.5 - |x/w - 0.5|) and, for unordered
    input, by the same in y; the weighted mean rounded to u8 half to
    even.  views: [N, H, W, 3] u8 on the device.  Returns (u8 [h, w, 3],
    valid [h, w]) on the device; 255 where nothing lands."""
    dev = views.device
    H_, W_ = pl["out_h"], pl["out_w"]
    color = torch.zeros(H_, W_, 3, dtype=dtype, device=dev)
    wsum = torch.zeros(H_, W_, dtype=dtype, device=dev)
    lo = torch.as_tensor(pl["proj_min"], dtype=dtype, device=dev)
    res = torch.as_tensor(pl["resolution"], dtype=dtype, device=dev)
    for i, x0, y0, x1, y1 in pl["items"]:
        if x1 <= x0 or y1 <= y0:
            continue
        img = views[i].to(dtype) / 255.0
        h, w = img.shape[0], img.shape[1]
        hinv = torch.as_tensor(pl["homo_invs"][i], dtype=dtype, device=dev)
        cx = torch.arange(x0, x1, device=dev).to(dtype) * res[0] + lo[0]
        for r0 in range(y0, y1, rows):
            r1 = min(r0 + rows, y1)
            cy = torch.arange(r0, r1, device=dev).to(dtype) * res[1] + lo[1]
            px, py = torch.broadcast_tensors(cx[None, :], cy[:, None])
            if pl["proj"] == "flat":
                ray = (px, py, torch.ones_like(px))
            else:
                ray = (torch.sin(px), torch.tan(py), torch.cos(px))
            m = [ray[0] * hinv[d, 0] + ray[1] * hinv[d, 1]
                 + ray[2] * hinv[d, 2] for d in range(3)]
            z = m[2]
            zs = torch.where(z.abs() > 1e-20, z, torch.full_like(z, 1e-20))
            # a point that maps nowhere (at a low precision) is outside
            sx = torch.nan_to_num(m[0] / zs + w * 0.5, -1.0, -1.0, -1.0)
            sy = torch.nan_to_num(m[1] / zs + h * 0.5, -1.0, -1.0, -1.0)
            fx, fy = torch.floor(sx), torch.floor(sy)
            inb = (fx >= 0) & (fy >= 0) & (fx + 1 <= w - 1) & (fy + 1 <= h - 1)
            # clamped as integers: a low precision rounds the bound itself
            ix = torch.clamp(fx.long(), 0, w - 2)
            iy = torch.clamp(fy.long(), 0, h - 2)
            rx = (sx - fx)[..., None]
            ry = (sy - fy)[..., None]
            top = img[iy, ix] * (1 - rx) + img[iy, ix + 1] * rx
            bot = img[iy + 1, ix] * (1 - rx) + img[iy + 1, ix + 1] * rx
            c = top * (1 - ry) + bot * ry
            wt = 0.5 - torch.abs(sx / w - 0.5)
            if not ordered:
                wt = wt * (0.5 - torch.abs(sy / h - 0.5))
            wt = torch.where(inb & (z > 0), wt, torch.zeros_like(wt))
            color[r0:r1, x0:x1] += c * wt[..., None]
            wsum[r0:r1, x0:x1] += wt
    has = wsum > 0
    mean = color.to(torch.float64) / torch.where(has, wsum, 1).to(
        torch.float64)[..., None]
    u8 = torch.round(torch.clamp(mean, 0, 1) * 255).to(torch.uint8)
    return torch.where(has[..., None], u8, 255), has
