"""The plain reference of the features layer: OpenPano's SIFT, written from
its semantics in plain PyTorch, importing nothing of the port.

From the u8 views the benchmark made, it builds each view's scale space
(feature/dog.cc: the exact channel-sum grey, the bilinear resize to the
working size and to each octave, the truncated gaussians of
feature/gaussian.cc with replicated edges, the absolute DoG, the central
gradient's magnitude and orientation), finds the keypoints
(feature/extrema.cc: 26-neighbour extrema with a margin, up to
CALC_OFFSET_DEPTH Newton steps, the contrast and edge gates; the
configuration's caps kept as the first in scan order), and, for given
keypoints, their orientations (feature/orientation.cc: the 36-bin
histogram, smoothed, its peaks interpolated) and RootSIFT descriptors
(feature/sift.cc: the rotated 4 x 4 x 8 trilinear histogram).

Every function computes in the ``dtype`` it is given: float64 for the
reference, bfloat16 for the control (``judge.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# the configuration values the features read (``harness.settings_of``)
KEYS = ("SIFT_WORKING_SIZE", "NUM_OCTAVE", "NUM_SCALE", "SCALE_FACTOR",
        "GAUSS_SIGMA", "GAUSS_WINDOW_FACTOR", "CONTRAST_THRES",
        "JUDGE_EXTREMA_DIFF_THRES", "EDGE_RATIO", "PRE_COLOR_THRES",
        "CALC_OFFSET_DEPTH", "OFFSET_THRES", "ORI_RADIUS",
        "ORI_WINDOW_FACTOR", "ORI_HIST_BIN_NUM", "ORI_HIST_SMOOTH_COUNT",
        "ORI_HIST_PEAK_RATIO", "MAX_ORI_PER_KP", "DESC_HIST_SCALE_FACTOR",
        "DESC_HIST_WIDTH", "DESC_HIST_BIN_NUM", "DESC_INT_FACTOR",
        "MAX_CAND_PER_OCTAVE", "MAX_KP_PER_OCTAVE", "MAX_KP_PER_IMAGE")

KP_FIELDS = ("x", "y", "s", "scale_factor", "real_x", "real_y", "dir", "w",
             "h")


def working_size(w: int, h: int, target: int) -> tuple[int, int]:
    """(h, w) with (w + h) / 2 = target, floored (feature.cc:31-36)."""
    ratio = target * 2.0 / (w + h)
    return int(h * ratio), int(w * ratio)


def resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of [H, W] with half-pixel centres and clamped edges
    (lib/imgproc.cc:22-80)."""
    h, w = img.shape

    def axis(n_out, n_in):
        # coordinates in float64 whatever the dtype: only values round
        r = (torch.arange(n_out, device=img.device, dtype=torch.float64)
             + 0.5) * (n_in / n_out) - 0.5
        f = torch.floor(r)
        t = r - f
        t = torch.where(f < 0, torch.zeros_like(t),
                        torch.where(f + 1 >= n_in, torch.ones_like(t), t))
        return f.long().clamp(0, n_in - 2), t.to(img.dtype)

    sy, fy = axis(out_h, h)
    sx, fx = axis(out_w, w)
    fy, fx = fy[:, None], fx[None, :]
    r0, r1 = img[sy], img[sy + 1]
    top = (1 - fx) * r0[:, sx] + fx * r0[:, sx + 1]
    bot = (1 - fx) * r1[:, sx] + fx * r1[:, sx + 1]
    return (1 - fy) * top + fy * bot


def gauss_taps(sigma: float, factor: int, dtype, device) -> torch.Tensor:
    """The normalised taps of feature/gaussian.cc:17-40: the window
    ceil(0.3 (sigma / 2 - 1) + 0.8) * factor, forced odd."""
    kw = int(math.ceil(0.3 * (sigma / 2.0 - 1.0) + 0.8) * factor)
    kw += 1 - kw % 2
    i = np.arange(-(kw // 2), kw // 2 + 1, dtype=np.float64)
    k = np.exp(-(i * i) / (2.0 * sigma * sigma))
    return torch.as_tensor(k / k.sum(), dtype=dtype, device=device)


def blur(img: torch.Tensor, sigma: float, factor: int) -> torch.Tensor:
    """Separable gaussian blur of [H, W] with replicated edges."""
    taps = gauss_taps(sigma, factor, img.dtype, img.device).view(1, 1, -1)
    c = taps.shape[-1] // 2

    def rows(x):
        n = x.shape[-1]
        edge = torch.arange(-c, n + c, device=x.device).clamp(0, n - 1)
        return F.conv1d(x[:, None, edge], taps)[:, 0]

    return rows(rows(img.t()).t())


def mag_ort(level: torch.Tensor):
    """Central-difference gradient magnitude and orientation in [0, 2 pi],
    0 and pi on the one-pixel border (dog.cc:60-94)."""
    dx = torch.zeros_like(level)
    dy = torch.zeros_like(level)
    dx[1:-1, 1:-1] = level[1:-1, 2:] - level[1:-1, :-2]
    dy[1:-1, 1:-1] = level[2:, 1:-1] - level[:-2, 1:-1]
    inner = torch.zeros_like(level, dtype=torch.bool)
    inner[1:-1, 1:-1] = True
    mag = torch.where(inner, torch.sqrt(dx * dx + dy * dy),
                      torch.zeros_like(level))
    flat = torch.maximum(dx.abs(), dy.abs()) < 1e-6
    ort = torch.where(flat, torch.zeros_like(level), torch.atan2(dy, dx)
                      + math.pi)
    return mag, torch.where(inner, ort, torch.full_like(level, math.pi))


def scale_space(view_u8: torch.Tensor, s: dict, dtype) -> list[dict]:
    """The octaves of one u8 view [H, W, 3]: per octave its size and its
    NUM_SCALE levels' magnitude, orientation and the absolute DoG."""
    H, W = view_u8.shape[:2]
    grey = view_u8.to(torch.int32).sum(-1).to(dtype) / 765.0
    wh, ww = working_size(W, H, s["SIFT_WORKING_SIZE"])
    work = resize(grey, wh, ww)
    octaves = []
    for o in range(s["NUM_OCTAVE"]):
        f = s["SCALE_FACTOR"] ** (-o)
        oh, ow = (math.ceil(wh * f), math.ceil(ww * f)) if o else (wh, ww)
        base = work if o == 0 else resize(work, oh, ow)
        levels = [base]
        sigma = s["GAUSS_SIGMA"]
        for _ in range(1, s["NUM_SCALE"]):
            levels.append(blur(base, sigma, s["GAUSS_WINDOW_FACTOR"]))
            sigma *= s["SCALE_FACTOR"]
        g = torch.stack(levels)
        mo = [mag_ort(lv) for lv in levels]
        octaves.append({"w": ow, "h": oh, "dog": (g[:-1] - g[1:]).abs(),
                        "mag": torch.stack([m for m, _ in mo]),
                        "ort": torch.stack([a for _, a in mo])})
    return octaves


def _extrema(dog: torch.Tensor, s: dict) -> torch.Tensor:
    """[L, h, w] bool: strict 26-neighbour extrema by the margin, on the
    scanned levels 1..NUM_SCALE-3 and the interior (extrema.cc:170-216)."""
    thr = s["JUDGE_EXTREMA_DIFF_THRES"]
    L, h, w = dog.shape
    big = torch.finfo(dog.dtype).max
    pad = F.pad(dog[None, None], (1, 1, 1, 1, 1, 1), value=-big)[0, 0]
    padn = F.pad(-dog[None, None], (1, 1, 1, 1, 1, 1), value=-big)[0, 0]
    nmax = torch.full_like(dog, -big)
    nmin = torch.full_like(dog, -big)
    for ds in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if ds == dy == dx == 0:
                    continue
                sl = (slice(1 + ds, 1 + ds + L), slice(1 + dy, 1 + dy + h),
                      slice(1 + dx, 1 + dx + w))
                nmax = torch.maximum(nmax, pad[sl])
                nmin = torch.maximum(nmin, padn[sl])
    cand = (dog >= s["PRE_COLOR_THRES"]) & (
        (nmax < dog - thr) | (-nmin > dog + thr))
    scan = torch.zeros_like(cand)
    scan[1:s["NUM_SCALE"] - 2, 1:h - 1, 1:w - 1] = True
    return cand & scan


def detect(octaves: list[dict], s: dict) -> dict:
    """The keypoints of one view's scale space, as the configuration caps
    them: per octave the first MAX_CAND_PER_OCTAVE >> o extrema in scan
    order (level, row, column), the first MAX_KP_PER_OCTAVE >> o that
    survive refinement and the gates (each cap at least 128), then the
    first MAX_KP_PER_IMAGE over the octaves in order.  Returns
    ``KP_FIELDS`` but ``dir`` as [K] tensors; ``s`` folds the octave in
    (octave * NUM_SCALE + level) and ``w``, ``h`` are the octave's size."""
    ns = s["NUM_SCALE"]
    parts = []
    for o, oc in enumerate(octaves):
        dog = oc["dog"]
        h, w = dog.shape[1:]
        cap_c = max(s["MAX_CAND_PER_OCTAVE"] >> o, 128)
        cap_k = max(s["MAX_KP_PER_OCTAVE"] >> o, 128)
        idx = torch.nonzero(_extrema(dog, s).flatten()).flatten()[:cap_c]
        z, y, x = idx // (h * w), (idx // w) % h, idx % w
        kp = refine(dog, z, y, x, s)
        keep = torch.nonzero(kp.pop("ok")).flatten()[:cap_k]
        kp = {k: v[keep] for k, v in kp.items()}
        kp["s"] = kp["s"] + o * ns
        kp["w"] = torch.full_like(kp["x"], w)
        kp["h"] = torch.full_like(kp["x"], h)
        parts.append(kp)
    return {k: torch.cat([p[k] for p in parts])[:s["MAX_KP_PER_IMAGE"]]
            for k in parts[0]}


def refine(dog: torch.Tensor, z, y, x, s: dict) -> dict:
    """Newton refinement of the extrema at (z, y, x) on the quadratic fit
    of their 3 x 3 x 3 neighbourhood (extrema.cc:63-168): a step moves
    the point by the rounded offset, one inside OFFSET_THRES converges,
    leaving the levels or the interior or a singular Hessian fails; then
    the contrast gate at the interpolated value and the edge gate."""
    h, w = dog.shape[1:]
    ns = s["NUM_SCALE"]
    flat = dog.flatten()
    dt = dog.dtype

    def at(zz, yy, xx):
        return lambda a, b, c: flat[((zz + a) * h + yy + b) * w + xx + c]

    n = z.numel()
    done = torch.zeros(n, dtype=torch.bool, device=dog.device)
    fail = torch.zeros_like(done)
    off = torch.zeros(n, 3, dtype=dt, device=dog.device)
    grad_at = torch.zeros_like(off)
    for _ in range(s["CALC_OFFSET_DEPTH"]):
        live = ~done & ~fail
        inb = (x >= 1) & (x <= w - 2) & (y >= 1) & (y <= h - 2) \
            & (z >= 1) & (z <= ns - 3)
        fail |= live & ~inb
        live &= inb
        D = at(z.clamp(1, ns - 3), y.clamp(1, h - 2), x.clamp(1, w - 2))
        v = D(0, 0, 0)
        g = torch.stack([D(0, 0, 1) - D(0, 0, -1), D(0, 1, 0) - D(0, -1, 0),
                         D(1, 0, 0) - D(-1, 0, 0)], -1) / 2
        dxx = D(0, 0, 1) + D(0, 0, -1) - 2 * v
        dyy = D(0, 1, 0) + D(0, -1, 0) - 2 * v
        dss = D(1, 0, 0) + D(-1, 0, 0) - 2 * v
        dxy = (D(0, 1, 1) - D(0, -1, 1) - D(0, 1, -1) + D(0, -1, -1)) / 4
        dys = (D(1, 1, 0) - D(1, -1, 0) - D(-1, 1, 0) + D(-1, -1, 0)) / 4
        dsx = (D(1, 0, 1) - D(1, 0, -1) - D(-1, 0, 1) + D(-1, 0, -1)) / 4
        # H^-1 g by the adjugate of the symmetric Hessian (OpenPano's sign)
        c00, c01 = dyy * dss - dys * dys, dsx * dys - dxy * dss
        c02, c11 = dxy * dys - dsx * dyy, dxx * dss - dsx * dsx
        c12, c22 = dsx * dxy - dxx * dys, dxx * dyy - dxy * dxy
        det = dxx * c00 + dxy * c01 + dsx * c02
        solvable = det.abs() > 1e-18
        fail |= live & ~solvable
        live &= solvable
        inv = 1 / torch.where(solvable, det, torch.ones_like(det))
        step = torch.stack([c00 * g[:, 0] + c01 * g[:, 1] + c02 * g[:, 2],
                            c01 * g[:, 0] + c11 * g[:, 1] + c12 * g[:, 2],
                            c02 * g[:, 0] + c12 * g[:, 1] + c22 * g[:, 2]],
                           -1) * inv[:, None]
        conv = step.abs().amax(-1) < s["OFFSET_THRES"]
        newly = live & conv
        off = torch.where(newly[:, None], step, off)
        grad_at = torch.where(newly[:, None], g, grad_at)
        done |= newly
        move = live & ~conv
        r = torch.round(step).long()
        x = torch.where(move, x + r[:, 0], x)
        y = torch.where(move, y + r[:, 1], y)
        z = torch.where(move, z + r[:, 2], z)
    ok = done
    zc, yc, xc = z.clamp(1, ns - 3), y.clamp(1, h - 2), x.clamp(1, w - 2)
    D = at(zc, yc, xc)
    v = D(0, 0, 0)
    ok &= v + (off * grad_at).sum(-1) * 0.5 >= s["CONTRAST_THRES"]
    exx = D(0, 0, 1) + D(0, 0, -1) - 2 * v
    eyy = D(0, 1, 0) + D(0, -1, 0) - 2 * v
    exy = (D(0, 1, 1) + D(0, -1, -1) - D(0, -1, 1) - D(0, 1, -1)) / 4
    edet = exx * eyy - exy * exy
    r = s["EDGE_RATIO"]
    ok &= (edet > 0) & ((exx + eyy) ** 2 < (r + 1) ** 2 / r * edet)
    # positions in float64 whatever the dtype: only the offsets round
    off = off.double()
    sf = s["GAUSS_SIGMA"] * s["SCALE_FACTOR"] ** ((zc + off[:, 2]) / ns)
    return {"x": xc, "y": yc, "s": zc, "scale_factor": sf,
            "real_x": (xc + off[:, 0]) / w, "real_y": (yc + off[:, 1]) / h,
            "ok": ok}


def _round_half_away(v: torch.Tensor) -> torch.Tensor:
    return torch.floor(v.abs() + 0.5) * torch.sign(v)


def _planes(octaves, s: dict, name: str, dtype):
    """The octaves' planes stacked [O * NUM_SCALE, H0, W0], zero-padded."""
    H0, W0 = octaves[0]["h"], octaves[0]["w"]
    return torch.cat([F.pad(oc[name], (0, W0 - oc["w"], 0, H0 - oc["h"]))
                      for oc in octaves]).to(dtype)


def _window(kp: dict, lo: int, hi: int, mag, ort):
    """Each keypoint's window offsets [lo, hi]^2 (dy [1, n, 1], dx
    [1, 1, n]), the in-octave test and the planes' values there."""
    dev = mag.device
    S, H0, W0 = mag.shape
    d = torch.arange(lo, hi + 1, device=dev)
    py = kp["y"].view(-1, 1, 1) + d.view(1, -1, 1)
    px = kp["x"].view(-1, 1, 1) + d.view(1, 1, -1)
    inb = (px >= 1) & (px <= kp["w"].view(-1, 1, 1) - 2) & (py >= 1) \
        & (py <= kp["h"].view(-1, 1, 1) - 2)
    idx = (kp["s"].view(-1, 1, 1) * H0 + py.clamp(0, H0 - 1)) * W0 \
        + px.clamp(0, W0 - 1)
    dd = d.to(mag.dtype)
    return (dd.view(1, -1, 1), dd.view(1, 1, -1), inb,
            mag.flatten()[idx], ort.flatten()[idx])


def orientations(octaves, kp: dict, s: dict, dtype, chunk: int = 256):
    """Each keypoint's smoothed 36-bin orientation histogram [K, 36]
    (orientation.cc:47-75): radius round(scale_factor * ORI_RADIUS),
    offsets [-radius, radius - 1] inside the circle, weight
    exp(-r^2 / (2 (scale_factor * ORI_WINDOW_FACTOR)^2)) * magnitude,
    bin floor(ort * 36 / 2 pi + 0.5) mod 36."""
    nb = s["ORI_HIST_BIN_NUM"]
    mag = _planes(octaves, s, "mag", dtype)
    ort = _planes(octaves, s, "ort", dtype)
    rmax = int(_round_half_away(kp["scale_factor"] * s["ORI_RADIUS"])
               .max().item()) if kp["x"].numel() else 0
    out = []
    for lo in range(0, kp["x"].numel(), chunk):
        k = {n: v[lo:lo + chunk] for n, v in kp.items()}
        sf = k["scale_factor"].to(dtype).view(-1, 1, 1)
        rad = _round_half_away(sf * s["ORI_RADIUS"])
        dy, dx, inb, m, o = _window(k, -rmax, rmax - 1, mag, ort)
        r2 = dy * dy + dx * dx
        inside = inb & (dy >= -rad) & (dy <= rad - 1) & (dx >= -rad) \
            & (dx <= rad - 1) & (r2 <= rad * rad)
        sig = sf * s["ORI_WINDOW_FACTOR"]
        wt = torch.where(inside, torch.exp(-r2 / (2 * sig * sig)) * m,
                         torch.zeros_like(m))
        b = torch.floor(o * (nb / (2 * math.pi)) + 0.5).long() % nb
        hist = torch.zeros(wt.shape[0], nb, dtype=dtype, device=mag.device)
        hist.scatter_add_(1, b.flatten(1), wt.flatten(1))
        out.append(hist)
    hist = torch.cat(out) if out else torch.zeros(0, nb, dtype=dtype,
                                                  device=mag.device)
    for _ in range(s["ORI_HIST_SMOOTH_COUNT"]):
        hist = hist * 0.5 + (hist.roll(1, -1) + hist.roll(-1, -1)) * 0.25
    return hist


def peaks(hist: torch.Tensor, s: dict, slack: float = 0.0):
    """The histograms' peak directions (orientation.cc:77-98): bins above
    ORI_HIST_PEAK_RATIO of the largest and above both neighbours, each
    interpolated by its parabola.  Returns (dirs [K, 36] in [0, 2 pi),
    is_peak [K, 36]).  ``slack`` widens both tests by that share, for a
    program whose rounding sits at a test's edge."""
    nb = hist.shape[-1]
    prev, nxt = hist.roll(1, -1), hist.roll(-1, -1)
    thr = hist.amax(-1, keepdim=True) * s["ORI_HIST_PEAK_RATIO"]
    is_peak = (hist > thr * (1 - slack)) & (
        hist > torch.maximum(prev, nxt) * (1 - slack)) & (hist > 0)
    den = prev + nxt - 2 * hist
    den = torch.where(den == 0, -torch.ones_like(den), den)
    b = torch.arange(nb, device=hist.device, dtype=hist.dtype)
    nbin = (b - 0.5 + (hist - prev) / den) % nb
    return nbin / nb * 2 * math.pi, is_peak


def oriented(octaves, kp: dict, s: dict, dtype) -> dict:
    """The keypoints ``kp`` with a direction each: every peak of the
    histogram, the highest MAX_ORI_PER_KP of a keypoint in order (ties to
    the lower bin), and the first MAX_KP_PER_IMAGE over all."""
    hist = orientations(octaves, kp, s, dtype)
    dirs, is_peak = peaks(hist, s)
    M = s["MAX_ORI_PER_KP"]
    score = torch.where(is_peak, hist, -torch.ones_like(hist))
    vals, order = torch.sort(score, dim=-1, descending=True, stable=True)
    ok = (vals[:, :M] > 0).flatten()
    d = dirs.gather(1, order[:, :M]).flatten()
    src = torch.arange(hist.shape[0], device=hist.device).repeat_interleave(M)
    keep = torch.nonzero(ok).flatten()[:s["MAX_KP_PER_IMAGE"]]
    out = {n: v[src[keep]] for n, v in kp.items()}
    out["dir"] = d[keep]
    return out


def descriptors(octaves, kp: dict, s: dict, dtype,
                chunk: int = 128) -> torch.Tensor:
    """RootSIFT descriptors [K, 128] of oriented keypoints (sift.cc:37-152):
    radius round(sqrt(1/2) hist_w (W + 1)) with hist_w = scale_factor *
    DESC_HIST_SCALE_FACTOR, the offsets rotated into the direction and
    divided by hist_w, weight exp(-(x^2 + y^2) / (2 W^2)) * magnitude,
    trilinear into 4 x 4 places and 8 circular orientation bins; then
    divided by the sum, square-rooted and scaled by DESC_INT_FACTOR."""
    W4, NB = s["DESC_HIST_WIDTH"], s["DESC_HIST_BIN_NUM"]
    mag = _planes(octaves, s, "mag", dtype)
    ort = _planes(octaves, s, "ort", dtype)
    dev = mag.device
    hw_all = kp["scale_factor"].to(dtype) * s["DESC_HIST_SCALE_FACTOR"]
    rad_all = _round_half_away(math.sqrt(0.5) * hw_all * (W4 + 1))
    R = int(rad_all.max().item()) if kp["x"].numel() else 0
    grid4 = torch.arange(W4, device=dev, dtype=dtype)
    grid8 = torch.arange(NB, device=dev, dtype=dtype)
    hat = lambda v: torch.clamp(1 - v.abs(), min=0)
    out = []
    for lo in range(0, kp["x"].numel(), chunk):
        k = {n: v[lo:lo + chunk] for n, v in kp.items()}
        hw = hw_all[lo:lo + chunk].view(-1, 1, 1)
        rad = rad_all[lo:lo + chunk].view(-1, 1, 1)
        dy, dx, inb, m, o = _window(k, -R, R, mag, ort)
        dirv = k["dir"].to(dtype).view(-1, 1, 1)
        co, si = torch.cos(dirv), torch.sin(dirv)
        inside = inb & (dy.abs() <= rad) & (dx.abs() <= rad) \
            & (dy * dy + dx * dx <= rad * rad)
        xr = (dx * co + dy * si) / hw
        yr = (-dx * si + dy * co) / hw
        yb, xb = yr + W4 / 2 - 0.5, xr + W4 / 2 - 0.5
        inside &= (yb >= -1) & (yb <= W4 - 1) & (xb >= -1) & (xb <= W4 - 1)
        wt = torch.where(inside, torch.exp(-(xr * xr + yr * yr)
                                           / (2.0 * W4 * W4)) * m,
                         torch.zeros_like(m))
        now = torch.remainder(o - dirv, 2 * math.pi)
        hb = now * (NB / (2 * math.pi))
        C = wt.shape[0]
        A = hat(yb.flatten(1)[..., None] - grid4)
        B = hat(xb.flatten(1)[..., None] - grid4)
        do = (hb.flatten(1)[..., None] - grid8).abs()
        Co = hat(torch.minimum(do, NB - do))
        WAB = (wt.flatten(1)[..., None, None] * A[..., :, None]
               * B[..., None, :]).reshape(C, -1, W4 * W4)
        out.append(torch.einsum("cpq,cpo->cqo", WAB, Co).reshape(C, -1))
    hist = torch.cat(out) if out else torch.zeros(0, W4 * W4 * NB,
                                                  dtype=dtype, device=dev)
    tot = hist.sum(-1, keepdim=True)
    desc = torch.sqrt(hist / torch.where(tot > 0, tot, torch.ones_like(tot)))
    return torch.where(tot > 0, desc * s["DESC_INT_FACTOR"],
                       torch.zeros_like(desc))


def features(view_u8: torch.Tensor, s: dict, dtype) -> tuple[dict, object]:
    """What the features layer gives for one view, computed in ``dtype``:
    the oriented keypoints (``KP_FIELDS``) and their descriptors; the
    control puts this in the program's place."""
    octaves = scale_space(view_u8, s, dtype)
    kp = oriented(octaves, detect(octaves, s), s, dtype)
    return kp, descriptors(octaves, kp, s, dtype)
