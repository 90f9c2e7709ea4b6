"""A camera that yaws about its centre inside a textured cylinder: the
rotating-camera panorama (OpenPano's CMU0 sets).

Traffic parameters: ``n`` views of ``width`` x ``height`` px, ``hfov``
degrees wide, stepping ``hfov * (1 - overlap)`` with ``jitter`` (a share
of the step, normal) on each yaw; ``shuffle`` hands the views over in a
random order; ``texture`` [h, w] px cover the whole cylinder; ``pitch``
(degrees, 0 when absent) tilts the camera about its own x axis while it
yaws, as a hand-held sweep is tilted.  Each panorama starts at its own yaw
and draws its own jitter and order from (seed, index), over the run's one
texture.  The views are related by pure rotations R = R_y(yaw) R_x(pitch):
the truth of a pair is K R_a^T R_b K^-1.  At pitch 0 the views and truths
are those of the untilted code path, bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.scenes import (bilinear_wrap_x, device_generator, host_rng,
                              texture, to_u8)


def focal_px(p: dict) -> float:
    return (p["width"] / 2) / math.tan(math.radians(p["hfov"]) / 2)


def build(p: dict, seed: int, device):
    th, tw = p["texture"]
    return texture(th, tw, device_generator(seed, device), wrap=True)


def _rot_y(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rot_x(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def view_set(tex: torch.Tensor, p: dict, seed: int, index: int):
    n, w, h = p["n"], p["width"], p["height"]
    f = focal_px(p)
    step = math.radians(p["hfov"]) * (1 - p["overlap"])
    rng = host_rng(seed, index)
    start = rng.uniform(0, 2 * math.pi)
    yaws = start + (np.arange(n) - (n - 1) / 2) * step \
        + rng.normal(scale=p["jitter"] * step, size=n)
    order = rng.permutation(n) if p["shuffle"] else np.arange(n)
    # vertical half-extent of the cylinder in height / radius units
    vh = (h / 2) / f * 1.15 / 0.9
    dev = tex.device
    hs, ws = tex.shape[0], tex.shape[1]
    u = torch.arange(w, device=dev, dtype=torch.float32) - (w - 1) / 2.0
    v = torch.arange(h, device=dev, dtype=torch.float32) - (h - 1) / 2.0
    uu, vv = u[None, :], v[:, None]
    views = torch.empty((n, h, w, 3), dtype=torch.uint8, device=dev)
    pitch = math.radians(p.get("pitch", 0.0))
    if pitch:
        # the ray (u, v, f) tilted about the camera's x axis
        cp, sp = math.cos(pitch), math.sin(pitch)
        yt = cp * vv - sp * f
        zt = sp * vv + cp * f
    for slot, k in enumerate(order):
        c, s = math.cos(yaws[k]), math.sin(yaws[k])
        if pitch:
            xr = c * uu + s * zt
            zr = -s * uu + c * zt
            hgt = yt / torch.hypot(xr, zr)
        else:
            xr = c * uu + s * f
            zr = -s * uu + c * f
            hgt = vv / torch.hypot(xr, zr)
        ang = torch.atan2(xr, zr)
        sx = (ang / (2 * math.pi) + 0.5) * ws
        sy = (hgt / (2 * vh) + 0.5) * (hs - 1)
        views[slot] = to_u8(bilinear_wrap_x(tex, sy.expand(h, w),
                                            sx.expand(h, w)))
    # in half-shifted coordinates the principal point is at -0.5
    K = np.array([[f, 0, -0.5], [0, f, -0.5], [0, 0, 1.0]])
    Kinv = np.linalg.inv(K)
    slot_of = np.argsort(order)
    adjacent = []
    for k in range(n - 1):
        a, b = int(slot_of[k]), int(slot_of[k + 1])
        if pitch:
            R = [_rot_y(yaws[j]) @ _rot_x(pitch) for j in (k, k + 1)]
            T = K @ R[0].T @ R[1] @ Kinv
        else:
            T = K @ _rot_y(yaws[k + 1] - yaws[k]) @ Kinv
        adjacent.append((a, b, T / T[2, 2]))
    truth = {"focal_px": f, "yaws": yaws[order], "adjacent": adjacent,
             "size": (w, h)}
    return views, truth
