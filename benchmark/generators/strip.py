"""A camera translated along a textured plane: a scanned strip or a UAV
pass (OpenPano's TRANS mode).

Traffic parameters: ``n`` views of ``width`` x ``height`` px, each
``width * (1 - overlap)`` px right of the last with up to ``jitter_x`` /
``jitter_y`` px of uniform jitter; ``texture`` [h, w] px, periodic in x.
Each panorama starts at its own offset along the run's one texture, so
each strip is a different crop.  The views are integer crops: the truth of
a pair is a translation.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.scenes import device_generator, host_rng, texture, to_u8


def build(p: dict, seed: int, device):
    th, tw = p["texture"]
    return to_u8(texture(th, tw, device_generator(seed, device), wrap=True))


def view_set(tex: torch.Tensor, p: dict, seed: int, index: int):
    n, w, h = p["n"], p["width"], p["height"]
    th, tw = tex.shape[0], tex.shape[1]
    step = int(w * (1 - p["overlap"]))
    rng = host_rng(seed, index)
    start = int(rng.integers(0, tw))
    jx, jy = p["jitter_x"], p["jitter_y"]
    xs = start + jx + np.arange(n) * step + rng.integers(-jx, jx + 1, n)
    ys = jy + rng.integers(-jy, jy + 1, n)
    if ys.max() + h > th:
        raise ValueError("texture too short for the views and their jitter")
    cols = torch.remainder(
        torch.as_tensor(xs, device=tex.device)[:, None]
        + torch.arange(w, device=tex.device), tw)               # [n, w]
    rows = torch.as_tensor(ys, device=tex.device)[:, None] \
        + torch.arange(h, device=tex.device)                     # [n, h]
    views = tex[rows[:, :, None], cols[:, None, :]]              # [n, h, w, 3]
    adjacent = []
    for k in range(n - 1):
        T = np.eye(3)
        T[0, 2] = xs[k + 1] - xs[k]
        T[1, 2] = ys[k + 1] - ys[k]
        adjacent.append((k, k + 1, T))
    truth = {"offsets": np.stack([xs, ys], 1), "adjacent": adjacent,
             "size": (w, h)}
    return views.contiguous(), truth
