"""The work a layer's inputs need, frozen here so that a later change to
the port cannot move the yardstick: the H100's peaks, K2's bytes and
operations (the model ``chip_smoke.py`` holds K2 to), and the 2-NN match's
cross term.  Plain torch and Python; nothing of the port.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
F32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

# K2 (descriptor histogram): operations an in-window pixel needs (the
# rotation and division by the bin width, three bin coordinates, the
# weight, the orientation wrap, 8 trilinear corners of 3 products and an
# add each); input bytes an active keypoint needs besides its active byte
# (s, y, x int32; radius, hist_w, dir, h, w float32); 128 float bins out
K2_OPS_PER_PIXEL = 60
K2_KP_BYTES = 12 + 5 * 4
K2_BINS = 128


def k2_window_need(S: int, H: int, W: int, s, y, x, radius, hist_w, cos_o,
                   sin_o, hb, wb, active, R: int) -> tuple[int, int, int]:
    """(distinct plane pixels, pixel visits, active keypoints) that K2
    needs for these inputs: the active keypoints' window pixels inside the
    circle of ``radius``, inside the rotated 4 x 4 bin grid and inside the
    octave's interior.  Planes [S, H, W]; keypoint arrays [K]."""
    dev = s.device
    s, y, x = (a.long() for a in (s, y, x))
    ids = torch.nonzero(active).flatten()
    d = torch.arange(-R, R + 1, device=dev, dtype=torch.float32)
    dy, dx = d.view(1, -1, 1), d.view(1, 1, -1)

    def col(v):
        return v[ids].float().view(-1, 1, 1)

    r = col(radius)
    x_rot = (dx * col(cos_o) + dy * col(sin_o)) / col(hist_w)
    y_rot = (-dx * col(sin_o) + dy * col(cos_o)) / col(hist_w)
    inside = ((dy.abs() <= r) & (dx.abs() <= r) & (dy * dy + dx * dx <= r * r)
              & (x_rot >= -2.5) & (x_rot <= 1.5)
              & (y_rot >= -2.5) & (y_rot <= 1.5))
    py = y[ids].view(-1, 1, 1) + dy.long()
    px = x[ids].view(-1, 1, 1) + dx.long()
    inside &= ((px >= 1) & (px <= col(wb) - 2) & (py >= 1)
               & (py <= col(hb) - 2))
    flat = (s[ids].view(-1, 1, 1) * H + py) * W + px
    mark = torch.zeros(S * H * W, dtype=torch.bool, device=dev)
    mark[flat[inside]] = True
    return int(mark.sum()), int(inside.sum()), int(ids.numel())


def k2_work(S: int, H: int, W: int, s, y, x, radius, hist_w, cos_o, sin_o,
            hb, wb, active, R: int) -> tuple[int, int]:
    """(bytes, operations) of one K2 call: each needed plane pixel's
    magnitude and orientation read once, each keypoint's active byte, the
    active keypoints' inputs, the histograms written once."""
    K = s.shape[0]
    distinct, visits, n_active = k2_window_need(
        S, H, W, s, y, x, radius, hist_w, cos_o, sin_o, hb, wb, active, R)
    nbytes = distinct * 8 + K + n_active * K2_KP_BYTES + K * K2_BINS * 4
    return nbytes, visits * K2_OPS_PER_PIXEL


def match_work(kpt_counts, ii, jj, dim: int = 128) -> tuple[int, int]:
    """(bytes, operations) of the 2-NN cross terms of the pairs (ii, jj):
    2 Ki Kj dim operations a pair over the valid keypoints, and each
    matched view's valid descriptors read once (float32)."""
    k = [int(c) for c in kpt_counts]
    ops = sum(2 * k[i] * k[j] * dim for i, j in zip(ii, jj))
    views = set(ii) | set(jj)
    return sum(k[v] for v in views) * dim * 4, ops


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: bytes over the HBM rate or
    operations over the float32 rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S)
