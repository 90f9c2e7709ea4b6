"""Keypoint orientation assignment.

Reference behavior (feature/orientation.cc), as in
``openpano_tpu/sift/orientation.py``:
- 36-bin histogram of gradient orientation over a circular window of radius
  round(scale_factor*ORI_RADIUS), gaussian-weighted
  (sigma = scale_factor*ORI_WINDOW_FACTOR) times gradient magnitude
  (orientation.cc:47-66).  Window x,y offsets span [-rad, rad-1].
- Smoothed ORI_HIST_SMOOTH_COUNT times with a circular [.25 .5 .25] kernel
  (orientation.cc:70-75).
- Every strict local peak >= 0.8*max emits one orientation with parabolic
  interpolation (orientation.cc:77-98); one keypoint can yield several,
  kept in MAX_ORI_PER_KP slots by descending peak (ties: lower bin first).

The histogram is the fused window kernel K1 (``ops/windows.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import Config
from ..ops.compact import compact_indices
from ..ops.windows import ORI_NBINS, SLAB_LANES, orientation_histogram, \
    window_starts
from .extrema import RawKeypoints
from .pyramid import Octave


class OrientedKeypoints(NamedTuple):
    """[B, K] oriented keypoints (post-compaction over orientation slots)."""
    x: torch.Tensor
    y: torch.Tensor
    s: torch.Tensor
    scale_factor: torch.Tensor
    real_x: torch.Tensor
    real_y: torch.Tensor
    dir: torch.Tensor
    valid: torch.Tensor


def max_scale_factor(cfg: Config) -> float:
    """Upper bound on SSPoint.scale_factor: s <= NUM_SCALE-3, |offset.z| < OFFSET_THRES."""
    e = (cfg.NUM_SCALE - 3 + cfg.OFFSET_THRES) / cfg.NUM_SCALE
    return cfg.GAUSS_SIGMA * cfg.SCALE_FACTOR ** e


def ori_window_radius(cfg: Config) -> int:
    return int(round(max_scale_factor(cfg) * cfg.ORI_RADIUS))


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """C round(): half away from zero (torch.round is half-to-even)."""
    return torch.floor(torch.abs(x) + 0.5) * torch.sign(x)


def slab_offsets(y: torch.Tensor, x: torch.Tensor, H: int, W: int, WR: int):
    """Per-lane (dy, dx) offsets of a keypoint's [K, WR, 256] slab (K3's
    layout, ``ops.windows.window_starts``) from the keypoint, as
    broadcastable int32 [K, WR, 1] / [K, 1, 256]."""
    r0, c0 = window_starts(y, x, H, W, WR)
    y, x = y.to(torch.int32), x.to(torch.int32)
    rows = torch.arange(WR, dtype=torch.int32, device=y.device)
    lanes = torch.arange(SLAB_LANES, dtype=torch.int32, device=y.device)
    dy = (r0[:, None] + rows)[:, :, None] - y[:, None, None]
    dx = (c0[:, None] + lanes)[:, None, :] - x[:, None, None]
    return dy, dx


def assign_orientation(kp: RawKeypoints, octave: Octave, cfg: Config,
                       cap: int | None = None) -> OrientedKeypoints:
    """Orientation assignment of one octave's [B, K] keypoints over its
    mag / ort planes, ``cap`` (MAX_DESC_PER_OCTAVE by default) slots."""
    cap = cfg.MAX_DESC_PER_OCTAVE if cap is None else cap
    out, _ = orient_keypoints(kp, octave.mag, octave.ort, cfg, cap)
    return out


def orient_keypoints(kp: RawKeypoints, mag: torch.Tensor, ort: torch.Tensor,
                     cfg: Config, cap: int, wh: torch.Tensor | None = None):
    """Orientation assignment over (possibly octave-stacked) [B, S, H, W]
    mag/ort planes.  wh: optional [B, K, 2] per-keypoint (w, h) octave
    bounds.  Returns (OrientedKeypoints [B, cap], gathered wh or None)."""
    nbins = cfg.ORI_HIST_BIN_NUM
    assert nbins == ORI_NBINS, (nbins, ORI_NBINS)
    rad = round_half_away(kp.scale_factor * cfg.ORI_RADIUS)
    sigma = kp.scale_factor * cfg.ORI_WINDOW_FACTOR
    invden = 1.0 / (2.0 * sigma * sigma)
    hist = orientation_histogram(mag, ort, kp.s, kp.y, kp.x, rad, invden,
                                 ori_window_radius(cfg), wh=wh,
                                 valid=kp.valid)                  # [B, K, 36]

    for _ in range(cfg.ORI_HIST_SMOOTH_COUNT):
        hist = hist * 0.5 + (torch.roll(hist, 1, -1)
                             + torch.roll(hist, -1, -1)) * 0.25

    prev = torch.roll(hist, 1, -1)
    nxt = torch.roll(hist, -1, -1)
    thres = hist.amax(-1, keepdim=True) * cfg.ORI_HIST_PEAK_RATIO
    peak = (hist > thres) & (hist > torch.maximum(prev, nxt))

    M = cfg.MAX_ORI_PER_KP
    score = torch.where(peak, hist, -1.0)
    # top-k in descending order, ties by lower index (jax.lax.top_k's order)
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :M], idx[..., :M]
    p_prev = prev.gather(-1, idx)
    p_next = nxt.gather(-1, idx)
    p_cur = hist.gather(-1, idx)
    denom = p_prev + p_next - 2.0 * p_cur  # strictly negative at a strict peak
    newbin = idx.to(torch.float32) - 0.5 + (p_cur - p_prev) / torch.where(
        denom == 0, -1.0, denom)
    newbin = torch.where(newbin < 0, newbin + nbins, newbin)
    newbin = torch.where(newbin >= nbins, newbin - nbins, newbin)
    dirs = newbin / nbins * 2.0 * math.pi                          # [B, K, M]
    ok = (vals > 0) & kp.valid[..., None]

    # flatten orientation slots and compact to the descriptor cap
    B = ok.shape[0]
    keep, n_keep = compact_indices(ok.reshape(B, -1), cap)
    kvalid = torch.arange(cap, device=keep.device) < n_keep[:, None]
    kp_idx = keep // M
    take = lambda a: a.gather(1, kp_idx)
    out = OrientedKeypoints(
        x=take(kp.x), y=take(kp.y), s=take(kp.s),
        scale_factor=take(kp.scale_factor),
        real_x=take(kp.real_x), real_y=take(kp.real_y),
        dir=dirs.reshape(B, -1).gather(1, keep),
        valid=kvalid,
    )
    if wh is None:
        return out, None
    return out, wh.gather(1, kp_idx[..., None].expand(-1, -1, 2))
