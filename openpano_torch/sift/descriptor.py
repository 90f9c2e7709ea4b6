"""128-D RootSIFT descriptors.

Reference behavior (feature/sift.cc:87-152), as in
``openpano_tpu/sift/descriptor.py``:
- Window radius round(sqrt(1/2)*hist_w*(DESC_HIST_WIDTH+1)) with
  hist_w = scale_factor*DESC_HIST_SCALE_FACTOR; circular mask; offsets span
  [-radius, radius] inclusive.
- Coordinates rotated into the keypoint direction; gaussian weight
  exp(-(x_rot^2+y_rot^2)/(2*DESC_HIST_WIDTH^2)) times gradient magnitude.
- Trilinear soft-binning into 4x4 spatial x 8 circular orientation bins
  (sift.cc:48-67).
- RootSIFT normalization: L1-normalize, sqrt, * DESC_INT_FACTOR
  (sift.cc:37-45).

The raw histogram is the fused window kernel K2 (``ops/windows.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Config
from ..ops.windows import DESC_NB, DESC_W4, descriptor_histogram
from .orientation import OrientedKeypoints, max_scale_factor, round_half_away
from .pyramid import Octave


class Features(NamedTuple):
    """Final per-image features (fixed K, mask-padded), batched [N, K, ...]."""
    pos: torch.Tensor    # [N, K, 2] half-shifted original-image coords (x, y)
    desc: torch.Tensor   # [N, K, 128]
    valid: torch.Tensor  # [N, K] bool


def desc_window_radius(cfg: Config) -> int:
    hist_w = max_scale_factor(cfg) * cfg.DESC_HIST_SCALE_FACTOR
    return int(round((0.5 ** 0.5) * hist_w * (cfg.DESC_HIST_WIDTH + 1)))


def compute_descriptors(kp: OrientedKeypoints, octave: Octave,
                        cfg: Config) -> torch.Tensor:
    """[B, K, 128] descriptors of one octave's oriented keypoints."""
    return describe_keypoints(kp, octave.mag, octave.ort, cfg)


def describe_keypoints(kp: OrientedKeypoints, mag: torch.Tensor,
                       ort: torch.Tensor, cfg: Config,
                       wh: torch.Tensor | None = None) -> torch.Tensor:
    """[B, K, 128] RootSIFT descriptors over (possibly octave-stacked)
    [B, S, H, W] mag/ort planes; wh: optional [B, K, 2] per-keypoint
    (w, h)."""
    W4 = cfg.DESC_HIST_WIDTH
    NB = cfg.DESC_HIST_BIN_NUM
    assert (W4, NB) == (DESC_W4, DESC_NB), (W4, NB)
    hist_w = kp.scale_factor * cfg.DESC_HIST_SCALE_FACTOR
    radius = round_half_away((0.5 ** 0.5) * hist_w * (W4 + 1))
    hists = descriptor_histogram(mag, ort, kp.s, kp.y, kp.x, radius, hist_w,
                                 kp.dir, desc_window_radius(cfg), wh=wh,
                                 valid=kp.valid)

    # RootSIFT (sift.cc:37-45)
    ssum = hists.sum(-1, keepdim=True)
    desc = torch.sqrt(hists / torch.where(ssum > 0, ssum, 1.0)) \
        * cfg.DESC_INT_FACTOR
    return torch.where(ssum > 0, desc, 0.0)
