"""Scale-space / DoG construction.

Reference behavior (feature/dog.cc), as in ``openpano_tpu/sift/pyramid.py``:
- Octave i is resized from the ORIGINAL working image by SCALE_FACTOR^-i
  with ceil'd dims (dog.cc:96-114), not downsampled from the previous octave.
- Within an octave, level j (j>=1) is blur(grey, sigma*SCALE_FACTOR^(j-1)) of
  level 0 — always from scale 0, never cascaded (dog.cc:54-55).
- Gradient magnitude hypot(dx,dy) and orientation atan2(dy,dx)+pi per level
  j>=1, with zero magnitude / pi orientation on the 1-px border
  (dog.cc:60-94).
- DoG level j = |level j - level j+1| — absolute difference, a deliberate
  quirk of the reference (dog.cc:116-129).

Every array carries the image batch first: [B, S, H, W].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import Config
from ..ops.gaussian import blur
from ..ops.imgproc import resize


class Octave(NamedTuple):
    """One octave of the scale space, all arrays [B, S, H, W]."""
    gauss: torch.Tensor  # S = NUM_SCALE blurred grey levels (level 0 = grey)
    mag: torch.Tensor    # gradient magnitude (level 0 is zeros, unused)
    ort: torch.Tensor    # gradient orientation in [0, 2pi] (level 0 unused)
    dog: torch.Tensor    # S-1 absolute difference-of-gaussian levels


def octave_shapes(h: int, w: int, cfg: Config) -> list[tuple[int, int]]:
    """Per-octave image shapes: ceil(orig * SCALE_FACTOR^-i)
    (reference: dog.cc:103-106)."""
    shapes = []
    for i in range(cfg.NUM_OCTAVE):
        f = cfg.SCALE_FACTOR ** (-i)
        shapes.append((math.ceil(h * f), math.ceil(w * f)) if i else (h, w))
    return shapes


def _mag_ort(level: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradient magnitude/orientation with zeroed 1-px
    border (reference: dog.cc:60-94).  level: [..., H, W]."""
    dx = torch.zeros_like(level)
    dy = torch.zeros_like(level)
    dx[..., :, 1:-1] = level[..., :, 2:] - level[..., :, :-2]
    dy[..., 1:-1, :] = level[..., 2:, :] - level[..., :-2, :]
    interior = torch.zeros(level.shape[-2:], dtype=torch.bool,
                           device=level.device)
    interior[1:-1, 1:-1] = True
    mag = torch.where(interior, torch.hypot(dx, dy), 0.0)
    # fast_atan returns -pi when max(|dx|,|dy|) < EPS => ort = 0 there;
    # the +pi shift maps atan2's [-pi,pi] to [0,2pi].
    degenerate = torch.maximum(torch.abs(dx), torch.abs(dy)) < 1e-6
    ort = torch.where(
        interior,
        torch.where(degenerate, 0.0, torch.atan2(dy, dx) + math.pi),
        math.pi,
    )
    return mag, ort


def build_octave(grey: torch.Tensor, cfg: Config) -> Octave:
    """grey: [B, H, W] single-channel working images for this octave."""
    levels = [grey]
    sigma = cfg.GAUSS_SIGMA
    for _ in range(1, cfg.NUM_SCALE):
        levels.append(blur(grey, sigma, cfg.GAUSS_WINDOW_FACTOR))
        sigma *= cfg.SCALE_FACTOR
    gauss = torch.stack(levels, dim=1)

    mags = [torch.zeros_like(grey)]
    orts = [torch.full_like(grey, math.pi)]
    for j in range(1, cfg.NUM_SCALE):
        m, o = _mag_ort(levels[j])
        mags.append(m)
        orts.append(o)
    dog = torch.abs(gauss[:, :-1] - gauss[:, 1:])
    return Octave(gauss=gauss, mag=torch.stack(mags, 1),
                  ort=torch.stack(orts, 1), dog=dog)


def build_scale_space(grey: torch.Tensor, cfg: Config) -> list[Octave]:
    """grey: [B, H, W] working-size grey images.  Returns one Octave per
    NUM_OCTAVE; shapes shrink per octave_shapes.  Grey conversion happens
    before the per-octave resizes (both are linear; the JAX package does
    the same)."""
    h, w = grey.shape[-2], grey.shape[-1]
    octaves = []
    for i, (oh, ow) in enumerate(octave_shapes(h, w, cfg)):
        oct_img = grey if i == 0 else resize(grey, oh, ow)
        octaves.append(build_octave(oct_img, cfg))
    return octaves
