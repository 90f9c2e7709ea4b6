"""The least work of the multiband blend (``reference_multiband.py``'s
semantics), frozen here beside ``workmodel.py``: the bytes and operations
that a plan's render items need, whatever layout a program gives them.
Plain Python; nothing of the port.  ``workmodel.least_seconds`` puts the
bytes and operations against the H100's peaks.

Bytes, float32 planes of 4 channels (colour and weight) over each item's
own box (a program's padding is not needed work):

- the u8 views read once;
- the first level's planes written once;
- each blur (levels 0 to L - 2) reading its level's planes once and
  writing the next level's once;
- each level's accumulation reading cur and next once (cur alone at the
  last level) and reading and writing the canvas sums (3 colour sums and
  the weight sum, float32) once;
- the u8 canvas and its mask written once.

Operations: the first level's sampling and weight per box pixel, the seam
per box pixel, two multiply-adds a tap a channel a pass of each blur, each
level's band and weighted sums per box pixel and its normalisation per
canvas pixel, the final clamp and rounding.
"""

from __future__ import annotations

import math

import numpy as np

from benchmark import sift_ref

CHANNELS = 4                 # colour and weight
PLANE_BYTES = CHANNELS * 4   # float32
SUM_BYTES = 4 * 4            # the canvas's colour sums and weight sum
# a box pixel of the first level: the ray (sin, tan, cos), the 3 x 3 map
# (9 products, 6 adds), the division and offsets (4), the floors and bounds
# (6), three bilinear lerps of 3 operations in each of 3 channels (27),
# the weight (7)
FIRST_LEVEL_OPS = 3 + 15 + 4 + 6 + 27 + 7
SEAM_OPS = 3                 # the max, the comparison, the winner's test
# a box pixel of a level: 3 band differences, the weight times the mask,
# 3 products and 4 sums
ACCUMULATE_OPS = 3 + 1 + 3 + 4
NORMALISE_OPS = 3 + 3 + 1    # a canvas pixel of a level: divide, add, test
OUTPUT_OPS = 3 * 3           # a canvas pixel: clamp, scale, round


def taps(sigma: float, factor: int) -> int:
    """The blur's taps at ``sigma`` (feature/gaussian.cc:17-40)."""
    return int(sift_ref.gauss_taps(sigma, factor, None, "cpu").numel())


def multiband_work(views: tuple, boxes, levels: int, out_hw: tuple,
                   factor: int = 6) -> tuple[int, int]:
    """(bytes, operations) of an L-level multiband blend: ``views`` (N, H,
    W) of u8 RGB, ``boxes`` [M, 4] (x0, y0, x1, y1) the render items' boxes
    on the canvas, ``out_hw`` the canvas (h, w), ``factor`` the blur's
    GAUSS_WINDOW_FACTOR."""
    n, h, w = views
    b = np.asarray(boxes, np.int64).reshape(-1, 4)
    px = int((np.maximum(b[:, 2] - b[:, 0], 0)
              * np.maximum(b[:, 3] - b[:, 1], 0)).sum())
    canvas = int(out_hw[0]) * int(out_hw[1])
    blurs = [taps(math.sqrt(2 * lv + 1.0) * 4, factor)
             for lv in range(levels - 1)]
    nbytes = (n * h * w * 3 + px * PLANE_BYTES
              + len(blurs) * 2 * px * PLANE_BYTES
              + (2 * levels - 1) * px * PLANE_BYTES
              + levels * 2 * canvas * SUM_BYTES + canvas * 4)
    ops = (px * (FIRST_LEVEL_OPS + SEAM_OPS)
           + sum(px * CHANNELS * 2 * 2 * t for t in blurs)
           + levels * (px * ACCUMULATE_OPS + canvas * NORMALISE_OPS)
           + canvas * OUTPUT_OPS)
    return nbytes, ops
