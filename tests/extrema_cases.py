"""Crafted DoG volumes for the extrema tests, on the CPU and on the card.

A volume is [B, NUM_SCALE - 1, h, w] float32, zero but for planted 3x3x3
neighbourhoods.  A plant's centre is a strict 26-neighbour maximum whose
stencil (``sift/extrema.py``'s ``_stencil``) reads a chosen gradient g and
Hessian H: the faces carry g and the diagonal, the edges the cross terms,
and the corners, which only the candidate test reads, lie lowest.  All
values are dyadic, so that the refinement's float32 operations are exact
on these plants and each one lands on the branch it is named for.  The
refinement's offset is H^-1 g (``_solve3x3``); a step moves by its
half-to-even rounding.
"""

import numpy as np
import torch

from openpano_torch.config import Config
from openpano_torch.sift.pyramid import Octave

CFG = Config()
LEVELS = CFG.NUM_SCALE - 1
H, W = 32, 160        # one 128-lane block spans less than a row
V = 8.0               # a plant's centre value
DENSE_Y = 5           # the row of isolated peaks on level 2
DENSE_X = list(range(2, 151, 2))

# name: (level, y, x, g, diagonal of H, (hxy, hys, hsx))
PLANTS = {
    # converges at once and passes both gates
    "converge": (2, 12, 40, (0.0, 0.0, 0.0), (-2.0, -2.0, -2.0), (0, 0, 0)),
    # offset (-0.625, -0.375, 0): steps to x = 0, out of the interior
    "step_out": (2, 12, 1, (0.875, -0.25, 0.0), (-2.0, -1.0, -1.0),
                 (1.0, 0, 0)),
    # det = 0 exactly
    "singular": (2, 12, 60, (0.0, 0.0, 0.0), (-1.0, -1.0, -1.0),
                 (1.0, 0, 0)),
    # offset (0.5, 0.5, 0): rounds to no step, so it never converges
    "half": (3, 20, 8, (-0.5, 0.0, 0.0), (-2.0, -1.0, -1.0), (1.0, 0, 0)),
    # offset (1.5, 2.5, 0): steps by (2, 2), not by rounding half up (2, 3)
    "half_up": (3, 20, 80, (-0.5, -0.0625, 0.0), (-2.0, -0.625, -1.0),
                (1.0, 0, 0)),
    # offset (-0.5, -1, 0): steps by (0, -1)
    "half_down": (3, 20, 120, (0.0, 0.125, 0.0), (-2.0, -0.625, -1.0),
                  (1.0, 0, 0)),
    # tr^2 / det = 49 / 6: exactly on the edge-ratio limit, so an edge
    "edge_at": (1, 26, 20, (0.0, 0.0, 0.0), (-1.0, -6.0, -1.0), (0, 0, 0)),
    # just inside the limit and just outside it
    "edge_in": (1, 26, 60, (0.0, 0.0, 0.0), (-1.0, -5.9921875, -1.0),
                (0, 0, 0)),
    "edge_out": (1, 26, 100, (0.0, 0.0, 0.0), (-1.0, -6.0078125, -1.0),
                 (0, 0, 0)),
}


def plant(dog: np.ndarray, b: int, s: int, y: int, x: int, g, hdiag, cross,
          v: float = V):
    """Write the 3x3x3 neighbourhood of (s, y, x) in image b."""
    thres = CFG.JUDGE_EXTREMA_DIFF_THRES
    blk = np.full((3, 3, 3), v - 7.0)                 # [ds, dy, dx]
    for axis, (gi, hi) in enumerate(zip(g[::-1], hdiag[::-1])):  # s, y, x
        assert abs(gi) < -hi / 2 - thres, "a face would not lie below"
        for sign in (1, -1):
            at = [1, 1, 1]
            at[axis] += sign
            blk[tuple(at)] = v + hi / 2 + sign * gi
    # (hxy, hys, hsx) on the (y, x), (s, y) and (s, x) planes
    for (p, q), a in zip(((1, 2), (0, 1), (0, 2)), cross):
        assert abs(a) < 4 - thres
        for sp in (1, -1):
            for sq in (1, -1):
                at = [1, 1, 1]
                at[p] += sp
                at[q] += sq
                blk[tuple(at)] = v - 4 + a * sp * sq
    blk[1, 1, 1] = v
    dog[b, s - 1:s + 2, y - 1:y + 2, x - 1:x + 2] = blk


def crafted(B: int = 2) -> np.ndarray:
    """Image 0: the row of isolated peaks (more than 32 candidates in one
    128-lane block) and every plant; the other images empty (no candidate,
    so every keypoint slot is padding)."""
    dog = np.zeros((B, LEVELS, H, W), np.float32)
    dog[0, 2, DENSE_Y, DENSE_X] = 1.0
    for s, y, x, g, hdiag, cross in PLANTS.values():
        plant(dog, 0, s, y, x, g, hdiag, cross)
    return dog


def noise(B: int, h: int, w: int, seed: int, smooth: int = 0) -> np.ndarray:
    """Seeded uniform noise, box-blurred ``smooth`` times in the plane:
    every branch at random, candidates past every cap."""
    rng = np.random.default_rng(seed)
    dog = rng.uniform(0, 1, (B, LEVELS, h, w)).astype(np.float32)
    for _ in range(smooth):
        pad = np.pad(dog, ((0, 0), (0, 0), (1, 1), (1, 1)), mode="edge")
        dog = sum(pad[..., i:i + h, j:j + w] for i in range(3)
                  for j in range(3)).astype(np.float32) / np.float32(9)
    return dog


def octave(dog: np.ndarray, device="cpu") -> Octave:
    """An Octave around a DoG volume (the extrema read only ``dog``)."""
    t = torch.from_numpy(np.ascontiguousarray(dog)).to(device)
    return Octave(gauss=None, mag=None, ort=None, dog=t)
