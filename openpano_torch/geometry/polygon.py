"""Convex hull of projected image borders (host side, numpy).

Andrew's monotone chain (reference: lib/polygon.cc:17-46), as in
``openpano_tpu/geometry/polygon.py``; the render plan keeps one hull per
item so that the blender can skip tiles an item never touches.
"""

from __future__ import annotations

import numpy as np


def convex_hull(points: np.ndarray) -> np.ndarray:
    """points: [N, 2].  Returns the hull vertices [M, 2] counter-clockwise
    (y up), without repeating the first vertex."""
    pts = np.unique(np.asarray(points, np.float64), axis=0)
    if pts.shape[0] <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def chain(seq):
        out: list[np.ndarray] = []
        for p in seq:
            while len(out) >= 2 and cross(out[-2], out[-1], p) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = chain(pts)
    upper = chain(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])
