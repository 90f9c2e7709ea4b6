"""Polygons on the host (numpy): convex hull, area, point-in-polygon.

Andrew's monotone chain (reference: lib/polygon.cc:17-46), as in
``openpano_tpu/geometry/polygon.py``, whose render plan keeps one convex
hull per item to skip tiles an item never touches.  The port's blends run
one slab per item and its render plan keeps no hull: nothing in the port
calls these.
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


def polygon_area(poly: np.ndarray) -> float:
    """Shoelace area, absolute (reference: polygon.cc:48-60). poly: [M, 2]."""
    p = np.asarray(poly, np.float64)
    if p.shape[0] < 3:
        return 0.0
    x, y = p[:, 0], p[:, 1]
    xn, yn = np.roll(x, -1), np.roll(y, -1)
    return float(abs(np.sum(x * yn - xn * y)) * 0.5)


def points_in_polygon(points: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Exact point-in-polygon by ray crossing, batched.

    points: [Q, 2]; poly: [M, 2] simple polygon (any orientation).  Returns
    [Q] bool; boundary points count as inside (the reference's same-side
    test accepts the boundary, polygon.cc:75-82)."""
    q = np.asarray(points, np.float64)
    p = np.asarray(poly, np.float64)
    if p.shape[0] < 3:
        return np.zeros(q.shape[0], dtype=bool)
    a = p[None, :, :]                       # [1, M, 2] edge starts
    b = np.roll(p, -1, axis=0)[None, :, :]  # [1, M, 2] edge ends
    x, y = q[:, :1], q[:, 1:2]              # [Q, 1]
    ay, by = a[..., 1], b[..., 1]
    ax, bx = a[..., 0], b[..., 0]
    spans = (ay > y) != (by > y)            # the edge straddles the ray
    denom = np.where(by - ay == 0, 1.0, by - ay)
    xint = ax + (y - ay) / denom * (bx - ax)
    inside = (np.sum(spans & (x < xint), axis=1) % 2) == 1
    # on an edge segment: inside
    cross = (bx - ax) * (y - ay) - (by - ay) * (x - ax)
    on_line = np.abs(cross) < 1e-12 * np.maximum(
        1.0, np.abs(bx - ax) + np.abs(by - ay))
    within = (
        (np.minimum(ax, bx) - 1e-12 <= x) & (x <= np.maximum(ax, bx) + 1e-12)
        & (np.minimum(ay, by) - 1e-12 <= y) & (y <= np.maximum(ay, by) + 1e-12))
    return inside | np.any(on_line & within, axis=1)
