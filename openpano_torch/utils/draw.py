"""Debug rasterizer: points, crosses, lines, circles, polygons on float RGB.

Reference: lib/planedrawer.{hh,cc} (Bresenham onto Mat32f), used only by
the CLI debug modes; counterpart of ``openpano_tpu/utils/draw.py``, the same
numpy code, so that both packages draw the same pixels.  Vectorized line
sampling instead of Bresenham.
"""

from __future__ import annotations

import numpy as np


class PlaneDrawer:
    def __init__(self, img: np.ndarray):
        self.img = img
        self.color = np.array([1.0, 0.0, 0.0], np.float32)

    def set_rand_color(self, rng: np.random.Generator | None = None):
        rng = rng or np.random.default_rng()
        c = rng.uniform(0.2, 1.0, size=3)
        self.color = c.astype(np.float32)

    def point(self, x, y, size: int = 0):
        h, w = self.img.shape[:2]
        x, y = int(round(x)), int(round(y))
        x0, x1 = max(0, x - size), min(w, x + size + 1)
        y0, y1 = max(0, y - size), min(h, y + size + 1)
        if x0 < x1 and y0 < y1:
            self.img[y0:y1, x0:x1] = self.color

    def cross(self, x, y, size: int = 4):
        for d in range(-size, size + 1):
            self.point(x + d, y + d)
            self.point(x + d, y - d)

    def line(self, x0, y0, x1, y1):
        n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
        xs = np.linspace(x0, x1, n)
        ys = np.linspace(y0, y1, n)
        h, w = self.img.shape[:2]
        xi = np.clip(np.round(xs).astype(int), 0, w - 1)
        yi = np.clip(np.round(ys).astype(int), 0, h - 1)
        self.img[yi, xi] = self.color

    def circle(self, x, y, r):
        t = np.linspace(0, 2 * np.pi, max(int(8 * r), 16))
        h, w = self.img.shape[:2]
        xi = np.clip(np.round(x + r * np.cos(t)).astype(int), 0, w - 1)
        yi = np.clip(np.round(y + r * np.sin(t)).astype(int), 0, h - 1)
        self.img[yi, xi] = self.color

    def arrow(self, x, y, direction, length):
        x1 = x + np.cos(direction) * length
        y1 = y + np.sin(direction) * length
        self.line(x, y, x1, y1)
        for off in (0.5, -0.5):
            self.line(
                x1, y1,
                x1 - np.cos(direction + off) * length * 0.3,
                y1 - np.sin(direction + off) * length * 0.3,
            )

    def polygon(self, pts):
        for a, b in zip(pts, list(pts[1:]) + [pts[0]]):
            self.line(a[0], a[1], b[0], b[1])
