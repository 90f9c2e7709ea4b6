"""Projection models: flat / cylindrical / spherical.

Counterparts of the reference's function-pointer pairs
(stitch/projection.hh:14-72) and of ``openpano_tpu/stitch/projection.py``.
``homo2proj`` maps homogeneous / ray coordinates [..., 3] to projection-plane
coordinates [..., 2]; ``proj2homo`` is the inverse lift.
"""

from __future__ import annotations

import torch


def _flat_homo2proj(h):
    return h[..., :2] / h[..., 2:3]


def _flat_proj2homo(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _cyl_homo2proj(h):
    x, y, z = h[..., 0], h[..., 1], h[..., 2]
    return torch.stack([torch.atan2(x, z), y / torch.hypot(x, z)], dim=-1)


def _cyl_proj2homo(p):
    x, y = p[..., 0], p[..., 1]
    return torch.stack([torch.sin(x), y, torch.cos(x)], dim=-1)


def _sph_homo2proj(h):
    x, y, z = h[..., 0], h[..., 1], h[..., 2]
    return torch.stack([torch.atan2(x, z),
                        torch.atan2(y, torch.hypot(x, z))], dim=-1)


def _sph_proj2homo(p):
    x, y = p[..., 0], p[..., 1]
    return torch.stack([torch.sin(x), torch.tan(y), torch.cos(x)], dim=-1)


PROJECTIONS = {
    "flat": (_flat_homo2proj, _flat_proj2homo),
    "cylindrical": (_cyl_homo2proj, _cyl_proj2homo),
    "spherical": (_sph_homo2proj, _sph_proj2homo),
}
