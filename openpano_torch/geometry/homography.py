"""3x3 homography utilities, batched.

A homography is a [..., 3, 3] tensor (reference: stitch/homography.hh:20-165,
homography.cc:25-48); counterpart of ``openpano_tpu/geometry/homography.py``.
Predicates return boolean tensors instead of branching, so they run over
whole RANSAC hypothesis batches.  Coordinates are half-shifted image
coordinates in [-w/2, w/2] x [-h/2, h/2]; shapes are (w, h) pairs.
"""

from __future__ import annotations

import torch

HOMO_MAX_PERSPECTIVE = 2e-3


def trans2d(H: torch.Tensor, pts: torch.Tensor, eps: float = 0.0):
    """Apply [..., 3, 3] to [..., N, 2] points with the projective divide.
    Returns (xy [..., N, 2], z [..., N]).  Written as explicit products so
    no tensor core (and no TF32) touches the coordinates."""
    x, y = pts[..., 0], pts[..., 1]
    h = lambda r, c: H[..., r, c][..., None]
    out = [h(r, 0) * x + h(r, 1) * y + h(r, 2) for r in range(3)]
    z = out[2]
    denom = torch.where(torch.abs(z) > eps, z,
                        torch.where(z >= 0, 1e-20, -1e-20).to(z.dtype))
    return torch.stack([out[0], out[1]], dim=-1) / denom[..., None], z


def det3(H: torch.Tensor) -> torch.Tensor:
    """Closed-form [..., 3, 3] determinant."""
    return (
        H[..., 0, 0] * (H[..., 1, 1] * H[..., 2, 2] - H[..., 1, 2] * H[..., 2, 1])
        - H[..., 0, 1] * (H[..., 1, 0] * H[..., 2, 2] - H[..., 1, 2] * H[..., 2, 0])
        + H[..., 0, 2] * (H[..., 1, 0] * H[..., 2, 1] - H[..., 1, 1] * H[..., 2, 0])
    )


def homo_inverse(H: torch.Tensor):
    """Inverse with a success flag (reference: Homography::inverse,
    homography.cc:25-39), by the adjugate."""
    det = det3(H)
    ok = torch.abs(det) > 1e-12
    dsafe = torch.where(ok, det, torch.ones_like(det))
    e = lambda r, c: H[..., r, c]
    adj = torch.stack([
        torch.stack([
            e(1, 1) * e(2, 2) - e(1, 2) * e(2, 1),
            e(0, 2) * e(2, 1) - e(0, 1) * e(2, 2),
            e(0, 1) * e(1, 2) - e(0, 2) * e(1, 1)], -1),
        torch.stack([
            e(1, 2) * e(2, 0) - e(1, 0) * e(2, 2),
            e(0, 0) * e(2, 2) - e(0, 2) * e(2, 0),
            e(0, 2) * e(1, 0) - e(0, 0) * e(1, 2)], -1),
        torch.stack([
            e(1, 0) * e(2, 1) - e(1, 1) * e(2, 0),
            e(0, 1) * e(2, 0) - e(0, 0) * e(2, 1),
            e(0, 0) * e(1, 1) - e(0, 1) * e(1, 0)], -1),
    ], -2)
    inv = adj / dsafe[..., None, None]
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    return torch.where(ok[..., None, None], inv, eye), ok


def translation(dx, dy, dtype=torch.float32) -> torch.Tensor:
    """(reference: Homography::get_translation, homography.hh:133-138)."""
    H = torch.eye(3, dtype=dtype)
    H[0, 2] = dx
    H[1, 2] = dy
    return H


def health(H: torch.Tensor) -> torch.Tensor:
    """Small perspective terms and no flip (reference: Homography::health,
    homography.hh:106-127), on raw homogeneous components."""
    ok = (torch.abs(H[..., 2, 0]) <= HOMO_MAX_PERSPECTIVE) & (
        torch.abs(H[..., 2, 1]) <= HOMO_MAX_PERSPECTIVE)
    x0y = H[..., 1, 2]
    x1y = H[..., 1, 1] + H[..., 1, 2]
    x1x = H[..., 0, 1] + H[..., 0, 2]
    x2x = H[..., 0, 0] + H[..., 0, 1] + H[..., 0, 2]
    return ok & (x1y > x0y) & (x2x > x1x)


def shifted_in(wh: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Half-shifted inside test (match_info.hh:70-73).  wh: [..., 2];
    pts: [..., N, 2]."""
    w = wh[..., 0, None]
    h = wh[..., 1, None]
    x, y = pts[..., 0], pts[..., 1]
    return (x >= -w * 0.5) & (x < w * 0.5) & (y >= -h * 0.5) & (y < h * 0.5)


def overlap_mask_in1(H21, H12, wh1, wh2, pts_in1):
    """Exact overlap-region membership of points given in image-1 coords:
    inside image 1, and H12 maps them inside image 2 with positive depth
    (the JAX package's exact form of homography.cc:50-90)."""
    p_in2, z = trans2d(H12, pts_in1)
    return shifted_in(wh1, pts_in1) & shifted_in(wh2, p_in2) & (z > 0)


def overlap_area_fraction(H12, wh1, wh2, grid: int) -> torch.Tensor:
    """Overlap area as a fraction of image-1 area, on a grid x grid lattice
    of image-1 pixel centers (replaces transform_estimate.cc:204-208)."""
    u = (torch.arange(grid, dtype=torch.float32, device=H12.device) + 0.5) \
        / grid - 0.5
    gx = u[None, :] * wh1[..., 0, None, None]
    gy = u[:, None] * wh1[..., 1, None, None]
    gx, gy = torch.broadcast_tensors(gx, gy)
    pts = torch.stack([gx, gy], dim=-1).reshape(*H12.shape[:-2],
                                                 grid * grid, 2)
    p2, z = trans2d(H12, pts)
    inside = shifted_in(wh2, p2) & (z > 0)
    return inside.to(torch.float32).mean(-1)
