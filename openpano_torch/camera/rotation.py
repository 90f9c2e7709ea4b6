"""Rodrigues rotation <-> axis-angle conversions, batched over ``[..., 3]``.

Reference: Camera::rotation_to_angle / angle_to_rotation
(stitch/camera.cc:91-144); counterpart of ``openpano_tpu/camera/rotation.py``.
The matrix -> angle side re-orthogonalizes through an SVD; the angle ->
matrix side takes the first-order Taylor branch for small angles
(GEO_EPS_SQR = 1e-14, lib/utils.hh).  Both branches are computed and the
result selected, as in the JAX package, so every element is finite.
"""

from __future__ import annotations

import torch

GEO_EPS_SQR = 1e-14  # lib/utils.hh GEO_EPS_SQR


def cross_matrix(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)


def _eye_like(v: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=v.dtype, device=v.device).expand(shape)


def rodrigues(v: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3]
    (camera.cc:120-144)."""
    theta2 = (v * v).sum(-1)
    small = theta2 < GEO_EPS_SQR
    theta = torch.sqrt(torch.where(small, 1.0, theta2))
    u = v / theta[..., None]
    outer = u[..., :, None] * u[..., None, :]
    K = cross_matrix(u)
    c = torch.cos(theta)[..., None, None]
    s = torch.sin(theta)[..., None, None]
    eye = _eye_like(v, outer.shape)
    full = c * eye + (1 - c) * outer + s * K
    # first-order Taylor: I + [v]_x (camera.cc:122-126)
    taylor = eye + cross_matrix(v)
    return torch.where(small[..., None, None], taylor, full)


def drodrigues(v: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Analytic dR/dv: [..., 3] axis-angle and its rotation [..., 3, 3] ->
    [..., 3, 3, 3] where out[..., i] = dR/dv_i.

    The exponential-coordinates formula (Gallego & Yezzi, arXiv:1312.0788,
    eq. 10) the reference uses symbolically (dRdvi,
    incremental_bundle_adjuster.cc:52-81):
        dR/dv_i = (v_i [v]_x + [v x (I - R) e_i]_x) / |v|^2 . R
    with the theta -> 0 limit dR/dv_i = [e_i]_x."""
    theta2 = (v * v).sum(-1)
    small = theta2 < GEO_EPS_SQR
    t2safe = torch.where(small, 1.0, theta2)[..., None, None, None]
    vx = cross_matrix(v)                                  # [..., 3, 3]
    eye = _eye_like(v, R.shape)
    # (I - R) e_i = column i of (I - R); w_i = v x (I - R) e_i -> [..., i, 3]
    cols = eye - R
    w = torch.linalg.cross(v[..., None, :].expand(cols.shape),
                           cols.transpose(-1, -2), dim=-1)
    wx = cross_matrix(w)                                  # [..., i, 3, 3]
    vi = v[..., :, None, None]                            # [..., i, 1, 1]
    num = vi * vx[..., None, :, :] + wx                   # [..., i, 3, 3]
    full = (num / t2safe) @ R[..., None, :, :]
    lim = cross_matrix(_eye_like(v, R.shape))             # [e_i]_x
    out = torch.where(small[..., None, None, None], lim, full)
    return torch.movedim(out, -3, -1)                     # [..., 3, 3, i]


def rotation_to_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3] with SVD
    re-orthogonalization (camera.cc:91-117)."""
    U, _, Vh = torch.linalg.svd(R)
    Rn = U @ Vh
    det = torch.linalg.det(Rn)
    Rn = Rn * torch.where(det < 0, -1.0, 1.0)[..., None, None]
    rx = Rn[..., 2, 1] - Rn[..., 1, 2]
    ry = Rn[..., 0, 2] - Rn[..., 2, 0]
    rz = Rn[..., 1, 0] - Rn[..., 0, 1]
    r = torch.stack([rx, ry, rz], -1)
    s = torch.linalg.vector_norm(r, dim=-1)
    small = s < 1e-7  # GEO_EPS
    tr = Rn[..., 0, 0] + Rn[..., 1, 1] + Rn[..., 2, 2]
    theta = torch.arccos(torch.clamp((tr - 1) * 0.5, -1.0, 1.0))
    mul = torch.where(small, 0.0, theta / torch.where(small, 1.0, s))
    return r * mul[..., None]
