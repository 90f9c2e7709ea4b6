"""Direct linear transforms (homography / affine fits), batched with masks.

The reference solves an inhomogeneous 2n x 8 (perspective, h22=1) or 2n x 6
(affine) least-squares system (lib/imgproc.cc:251-317) inside scale-only
coordinate normalization (stitch/transform_estimate.cc:99-129).  As in
``openpano_tpu/geometry/dlt.py``: fixed-shape systems with per-row weights
(0 for padded / non-inlier rows), normal equations with a 1e-9 Tikhonov
term, and an unrolled Cholesky solve that runs elementwise over any batch
of hypotheses.  Degenerate fits are rejected downstream by ``health``.
"""

from __future__ import annotations

import torch

from ..ops.imgproc import _fma
from ..utils.precision import full_f32

# XLA:CPU's dot runs its contraction in blocks of this many rows.
_XLA_K_BLOCK = 256


def _chol_solve_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cholesky solve of tiny SPD systems, unrolled: A [..., n, n],
    b [..., n]; n is small (6 or 8)."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=1e-30))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def _xla_cpu_rows_product(a, b):
    """sum over r of a[..., r, :, None] * b[..., r, None, :], rounded as
    XLA:CPU's jitted ``einsum("...ri,...rj->...ij")``: each block of 256
    rows accumulated from zero by one f32 fused multiply-add a row, the
    block sums then added in order.  ``b`` [..., R] (no last axis) gives the
    matrix-vector product, which XLA:CPU accumulates over all rows in one
    block.  Measured bit-equal for R up to 256 and for the multiples of 256
    up to 2048 (the refit of the default cap of 1024 matches); another
    length over 256 is blocked otherwise there.  The blocks accumulate side
    by side (zero rows pad the last: adding an exact 0 to an accumulator
    that started at +0 leaves it as it is)."""
    vec = b.dim() == a.dim() - 1
    if vec:
        b = b[..., None]
    R = a.shape[-2]
    blk = R if vec else min(R, _XLA_K_BLOCK)
    nb = -(-R // blk)

    def blocks(x):             # [..., R, k] -> [nb, ..., blk, k]
        x = torch.nn.functional.pad(x, (0, 0, 0, nb * blk - R))
        x = x.unflatten(-2, (nb, blk))
        return x.movedim(-3, 0)

    a, b = blocks(a), blocks(b)
    acc = a.new_zeros(a.shape[:-2] + a.shape[-1:] + b.shape[-1:])
    for r in range(blk):
        acc = _fma(a[..., r, :, None], b[..., r, None, :], acc)
    out = acc[0]
    for k in range(1, nb):
        out = out + acc[k]
    return out[..., 0] if vec else out


def _normal_equations(Aw, A, b):
    """(Aw^T A, Aw^T b).  On the card a full-f32 matrix product (TF32 would
    move the fit by ~1e-3); for f32 on the CPU the sums of XLA:CPU's jitted
    einsum (``_xla_cpu_rows_product``), so that the refits do not depend on
    which kernel the CPU's BLAS dispatches (its rounding differs between
    AVX2 and AVX-512 hosts).  f64 (the CYLINDER perspective correction)
    keeps the f64 matrix product: ``_fma`` rounds to f32."""
    if A.device.type == "cpu" and A.dtype == torch.float32:
        return _xla_cpu_rows_product(Aw, A), _xla_cpu_rows_product(Aw, b)
    with full_f32():
        return (torch.matmul(Aw.transpose(-1, -2), A),
                torch.matmul(Aw.transpose(-1, -2), b[..., None])[..., 0])


def _weighted_lstsq(A, b, w, nparam: int):
    """argmin_x ||w * (Ax - b)||^2 for [..., R, nparam] systems."""
    AtA, Atb = _normal_equations(A * w[..., None], A, b)
    AtA = AtA + 1e-9 * torch.eye(nparam, dtype=A.dtype, device=A.device)
    return _chol_solve_small(AtA, Atb)


def perspective_dlt(p1, p2, w):
    """Homography mapping p2 -> p1 with h22=1 (imgproc.cc:251-295).
    p1, p2: [..., N, 2]; w: [..., N] row weights.  Returns [..., 3, 3]."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    rx = torch.stack([x2, y2, o, z, z, z, -x2 * x1, -y2 * x1], dim=-1)
    ry = torch.stack([z, z, z, x2, y2, o, -x2 * y1, -y2 * y1], dim=-1)
    A = torch.cat([rx, ry], dim=-2)
    b = torch.cat([x1, y1], dim=-1)
    h = _weighted_lstsq(A, b, torch.cat([w, w], dim=-1), 8)
    H = torch.cat([h, torch.ones_like(h[..., :1])], dim=-1)
    return H.reshape(*h.shape[:-1], 3, 3)


def affine_dlt(p1, p2, w):
    """Affine transform p2 -> p1 as a 3x3 with last row (0, 0, 1)
    (imgproc.cc:297-317)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x1)
    o = torch.ones_like(x1)
    rx = torch.stack([x2, y2, o, z, z, z], dim=-1)
    ry = torch.stack([z, z, z, x2, y2, o], dim=-1)
    A = torch.cat([rx, ry], dim=-2)
    b = torch.cat([x1, y1], dim=-1)
    h = _weighted_lstsq(A, b, torch.cat([w, w], dim=-1), 6)
    bot = torch.tensor([0.0, 0.0, 1.0], dtype=h.dtype,
                       device=h.device).expand(*h.shape[:-1], 3)
    H = torch.cat([h, bot], dim=-1)
    return H.reshape(*h.shape[:-1], 3, 3)


def _norm_scale(p, w, cnt):
    """sqrt(2 / mean |p|^2) over the points selected by ``w``."""
    sqrsum = ((p * p).sum(-1) * w).sum(-1) / cnt
    return torch.sqrt(2.0 / torch.clamp(sqrsum, min=1e-12))


def normalized_transform(p1, p2, w, affine: bool):
    """DLT with the reference's scale-only normalization
    (transform_estimate.cc:99-129): each point set is scaled by
    s = sqrt(2 / mean |p|^2) over the selected points, and the fit is
    de-normalized as diag(1/s1, 1/s1, 1) @ Hn @ diag(s2, s2, 1)."""
    cnt = torch.clamp(w.sum(-1), min=1.0)
    s1 = _norm_scale(p1, w, cnt)
    s2 = _norm_scale(p2, w, cnt)
    Hn = (affine_dlt if affine else perspective_dlt)(
        p1 * s1[..., None, None], p2 * s2[..., None, None], w)
    col = torch.stack([s2, s2, torch.ones_like(s2)], dim=-1)
    row = torch.stack([1.0 / s1, 1.0 / s1, torch.ones_like(s1)], dim=-1)
    return Hn * col[..., None, :] * row[..., :, None]
