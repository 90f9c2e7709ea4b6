"""Cyclic block-tridiagonal solver for chain/ring bundle adjustment.

Counterpart of ``openpano_tpu/camera/banded.py``.  For ordered input the
match graph is a chain plus the head-tail wrap pair (stitcher.cc:116-136),
so JtJ is block-tridiagonal with one 6x6 corner block: block Thomas
elimination solves it in O(n), and the corner folds in by the Woodbury
identity

    A = T + P Q^T,   P = [E_0 C | E_{n-1} C^T],  Q = [E_{n-1} | E_0]
    A^-1 b = T^-1 b - T^-1 P (I_12 + Q^T T^-1 P)^-1 Q^T T^-1 b

The JAX package's ``lax.scan`` sweeps are Python loops over the [n, 6, 6]
blocks here.  Plain block LU without pivoting, as there: the LM damping
keeps the block diagonal strongly dominant.
"""

from __future__ import annotations

import numpy as np
import torch


def thomas_block_solve(D: torch.Tensor, U: torch.Tensor,
                       B: torch.Tensor) -> torch.Tensor:
    """Solve T X = B for block-tridiagonal T.

    D: [n, 6, 6] diagonal blocks; U: [n, 6, 6] with U[i] the (i, i+1) block
    (U[n-1] ignored); the lower blocks are U[i]^T.  B: [n, 6, k].  Returns
    X [n, 6, k]."""
    n, k = D.shape[0], B.shape[-1]
    c_prev = torch.zeros_like(D[0])
    d_prev = torch.zeros(6, k, dtype=B.dtype, device=B.device)
    cs, ds = [], []
    for i in range(n):
        # denom_i = D_i - U_{i-1}^T c_{i-1}; rhs_i = B_i - U_{i-1}^T d_{i-1}
        LT = (U[i - 1] if i > 0 else torch.zeros_like(D[0])).T
        denom = D[i] - LT @ c_prev
        rhs = B[i] - LT @ d_prev
        c_prev = torch.linalg.solve(denom, U[i])
        d_prev = torch.linalg.solve(denom, rhs)
        cs.append(c_prev)
        ds.append(d_prev)
    xs = [None] * n
    x_next = torch.zeros(6, k, dtype=B.dtype, device=B.device)
    for i in range(n - 1, -1, -1):
        x_next = ds[i] - cs[i] @ x_next
        xs[i] = x_next
    return torch.stack(xs)


def solve_block_cyclic(D: torch.Tensor, U: torch.Tensor, C, b: torch.Tensor):
    """Solve A x = b where A is symmetric block-tridiagonal (+ optional
    cyclic corner): diag D [n,6,6], upper U[i] = A(i, i+1) [n,6,6]
    (U[n-1] ignored), corner C = A(0, n-1) [6,6] or None, b [n,6].
    Returns x [n,6]."""
    n = D.shape[0]
    if C is None or n < 3:
        return thomas_block_solve(D, U, b[..., None])[..., 0]
    # Woodbury fold of the corner: columns [b | E_0 C | E_{n-1} C^T]
    P = torch.zeros(n, 6, 12, dtype=D.dtype, device=D.device)
    P[0, :, :6] = C
    P[n - 1, :, 6:] = C.T
    X = thomas_block_solve(D, U, torch.cat([b[..., None], P], -1))
    y = X[..., 0]                                          # T^-1 b
    Z = X[..., 1:]                                         # T^-1 P
    QtY = torch.cat([y[n - 1], y[0]])                      # [12]
    QtZ = torch.cat([Z[n - 1], Z[0]], 0)                   # [12, 12]
    S = torch.eye(12, dtype=D.dtype, device=D.device) + QtZ
    w = torch.linalg.solve(S, QtY)
    return y - Z @ w


def assemble_banded(Bp: torch.Tensor, bp: torch.Tensor, F: torch.Tensor,
                    Tc: torch.Tensor, n_cam: int):
    """Accumulate per-pair [12,12]/[12] normal-equation blocks into the
    banded layout.  F/Tc: [P] camera indices per pair slot; every pair
    satisfies |F - Tc| == 1 or {F, Tc} == {0, n-1} (chain + wrap).

    Block row order inside Bp is [F(6) | Tc(6)].  The sums run over the
    pair slots in a fixed order on every device: a one-hot product over the
    camera axis, with no atomics.  Returns (D [n,6,6], U [n,6,6], C [6,6],
    rhs [n,6])."""
    dt, dev = Bp.dtype, Bp.device
    cams = torch.arange(n_cam, device=dev)
    oF = (F[:, None] == cams).to(dt)                       # [P, n]
    oT = (Tc[:, None] == cams).to(dt)
    seg = lambda o, x: (o.T @ x.reshape(x.shape[0], -1)).reshape(
        (n_cam,) + x.shape[1:])
    D = seg(oF, Bp[:, :6, :6]) + seg(oT, Bp[:, 6:, 6:])
    rhs = seg(oF, bp[:, :6]) + seg(oT, bp[:, 6:])
    lo = torch.minimum(F, Tc)
    hi = torch.maximum(F, Tc)
    adj = (hi - lo == 1)[:, None, None]
    wrap = ((lo == 0) & (hi == n_cam - 1))[:, None, None]
    # the (lo, hi) block: B_FT when F == lo, else its transpose
    B_FT = Bp[:, :6, 6:]
    blk = torch.where((F == lo)[:, None, None], B_FT, B_FT.transpose(1, 2))
    oL = (lo[:, None] == cams).to(dt)
    U = seg(oL, torch.where(adj, blk, 0.0))
    C = torch.where(wrap, blk, 0.0).sum(0)
    return D, U, C, rhs


def is_chain_structure(cam_a, cam_b, n_cam: int) -> bool:
    """Host-side check: every pair is an adjacent (i, i+1) pair or the
    (0, n-1) wrap — the ordered-input ring graph."""
    a = np.minimum(cam_a, cam_b)
    b = np.maximum(cam_a, cam_b)
    adj = (b - a) == 1
    wrap = (a == 0) & (b == n_cam - 1)
    return bool(np.all(adj | wrap))
