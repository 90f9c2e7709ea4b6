"""Camera model: intrinsics, focal estimation, straightening.

Reference: stitch/camera.{hh,cc}.  A numpy copy of
``openpano_tpu/camera/camera.py`` (that module does not import JAX, but
importing any module of the JAX package starts JAX): tiny host-side f64
computations on at most hundreds of cameras.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CameraSet:
    """Struct-of-arrays camera collection: focal/ppx/ppy [n], R [n,3,3]
    (reference: Camera, stitch/camera.hh:12-48)."""

    focal: np.ndarray
    ppx: np.ndarray
    ppy: np.ndarray
    R: np.ndarray

    @classmethod
    def identity(cls, n: int) -> "CameraSet":
        return cls(
            focal=np.ones(n),
            ppx=np.zeros(n),
            ppy=np.zeros(n),
            R=np.tile(np.eye(3), (n, 1, 1)),
        )

    def K(self, i: int) -> np.ndarray:
        return intrinsic(self.focal[i], self.ppx[i], self.ppy[i])


def intrinsic(focal: float, ppx: float, ppy: float) -> np.ndarray:
    """(camera.cc:60-67, aspect fixed to 1)."""
    return np.array([[focal, 0, ppx], [0, focal, ppy], [0, 0, 1.0]])


def focal_from_homography(h: np.ndarray) -> float:
    """Closed-form focal from one homography — Szeliski's method
    (camera.cc:19-52).  Returns 0 on failure, like the reference."""
    h = h.reshape(9)
    d1 = h[6] * h[7]
    d2 = (h[7] - h[6]) * (h[7] + h[6])
    with np.errstate(divide="ignore", invalid="ignore"):
        v1 = -(h[0] * h[1] + h[3] * h[4]) / d1
        v2 = (h[0] * h[0] + h[3] * h[3] - h[1] * h[1] - h[4] * h[4]) / d2
        if v1 < v2:
            v1, v2 = v2, v1
        if v1 > 0 and v2 > 0:
            f1 = np.sqrt(v1 if abs(d1) > abs(d2) else v2)
        elif v1 > 0:
            f1 = np.sqrt(v1)
        else:
            return 0.0

        d1 = h[0] * h[3] + h[1] * h[4]
        d2 = h[0] * h[0] + h[1] * h[1] - h[3] * h[3] - h[4] * h[4]
        v1 = -h[2] * h[5] / d1
        v2 = (h[5] * h[5] - h[2] * h[2]) / d2
        if v1 < v2:
            v1, v2 = v2, v1
        if v1 > 0 and v2 > 0:
            f0 = np.sqrt(v1 if abs(d1) > abs(d2) else v2)
        elif v1 > 0:
            f0 = np.sqrt(v1)
        else:
            return 0.0
    if np.isinf(f1) or np.isinf(f0) or np.isnan(f1) or np.isnan(f0):
        return 0.0
    return float(np.sqrt(f1 * f0))


def estimate_focal(confidences: np.ndarray, homos: np.ndarray) -> float:
    """Median focal over all confident pairs (camera.cc:69-87).

    confidences: [n,n] pairwise confidence (0 where unmatched);
    homos: [n,n,3,3].  Returns -1 when fewer than min(n-1, 3) estimates
    exist; zeros from failed closed-form extractions still enter the median,
    matching the reference."""
    n = confidences.shape[0]
    estimates = []
    for i in range(n):
        for j in range(i + 1, n):
            if confidences[i, j] < 1e-6:
                continue
            estimates.append(focal_from_homography(homos[i, j]))
    ne = len(estimates)
    if ne < min(n - 1, 3):
        return -1.0
    estimates.sort()
    if ne % 2 == 1:
        return estimates[ne >> 1]
    return (estimates[ne >> 1] + estimates[(ne >> 1) - 1]) * 0.5


def estimate_focal_robust(confidences: np.ndarray, homos: np.ndarray) -> float:
    """Mode-seeking focal estimate (the JAX package's deliberate departure
    from the reference's plain median, camera.cc:69-87): the densest +-15%
    multiplicative cluster of the nonzero per-pair estimates, and its
    median.  The closed-form extraction is bimodal under noise at small
    rotations, and failed extractions contribute zeros; the plain median can
    land in the garbage mode.  Falls back to the reference median when fewer
    than 3 estimates are nonzero."""
    n = confidences.shape[0]
    ests = []
    for i in range(n):
        for j in range(i + 1, n):
            if confidences[i, j] >= 1e-6:          # camera.cc:75 (EPS gate)
                ests.append(focal_from_homography(homos[i, j]))
    if len(ests) < min(n - 1, 3):
        return -1.0                                # camera.cc:80-81
    nz = np.sort(np.asarray([e for e in ests if e > 0]))
    if len(nz) < 3:  # too few usable extractions: reference median
        return estimate_focal(confidences, homos)
    counts = np.asarray(
        [((nz >= f / 1.15) & (nz <= f * 1.15)).sum() for f in nz]
    )
    f = nz[int(np.argmax(counts))]
    cluster = nz[(nz >= f / 1.15) & (nz <= f * 1.15)]
    return float(np.median(cluster))


def straighten(cams: CameraSet) -> CameraSet:
    """Global up-vector correction (camera.cc:146-183): the corrected Y axis
    is the null-space direction of the covariance of camera X-axes; X is
    Y x (sum of camera Z-axes), sign-fixed; applies R <- R @ [X Y Z]."""
    X_rows = cams.R[:, 0, :]                       # first row of each R
    cov = X_rows.T @ X_rows
    _, _, Vt = np.linalg.svd(cov)
    normY = Vt[2]
    vz = cams.R[:, 2, :].sum(axis=0)
    normX = np.cross(normY, vz)
    nrm = np.linalg.norm(normX)
    if nrm < 1e-12:
        return cams
    normX /= nrm
    normZ = np.cross(normX, normY)
    s = X_rows @ normX
    if s.sum() < 0:
        normX, normY = -normX, -normY
    r = np.stack([normX, normY, normZ], axis=1)    # columns X Y Z
    return CameraSet(
        focal=cams.focal.copy(), ppx=cams.ppx.copy(), ppy=cams.ppy.copy(),
        R=cams.R @ r,
    )
