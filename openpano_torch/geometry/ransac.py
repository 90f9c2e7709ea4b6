"""RANSAC transform estimation with the reference's acceptance gates.

Reference: stitch/transform_estimate.cc; counterpart of
``openpano_tpu/geometry/ransac.py``.  Every pair of a batch runs all its
hypotheses at once: each hypothesis draws ``ns`` match rows from a
threefry key (the JAX package's draws, bit for bit — ``utils/prng.py``),
fits a normalized DLT, is dropped when unhealthy, and counts inliers; the
best hypothesis's inliers are refit and then pass the gates of
fill_inliers_to_matchinfo (transform_estimate.cc:150-218).  As in the JAX
package, duplicate draws within a hypothesis are kept (the DLT turns
singular and ``health`` rejects it).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Config
from ..match.matcher import MatchResult
from ..ops.compact import compact_indices
from ..utils import prng
from ..utils.timer import span
from .dlt import normalized_transform
from .homography import (
    health,
    homo_inverse,
    overlap_area_fraction,
    overlap_mask_in1,
    trans2d,
)

ESTIMATE_MIN_NR_MATCH = 8  # transform_estimate.cc:21
PAIR_CHUNK = 32            # pairs per batch: each holds [hyp, M] residuals


class MatchInfo(NamedTuple):
    """Per-pair estimation result (reference: MatchInfo, match_info.hh:14-51),
    batched [P, ...].  ``homo`` maps image-j (from) to image-i (to) coords;
    ``confidence`` is ``-n_inliers`` for a rejected pair
    (transform_estimate.cc:153)."""

    homo: torch.Tensor        # [P, 3, 3]
    confidence: torch.Tensor  # [P]
    to_pos: torch.Tensor      # [P, M, 2] inlier coords in image i
    from_pos: torch.Tensor    # [P, M, 2] inlier coords in image j
    valid: torch.Tensor       # [P, M] bool
    count: torch.Tensor       # [P]


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[p, idx[p, ...]] for a [P, K, D] and idx [P, ...]."""
    flat = idx.reshape(idx.shape[0], -1)
    out = a.gather(1, flat[..., None].expand(-1, -1, a.shape[-1]))
    return out.reshape(*idx.shape, a.shape[-1])


def estimate_transform(match: MatchResult, pos1, valid1, pos2, valid2, wh1,
                       wh2, keys, cfg: Config, affine: bool) -> MatchInfo:
    """Transforms from image 2 to image 1 for a batch of P pairs.

    match: MatchResult [P, M, ...]; pos*: [P, K, 2] half-shifted keypoints;
    valid*: [P, K]; wh*: [P, 2] image (w, h); keys: [P, 2] threefry keys."""
    P, M = match.idx.shape[0], match.idx.shape[1]
    dev = match.idx.device
    p1 = _take(pos1, match.idx[..., 0])
    p2 = _take(pos2, match.idx[..., 1])
    mvalid = match.valid
    n_match = match.count

    # per-resolution threshold (transform_estimate.cc:46)
    thres = (wh1[:, 0] + wh1[:, 1]) * 0.5 / 800.0 * cfg.RANSAC_INLIER_THRES
    inlier_dist = (thres * thres)[:, None, None]

    ns = (6 if affine else 8) // 2 + 4  # transform_estimate.cc:53
    nh = cfg.RANSAC_ITERATIONS
    # uniform rows of the prefix-packed matches; f64 like the JAX package,
    # whose default float is 64-bit
    with span("ransac.draws"):
        u = prng.uniform_f64(keys, (nh, ns))                   # [P, nh, ns]
    hi = torch.clamp(n_match, min=1).to(torch.float64)[:, None, None]
    top = torch.clamp(n_match - 1, min=0)[:, None, None]
    # the match count is not clipped to M (compact_indices), so a draw can
    # pass the buffer; the JAX package's gather clamps it to row M-1
    sel = torch.minimum((u * hi).to(torch.int64), top).clamp_(max=M - 1)

    with span("ransac.fit"):
        w_sel = torch.ones(sel.shape, dtype=p1.dtype, device=dev)
        H_hyp = normalized_transform(_take(p1, sel), _take(p2, sel), w_sel,
                                     affine)                    # [P, nh, 3, 3]
        healthy = health(H_hyp)                                 # :79

    with span("ransac.score"):
        proj, _ = trans2d(H_hyp, p2[:, None])                   # [P, nh, M, 2]
        err2 = ((proj - p1[:, None]) ** 2).sum(-1)
        inl = (err2 < inlier_dist) & mvalid[:, None, :]         # :132-148
        n_inl = inl.sum(-1)
        score = torch.where(healthy, n_inl, -1)
        best = torch.argmax(score, dim=-1)                      # first max
        rows = torch.arange(P, device=dev)
        inlier_mask = inl[rows, best]
        n_inlier = n_inl[rows, best]

    # refit on all inliers (transform_estimate.cc:85-86,179)
    with span("ransac.refit"):
        H = normalized_transform(p1, p2, inlier_mask.to(p1.dtype), affine)

    # acceptance gates (fill_inliers_to_matchinfo, :150-218)
    with span("ransac.gates"):
        Hinv, inv_ok = homo_inverse(H)
        in_ov1_m = overlap_mask_in1(H, Hinv, wh1, wh2, p1) & mvalid
        in_ov2_m = overlap_mask_in1(Hinv, H, wh2, wh1, p2) & mvalid
        in_ov1_k = overlap_mask_in1(H, Hinv, wh1, wh2, pos1) & valid1
        in_ov2_k = overlap_mask_in1(Hinv, H, wh2, wh1, pos2) & valid2
        fn = n_inlier.to(torch.float32)
        ratio = lambda m: fn / torch.clamp(m.sum(-1), min=1)
        r1m, r2m = ratio(in_ov1_m), ratio(in_ov2_m)
        r1p, r2p = ratio(in_ov1_k), ratio(in_ov2_k)
        conf = (r1p + r2p) * 0.5

        ok = ((r1m >= cfg.INLIER_IN_MATCH_RATIO)
              & (r2m >= cfg.INLIER_IN_MATCH_RATIO))
        ok &= (r1p >= 0.01) & (r1p <= 1.0) & (r2p >= 0.01) & (r2p <= 1.0)
        ok &= conf >= cfg.INLIER_IN_POINTS_RATIO
        # overlap area in image-2 coords vs the larger image (:204-208)
        area2 = wh2[:, 0] * wh2[:, 1]
        area1 = wh1[:, 0] * wh1[:, 1]
        area = overlap_area_fraction(H, wh2, wh1,
                                     cfg.OVERLAP_AREA_GRID) * area2
        ok &= area / torch.maximum(area1, area2) >= 0.15

        success = ((n_match >= ESTIMATE_MIN_NR_MATCH) & (n_match >= ns)
                   & (n_inlier >= ESTIMATE_MIN_NR_MATCH) & inv_ok & ok)

    # compact inliers to the front of the match buffer
    keep, _ = compact_indices(inlier_mask, M)
    out_valid = (torch.arange(M, device=dev) < n_inlier[:, None]) \
        & success[:, None]
    return MatchInfo(
        homo=H,
        confidence=torch.where(success, conf, -fn),
        to_pos=torch.where(out_valid[..., None], _take(p1, keep), 0.0),
        from_pos=torch.where(out_valid[..., None], _take(p2, keep), 0.0),
        valid=out_valid,
        count=torch.where(success, n_inlier, 0),
    )


def estimate_transform_batch(matches: MatchResult, pos, valid, whs, ii, jj,
                             key, cfg: Config, affine: bool,
                             keys=None) -> MatchInfo:
    """estimate_transform over a flat pair axis, ``PAIR_CHUNK`` pairs at a
    time.  pos/valid: [N, K, 2] / [N, K]; whs: [N, 2]; ii/jj: [P] image
    indices.  ``keys`` ([P, 2]) overrides ``prng.split(key, P)`` — pass the
    original slots' keys when running a compacted subset of pairs."""
    ii = torch.as_tensor(ii, device=pos.device)
    jj = torch.as_tensor(jj, device=pos.device)
    P = ii.shape[0]
    if keys is None:
        keys = prng.split(key, P)
    parts = []
    for lo in range(0, P, PAIR_CHUNK):
        sl = slice(lo, lo + PAIR_CHUNK)
        i, j = ii[sl], jj[sl]
        parts.append(estimate_transform(
            MatchResult(*(f[sl] for f in matches)), pos[i], valid[i], pos[j],
            valid[j], whs[i], whs[j], keys[sl], cfg, affine))
    return MatchInfo(*(torch.cat(f, dim=0) for f in zip(*parts)))


def reverse_matchinfo(info: MatchInfo) -> MatchInfo:
    """MatchInfo of the (j, i) direction from that of (i, j): the inverse
    homography and the coordinate pairs swapped (reference: Stitcher::
    match_image fills both triangle entries, stitcher.cc:88-92;
    MatchInfo::reverse, match_info.hh:21-24)."""
    Hinv, _ = homo_inverse(info.homo)
    return MatchInfo(homo=Hinv, confidence=info.confidence,
                     to_pos=info.from_pos, from_pos=info.to_pos,
                     valid=info.valid, count=info.count)
