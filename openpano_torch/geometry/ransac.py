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

Card tensors take one CUDA kernel over all pairs
(``csrc/ransac.cu``, one block a pair; the note there says what bounds it
and how the design answers that) in place of the plain version's chain of
some 1,400 small PyTorch operators a chunk of ``PAIR_CHUNK`` pairs.  CPU
tensors take :func:`estimate_transform_plain`, which the tests hold
against the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .._build import cuda_library
from ..config import Config
from ..match.matcher import MatchResult
from ..ops.compact import compact_indices
from ..utils import prng
from ..utils.timer import span
from .dlt import normalized_transform
from .homography import (
    HOMO_MAX_PERSPECTIVE,
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


def estimate_transform_plain(match: MatchResult, pos1, valid1, pos2, valid2,
                             wh1, wh2, keys, cfg: Config,
                             affine: bool) -> MatchInfo:
    """The plain PyTorch version of :func:`estimate_transform`: the CPU
    route."""
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


def estimate_transform(match: MatchResult, pos1, valid1, pos2, valid2, wh1,
                       wh2, keys, cfg: Config, affine: bool) -> MatchInfo:
    """Transforms from image 2 to image 1 for a batch of P pairs.

    match: MatchResult [P, M, ...]; pos*: [P, K, 2] half-shifted keypoints;
    valid*: [P, K]; wh*: [P, 2] image (w, h); keys: [P, 2] threefry keys.
    The kernel for card tensors, :func:`estimate_transform_plain` for CPU
    ones; ``estimate_transform.launches`` counts the kernel launches."""
    if pos1.device.type == "cuda":
        with span("kernel.ransac"):
            return estimate_transform_cuda(
                match, (pos1, valid1, wh1), (pos2, valid2, wh2), None, keys,
                cfg, affine)
    return estimate_transform_plain(match, pos1, valid1, pos2, valid2, wh1,
                                    wh2, keys, cfg, affine)


estimate_transform.launches = 0


def estimate_transform_batch(matches: MatchResult, pos, valid, whs, ii, jj,
                             key, cfg: Config, affine: bool,
                             keys=None) -> MatchInfo:
    """estimate_transform over a flat pair axis.  pos/valid: [N, K, 2] /
    [N, K]; whs: [N, 2]; ii/jj: [P] image indices.  ``keys`` ([P, 2])
    overrides ``prng.split(key, P)`` — pass the original slots' keys when
    running a compacted subset of pairs.  One kernel launch takes every
    pair of card tensors; :func:`estimate_transform_batch_plain` those of
    CPU tensors."""
    if keys is None:
        keys = prng.split(key, len(ii))
    if pos.device.type == "cuda":
        ij = torch.stack([torch.as_tensor(ii), torch.as_tensor(jj)])
        with span("kernel.ransac"):
            return estimate_transform_cuda(
                matches, (pos, valid, whs), (pos, valid, whs),
                ij.to(pos.device, torch.int64), keys, cfg, affine)
    return estimate_transform_batch_plain(matches, pos, valid, whs, ii, jj,
                                          keys, cfg, affine)


def estimate_transform_batch_plain(matches: MatchResult, pos, valid, whs, ii,
                                   jj, keys, cfg: Config,
                                   affine: bool) -> MatchInfo:
    """:func:`estimate_transform_plain` over a flat pair axis,
    ``PAIR_CHUNK`` pairs at a time; arguments as for
    :func:`estimate_transform_batch` with the keys given."""
    ii = torch.as_tensor(ii, device=pos.device)
    jj = torch.as_tensor(jj, device=pos.device)
    parts = []
    for lo in range(0, ii.shape[0], PAIR_CHUNK):
        sl = slice(lo, lo + PAIR_CHUNK)
        i, j = ii[sl], jj[sl]
        parts.append(estimate_transform_plain(
            MatchResult(*(f[sl] for f in matches)), pos[i], valid[i], pos[j],
            valid[j], whs[i], whs[j], keys[sl], cfg, affine))
    return MatchInfo(*(torch.cat(f, dim=0) for f in zip(*parts)))


# ---------------------------------------------------------------------------
# CUDA launcher
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib():
    """The kernel library, loaded and its argument types set once."""
    lib = cuda_library("ransac")
    # pointers and the stream as c_void_p: a bare int would pass as 32 bits
    lib.ransac_launch.argtypes = (
        [_I] * 4 + [_P] * 8 + [_I] + [_P] * 3 + [_I] * 2 + [_F] * 4 + [_I]
        + [_P] * 7)
    lib.ransac_launch.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape: tuple, dev):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}; "
                         f"the kernel takes {dtype} {shape} on {dev}")
    return t.contiguous()


def estimate_transform_cuda(match: MatchResult, side_i, side_j, ij, keys,
                            cfg: Config, affine: bool) -> MatchInfo:
    """Launch the RANSAC kernel once for P pairs.  side_*: (pos [N, K, 2],
    valid [N, K], wh [N, 2]) of image i and of image j of each pair, the
    positions and sizes float32; ij: [2, P] int64 rows of those images, or
    None for row p of both.  Raises ValueError for other dtypes or
    shapes."""
    P, M = match.idx.shape[0], match.idx.shape[1]
    dev = match.idx.device
    nh = cfg.RANSAC_ITERATIONS
    if nh < 1 or M < 1:
        raise ValueError(f"{nh} hypotheses, {M} match rows: the kernel "
                         f"takes at least one of each")
    idx = _check("match.idx", match.idx, torch.int64, (P, M, 2), dev)
    mvalid = _check("match.valid", match.valid, torch.bool, (P, M), dev)
    count = _check("match.count", match.count, torch.int64, (P,), dev)
    keys = _check("keys", keys, torch.int64, (P, 2), dev)
    sides = []
    for name, (pos, valid, wh) in (("i", side_i), ("j", side_j)):
        N, K = pos.shape[0], pos.shape[1]
        if ij is None and N != P:
            raise ValueError(f"image {name}: {N} rows for {P} pairs")
        sides.append((_check(f"pos_{name}", pos, torch.float32, (N, K, 2),
                             dev),
                      _check(f"valid_{name}", valid, torch.bool, (N, K), dev),
                      _check(f"wh_{name}", wh, torch.float32, (N, 2), dev),
                      K))
    if ij is not None:
        ij = _check("ij", ij, torch.int64, (2, P), dev)
    out = MatchInfo(
        homo=torch.empty(P, 3, 3, dtype=torch.float32, device=dev),
        confidence=torch.empty(P, dtype=torch.float32, device=dev),
        to_pos=torch.empty(P, M, 2, dtype=torch.float32, device=dev),
        from_pos=torch.empty(P, M, 2, dtype=torch.float32, device=dev),
        valid=torch.empty(P, M, dtype=torch.bool, device=dev),
        count=torch.empty(P, dtype=torch.int64, device=dev))
    ptr = lambda t: None if t is None else t.data_ptr()
    (pi, vi, wi, Ki), (pj, vj, wj, Kj) = sides
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ransac_launch(
            P, M, nh, int(affine), idx.data_ptr(), mvalid.data_ptr(),
            count.data_ptr(), keys.data_ptr(), ptr(ij), pi.data_ptr(),
            vi.data_ptr(), wi.data_ptr(), Ki, pj.data_ptr(), vj.data_ptr(),
            wj.data_ptr(), Kj, ESTIMATE_MIN_NR_MATCH, cfg.RANSAC_INLIER_THRES,
            cfg.INLIER_IN_MATCH_RATIO, cfg.INLIER_IN_POINTS_RATIO,
            HOMO_MAX_PERSPECTIVE, cfg.OVERLAP_AREA_GRID,
            *[t.data_ptr() for t in out], stream)
    if err != 0:
        raise RuntimeError(f"RANSAC kernel launch failed: CUDA error {err}")
    if P:
        estimate_transform.launches += 1
    return out


def reverse_matchinfo(info: MatchInfo) -> MatchInfo:
    """MatchInfo of the (j, i) direction from that of (i, j): the inverse
    homography and the coordinate pairs swapped (reference: Stitcher::
    match_image fills both triangle entries, stitcher.cc:88-92;
    MatchInfo::reverse, match_info.hh:21-24)."""
    Hinv, _ = homo_inverse(info.homo)
    return MatchInfo(homo=Hinv, confidence=info.confidence,
                     to_pos=info.from_pos, from_pos=info.to_pos,
                     valid=info.valid, count=info.count)
