"""Descriptor matching: exact 2-NN by one distance matrix per pair.

The acceptance rule of the reference (feature/matcher.cc:15-135), as in
``openpano_tpu/match/matcher.py``:

  - Lowe ratio test on squared distances, ``d1 <= r^2 * d2`` with
    r = MATCH_REJECT_NEXT_RATIO (matcher.cc:51,108),
  - mutual-best check: the reverse 1-NN of the matched target must be the
    query itself (matcher.cc:118-120),
  - reverse ratio test against the reverse 2nd-NN (matcher.cc:56-62,121-123).

An exact 2-NN over a few thousand descriptors per image is one
[Ki,128]x[128,Kj] product per pair; the rule is symmetric, so one matrix
serves both directions.  The product only selects candidates: the ratio
tests recompute the selected distances exactly.  Shapes are fixed:
descriptors are [K,128] zero-padded with validity masks, matches are index
pairs padded to MAX_MATCHES_PER_PAIR, and a batch of pairs runs at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import Config
from ..ops.compact import compact_indices
from ..utils.precision import full_f32

_BIG = 3.4e38
_PAD_DIST = 1e19   # >> any real descriptor distance


class MatchResult(NamedTuple):
    """Fixed-size match list for a batch of image pairs."""

    idx: torch.Tensor    # [P, M, 2] int64 — (index in image i, index in image j)
    valid: torch.Tensor  # [P, M] bool
    count: torch.Tensor  # [P] int64 — number of valid matches


def _sq_dist_matrix(da, db, valid_a, valid_b) -> torch.Tensor:
    """[P, Ki, Kj] squared euclidean distances via ||a||^2+||b||^2-2ab.
    Invalid (padding) rows/columns are pushed to ~1e19 through the norm
    terms.  Full f32: TF32 would move candidates across the ratio test."""
    na = torch.where(valid_a, (da * da).sum(-1), _PAD_DIST)
    nb = torch.where(valid_b, (db * db).sum(-1), _PAD_DIST)
    with full_f32():
        cross = torch.matmul(da, db.transpose(-1, -2))
    d2 = na[:, :, None] + nb[:, None, :] - 2.0 * cross
    return torch.clamp(d2, min=0.0)


def _exact_sq_dist(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Row-wise exact ||da_i - db_i||^2 for gathered candidate pairs."""
    d = da - db
    return (d * d).sum(-1)


def _top2(d: torch.Tensor):
    """Indices of the two smallest entries along the last axis (first index
    on ties, like jnp.argmin)."""
    i1 = torch.argmin(d, -1)
    masked = d.scatter(-1, i1[..., None], _BIG)
    return i1, torch.argmin(masked, -1)


def _rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[p, idx[p, k]] for a [P, K, D] and idx [P, K']."""
    return a.gather(1, idx[..., None].expand(-1, -1, a.shape[-1]))


def match_pair_from_dists(d2, desc_i, desc_j, valid_i, valid_j,
                          cfg: Config) -> MatchResult:
    """Ratio + mutual-best acceptance on [P, Ki, Kj] distance matrices whose
    invalid rows/columns already carry huge distances."""
    P, Ki = d2.shape[0], d2.shape[1]
    r2 = float(torch.tensor(cfg.MATCH_REJECT_NEXT_RATIO ** 2,
                            dtype=torch.float32))
    fwd_idx, fwd_idx2 = _top2(d2)                   # per query in i
    rev_idx, rev_idx2 = _top2(d2.transpose(1, 2))   # per target in j

    # exact distances for the selected candidates (no cancellation)
    fwd_d1 = _exact_sq_dist(desc_i, _rows(desc_j, fwd_idx))
    fwd_d2 = _exact_sq_dist(desc_i, _rows(desc_j, fwd_idx2))
    rev_d2 = _exact_sq_dist(desc_j, _rows(desc_i, rev_idx2))

    # forward ratio (matcher.cc:108): reject when d1 > r^2 * d2nd
    ok = fwd_d1 <= r2 * fwd_d2
    # mutual best (matcher.cc:118-120)
    qi = torch.arange(Ki, device=d2.device)
    ok &= rev_idx.gather(1, fwd_idx) == qi
    # reverse ratio against the reverse 2nd-NN (matcher.cc:121-123)
    ok &= fwd_d1 <= r2 * rev_d2.gather(1, fwd_idx)
    ok &= valid_i & valid_j.gather(1, fwd_idx) & valid_j.gather(1, fwd_idx2)

    M = cfg.MAX_MATCHES_PER_PAIR
    keep, count = compact_indices(ok, M)
    mvalid = torch.arange(M, device=d2.device) < count[:, None]
    pairs = torch.stack([keep, fwd_idx.gather(1, keep)], dim=-1)
    pairs = torch.where(mvalid[..., None], pairs, 0)
    return MatchResult(idx=pairs, valid=mvalid, count=count)


def match_pair(desc_i, valid_i, desc_j, valid_j, cfg: Config) -> MatchResult:
    """Match descriptor sets pairwise: [P, K, 128] each (mask-padded), or a
    single pair [K, 128] (the result then keeps a leading pair axis of 1)."""
    if desc_i.dim() == 2:
        desc_i, valid_i, desc_j, valid_j = (
            v[None] for v in (desc_i, valid_i, desc_j, valid_j))
    return match_pair_from_dists(
        _sq_dist_matrix(desc_i, desc_j, valid_i, valid_j),
        desc_i, desc_j, valid_i, valid_j, cfg,
    )


def _match_index_pairs(desc, valid, ii, jj, cfg: Config, chunk: int):
    parts = []
    for lo in range(0, len(ii), chunk):
        i = torch.as_tensor(ii[lo : lo + chunk], device=desc.device)
        j = torch.as_tensor(jj[lo : lo + chunk], device=desc.device)
        parts.append(match_pair(desc[i], valid[i], desc[j], valid[j], cfg))
    return MatchResult(*(torch.cat(f, dim=0) for f in zip(*parts)))


def _chunk_for(K: int) -> int:
    """Pairs per batch that keep the live [K, K] f32 distance matrices
    within ~1.5 GiB."""
    return max(1, int((1.5 * 2**30) // (K * K * 4)))


def match_all_pairs(desc: torch.Tensor, valid: torch.Tensor,
                    cfg: Config) -> MatchResult:
    """All C(n,2) unordered pairs (reference: Stitcher::pairwise_match,
    stitch/stitcher.cc:96-114), in the order of ``pair_indices``, 32 pairs
    at a time (each pair holds a [K,K] distance matrix)."""
    ii, jj = pair_indices(desc.shape[0])
    return _match_index_pairs(desc, valid, ii, jj, cfg, chunk=32)


def match_ring_pairs(desc: torch.Tensor, valid: torch.Tensor,
                     cfg: Config) -> MatchResult:
    """All (i, (i+1) mod n) pairs including the head-tail wrap — the ordered
    path of Stitcher::linear_pairwise_match (stitch/stitcher.cc:116-136),
    where the wrap pair is allowed to fail.  Chunked so that the live
    distance matrices stay within ~1.5 GiB."""
    n = desc.shape[0]
    ii = list(range(n))
    jj = [(i + 1) % n for i in ii]
    return _match_index_pairs(desc, valid, ii, jj, cfg,
                              chunk=_chunk_for(desc.shape[1]))


def match_adjacent_pairs(desc: torch.Tensor, valid: torch.Tensor,
                         cfg: Config) -> MatchResult:
    """Only the n-1 (i, i+1) pairs of ordered input, no wrap pair
    (reference: Stitcher::linear_pairwise_match, stitch/stitcher.cc:116-136,
    as CylinderStitcher uses it).  Chunked like :func:`match_ring_pairs`."""
    ii = list(range(desc.shape[0] - 1))
    return _match_index_pairs(desc, valid, ii, [i + 1 for i in ii], cfg,
                              chunk=_chunk_for(desc.shape[1]))


def pair_indices(n: int) -> tuple[list[int], list[int]]:
    """Host-side unordered pair enumeration (i < j), row-major like the
    reference's double loop (stitcher.cc:102-105)."""
    ii, jj = [], []
    for i in range(n):
        for j in range(i + 1, n):
            ii.append(i)
            jj.append(j)
    return ii, jj
