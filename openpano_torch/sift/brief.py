"""BRIEF binary descriptor (alternative to SIFT, reference: feature/brief.{hh,cc}).

Counterpart of ``openpano_tpu/sift/brief.py``.  Pattern II of the BRIEF
paper: point pairs drawn from N(0.5s, 0.2s) inside an s x s patch
(brief.cc:66-91), default s=9, n=256 pairs (BRIEF_PATH_SIZE /
BRIEF_NR_PAIR, lib/config.hh:82-83).  The reference packs bits into words
and matches with a popcount hamming distance (dist.cc:93-101); no stitch
path calls it (StitcherBase hardcodes SIFT, stitcherbase.hh:53), but it is
part of the feature layer's surface.

Descriptors are one batched gather + compare + bit-pack into 32-bit words,
held as int64 tensors of uint32 values (PyTorch's uint32 lacks most
kernels).  PyTorch has no popcount, so the hamming matrix counts the bits
of each XOR word with a SWAR popcount, one word at a time (a [Ki, Kj, W]
XOR tensor would be 1 GiB at K = 4096).  Matching applies the ratio and
mutual-best acceptance of the float matcher.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..match.matcher import MatchResult, _top2
from ..ops.compact import compact_indices

BRIEF_PATCH_SIZE = 9   # lib/config.hh:82
BRIEF_NR_PAIR = 256    # lib/config.hh:83
_BIG = 3.4e38


class BriefPattern(NamedTuple):
    s: int
    offsets: np.ndarray  # [n, 4] int32: dy1, dx1, dy2, dx2 relative to center


def gen_brief_pattern(seed: int = 0, s: int = BRIEF_PATCH_SIZE,
                      n: int = BRIEF_NR_PAIR) -> BriefPattern:
    """Sample the point-pair pattern (brief.cc:66-91): coordinates ~
    N(0.5s, 0.2s) redrawn until inside [0, s); identical pairs redrawn."""
    assert s % 2 == 1 and n % 32 == 0
    rng = np.random.default_rng(seed)

    def sample():
        while True:
            v = int(round(rng.normal(0.5 * s, 0.2 * s)))
            if 0 <= v < s:
                return v

    half = s // 2
    offs = np.zeros((n, 4), np.int32)
    for i in range(n):
        x1, y1 = sample(), sample()
        while True:
            x2, y2 = sample(), sample()
            if not (y1 == x1 and y2 == x2):  # quirk kept from brief.cc:82-86
                break
        offs[i] = (y1 - half, x1 - half, y2 - half, x2 - half)
    return BriefPattern(s=s, offsets=offs)


def compute_brief(grey: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor,
                  offsets, s: int):
    """grey: [H, W] f32; pts: [K, 2] (x, y) pixel coords; valid: [K] bool;
    offsets: [n, 4] (numpy or tensor).  Returns (desc [K, n//32] int64
    holding uint32 words, bit b of word k = pair 32k + b; valid [K]) —
    keypoints whose patch leaves the image are dropped (brief.cc:22-29)."""
    H, W = grey.shape
    half = s // 2
    offsets = torch.as_tensor(np.asarray(offsets), dtype=torch.int64,
                              device=grey.device)
    x = torch.round(pts[:, 0]).to(torch.int64)     # half to even, as jnp
    y = torch.round(pts[:, 1]).to(torch.int64)
    ok = valid & (x >= half) & (x + half < W) & (y >= half) & (y + half < H)
    xc = torch.clamp(x, half, W - half - 1)[:, None]
    yc = torch.clamp(y, half, H - half - 1)[:, None]
    bits = (grey[yc + offsets[:, 0], xc + offsets[:, 1]]
            > grey[yc + offsets[:, 2], xc + offsets[:, 3]])   # [K, n]
    n = offsets.shape[0]
    shifts = torch.arange(32, device=grey.device)
    words = bits.reshape(-1, n // 32, 32).to(torch.int64) << shifts
    return words.sum(-1), ok


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each uint32 value held in an int64 tensor (SWAR)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_dist_matrix(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """[Ki, W] x [Kj, W] packed-word descriptors -> [Ki, Kj] f32 hamming
    distances (dist.cc:93-101, popcount over XOR), reduced word by word."""
    d = torch.zeros(da.shape[0], db.shape[0], dtype=torch.int64,
                    device=da.device)
    for k in range(da.shape[1]):
        d += popcount32(da[:, k, None] ^ db[None, :, k])
    return d.to(torch.float32)


def _top2_values(d: torch.Tensor):
    """(d1, d2nd, i1) along the last axis: the two smallest entries (the
    second taken after the first is masked out) and the first's index."""
    i1, i2 = _top2(d)
    d1 = d.gather(-1, i1[..., None])[..., 0]
    d2 = torch.where(i2 == i1, _BIG, d.gather(-1, i2[..., None])[..., 0])
    return d1, d2, i1


def match_brief(desc_i, valid_i, desc_j, valid_j, cfg: Config) -> MatchResult:
    """Hamming 2-NN with the ratio + mutual-best acceptance of the float
    matcher (matcher.cc:51-62,108-123); the integer hamming matrix is exact,
    so no distance recompute is needed.  One pair: the result keeps a
    leading pair axis of 1, as ``matcher.match_pair`` does."""
    d2 = hamming_dist_matrix(desc_i, desc_j)
    Ki = d2.shape[0]
    r2 = float(torch.tensor(cfg.MATCH_REJECT_NEXT_RATIO ** 2,
                            dtype=torch.float32))
    d2 = torch.where(valid_i[:, None] & valid_j[None, :], d2, _BIG)
    fwd_d1, fwd_d2, fwd_idx = _top2_values(d2)
    _, rev_d2, rev_idx = _top2_values(d2.T)

    ok = fwd_d1 <= r2 * fwd_d2
    ok &= rev_idx[fwd_idx] == torch.arange(Ki, device=d2.device)
    ok &= fwd_d1 <= r2 * rev_d2[fwd_idx]
    ok &= valid_i & (fwd_d1 < _BIG)

    M = cfg.MAX_MATCHES_PER_PAIR
    keep, count = compact_indices(ok, M)
    mvalid = torch.arange(M, device=d2.device) < count
    pairs = torch.stack([keep, fwd_idx[keep]], dim=-1)
    return MatchResult(idx=torch.where(mvalid[:, None], pairs, 0)[None],
                       valid=mvalid[None], count=count[None])
