"""SIFT detector facade: working images -> keypoints + RootSIFT descriptors.

Mirrors SIFTDetector::do_detect_feature (feature/feature.cc:31-46) as
``openpano_tpu/sift/detector.py`` does: ScaleSpace -> DoG -> extrema run per
octave at native shapes; raw keypoints of all octaves are compacted into
one MAX_KP_PER_IMAGE-slot set, and the mag/ort planes are stacked (smaller
octaves zero-padded to octave 0's shape) so that orientation and
descriptor each run as ONE kernel launch for the whole image batch.
Keypoint real coordinates in [0,1) become half-shifted original-image
coordinates (feature.cc:20-28): pos = (real - 0.5) * (w, h).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import Config
from ..ops.compact import compact_indices
from ..ops.imgproc import rgb2grey
from .descriptor import Features, describe_keypoints
from .extrema import RawKeypoints, detect_extrema
from .orientation import orient_keypoints
from .pyramid import build_scale_space


def octave_caps(cfg: Config, octave_index: int) -> tuple[int, int, int]:
    """(cand, keypoint, descriptor) caps for one octave: the base per-octave
    caps halved per octave (>= 128)."""
    def scale(base):
        return max(base >> octave_index, 128)
    return (
        scale(cfg.MAX_CAND_PER_OCTAVE),
        scale(cfg.MAX_KP_PER_OCTAVE),
        scale(cfg.MAX_DESC_PER_OCTAVE),
    )


def keypoint_candidates(octaves, cfg: Config):
    """The extrema of every octave under its caps, compacted into one
    MAX_KP_PER_IMAGE-slot set per image, and the octaves' mag / ort planes
    stacked (smaller octaves zero-padded to octave 0's shape).  Returns
    (raw keypoints, their octave (w, h) [B, K, 2], mag [B, O*S, H0, W0],
    ort)."""
    B = octaves[0].mag.shape[0]
    S = cfg.NUM_SCALE
    H0, W0 = octaves[0].mag.shape[-2], octaves[0].mag.shape[-1]
    dev = octaves[0].mag.device

    raws, whs, mags, orts = [], [], [], []
    for oi, octave in enumerate(octaves):
        caps = octave_caps(cfg, oi)
        raw = detect_extrema(octave, cfg, cap_cand=caps[0], cap_kp=caps[1])
        oh, ow = octave.mag.shape[-2], octave.mag.shape[-1]
        raws.append(raw._replace(s=raw.s + oi * S))  # octave folds into scale
        whs.append(torch.tensor([ow, oh], dtype=torch.float32,
                                device=dev).expand(B, caps[1], 2))
        mags.append(F.pad(octave.mag, (0, W0 - ow, 0, H0 - oh)))
        orts.append(F.pad(octave.ort, (0, W0 - ow, 0, H0 - oh)))
    mag_all = torch.cat(mags, dim=1)                 # [B, O*S, H0, W0]
    ort_all = torch.cat(orts, dim=1)
    raw_all = RawKeypoints(*(torch.cat(f, dim=1) for f in zip(*raws)))
    wh_all = torch.cat(whs, dim=1)

    # compact raw keypoints from all octaves into the per-image budget
    K = cfg.MAX_KP_PER_IMAGE
    keep, n = compact_indices(raw_all.valid, K)
    rvalid = torch.arange(K, device=keep.device) < n[:, None]
    raw_c = RawKeypoints(*(a.gather(1, keep) for a in raw_all))
    raw_c = raw_c._replace(valid=rvalid)
    wh_c = wh_all.gather(1, keep[..., None].expand(-1, -1, 2))
    return raw_c, wh_c, mag_all, ort_all


def keypoint_features(oriented, desc: torch.Tensor,
                      orig_wh: torch.Tensor) -> Features:
    """Features of oriented keypoints and their descriptors, at
    half-shifted original-image coordinates; zero where invalid."""
    kvalid = oriented.valid
    pos = torch.stack(
        [(oriented.real_x - 0.5) * orig_wh[:, 0:1],
         (oriented.real_y - 0.5) * orig_wh[:, 1:2]],
        dim=-1,
    )
    return Features(
        pos=torch.where(kvalid[..., None], pos, 0.0),
        desc=torch.where(kvalid[..., None], desc, 0.0),
        valid=kvalid,
    )


def detect_and_describe(imgs: torch.Tensor, orig_wh: torch.Tensor,
                        cfg: Config) -> Features:
    """imgs: [B, H, W] grey or [B, H, W, 3] RGB float32 working images
    (already at SIFT working size); orig_wh: [B, 2] original (w, h) for the
    coordinate output.  Returns Features [B, MAX_KP_PER_IMAGE, ...]."""
    grey = rgb2grey(imgs) if imgs.dim() == 4 else imgs
    octaves = build_scale_space(grey, cfg)
    raw_c, wh_c, mag_all, ort_all = keypoint_candidates(octaves, cfg)
    oriented, wh_o = orient_keypoints(raw_c, mag_all, ort_all, cfg,
                                      cap=cfg.MAX_KP_PER_IMAGE, wh=wh_c)
    desc = describe_keypoints(oriented, mag_all, ort_all, cfg, wh=wh_o)
    return keypoint_features(oriented, desc, orig_wh)


def detect_and_describe_batch(imgs: torch.Tensor, orig_whs: torch.Tensor,
                              cfg: Config) -> Features:
    """imgs: [B, H, W, 3] (or [B, H, W] grey) working-size batch; orig_whs:
    [B, 2].  :func:`detect_and_describe`, which is batched already (the
    JAX package's vmapped form)."""
    return detect_and_describe(imgs, orig_whs, cfg)
