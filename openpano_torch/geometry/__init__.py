"""Homography utilities, DLT and RANSAC (``openpano_tpu.geometry``'s public
names)."""

from .dlt import affine_dlt, normalized_transform, perspective_dlt
from .homography import (
    health,
    homo_inverse,
    overlap_area_fraction,
    overlap_mask_in1,
    trans2d,
    translation,
)
from .ransac import MatchInfo, estimate_transform, estimate_transform_batch

__all__ = [
    "health",
    "homo_inverse",
    "trans2d",
    "translation",
    "overlap_mask_in1",
    "overlap_area_fraction",
    "perspective_dlt",
    "affine_dlt",
    "normalized_transform",
    "MatchInfo",
    "estimate_transform",
    "estimate_transform_batch",
]
