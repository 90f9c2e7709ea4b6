"""Cameras, the rotation helpers, the bundle adjustment and the camera
estimator (``openpano_tpu.camera``'s public names)."""

from .bundle_adjuster import BAProblem, ba_optimize
from .camera import CameraSet, estimate_focal, intrinsic, straighten
from .estimator import estimate_cameras
from .rotation import rodrigues, rotation_to_angle

__all__ = [
    "rodrigues",
    "rotation_to_angle",
    "CameraSet",
    "estimate_focal",
    "straighten",
    "intrinsic",
    "BAProblem",
    "ba_optimize",
    "estimate_cameras",
]
