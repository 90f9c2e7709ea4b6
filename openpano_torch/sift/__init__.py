"""The SIFT detector and descriptor (``openpano_tpu.sift``'s public names;
BRIEF is ``sift.brief``)."""

from .descriptor import Features, compute_descriptors
from .detector import detect_and_describe, detect_and_describe_batch
from .extrema import RawKeypoints, detect_extrema
from .orientation import OrientedKeypoints, assign_orientation
from .pyramid import Octave, build_scale_space, octave_shapes

__all__ = [
    "Features", "RawKeypoints", "OrientedKeypoints", "Octave",
    "build_scale_space", "octave_shapes", "detect_extrema",
    "assign_orientation", "compute_descriptors",
    "detect_and_describe", "detect_and_describe_batch",
]
