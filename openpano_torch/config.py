"""Typed configuration, field for field the same as ``openpano_tpu.config``.

Mirrors the knob surface of the reference engine's ``config.cfg``
(reference: lib/config.hh:24-86, src/config.cfg:1-69), plus the fixed-shape
capacity knobs of the JAX package.  Every field and default is the JAX
package's, so a config file or a ``dataclasses.asdict`` of a JAX ``Config``
means the same thing here (see :mod:`openpano_torch.compat`).  The same
whitespace key-value file format is accepted by :func:`Config.from_file`
(reference: lib/config.cc:13-35).

``STREAM_BLEND`` (on by default) sends a u8-output linear blend through
``render.blend_linear_stream_u8``, which downloads each finished column
strip while later strips compute, as in the JAX package; the canvas is the
same either way.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Config:
    # ---- modes (reference: config.cfg:1-5); mutually exclusive ----
    CYLINDER: bool = False
    ESTIMATE_CAMERA: bool = True
    TRANS: bool = False

    ORDERED_INPUT: bool = False
    CROP: bool = True
    MAX_OUTPUT_SIZE: int = 8000
    LAZY_READ: bool = True  # accepted for config-file parity

    FOCAL_LENGTH: float = 37.0  # 35mm-equivalent focal, CYLINDER mode

    # ---- keypoint / scale-space (reference: config.cfg:17-37) ----
    SIFT_WORKING_SIZE: int = 800
    NUM_OCTAVE: int = 4
    NUM_SCALE: int = 7
    SCALE_FACTOR: float = 1.4142135623
    GAUSS_SIGMA: float = 1.4142135623
    GAUSS_WINDOW_FACTOR: int = 6
    CONTRAST_THRES: float = 4e-2
    JUDGE_EXTREMA_DIFF_THRES: float = 2e-3
    EDGE_RATIO: float = 6.0
    PRE_COLOR_THRES: float = 5e-2
    CALC_OFFSET_DEPTH: int = 4
    OFFSET_THRES: float = 0.5

    # ---- descriptor & matching (reference: config.cfg:40-56) ----
    ORI_RADIUS: float = 4.5
    ORI_HIST_SMOOTH_COUNT: int = 2
    DESC_HIST_SCALE_FACTOR: float = 3.0
    DESC_INT_FACTOR: float = 512.0
    MATCH_REJECT_NEXT_RATIO: float = 0.8
    RANSAC_ITERATIONS: int = 1500
    RANSAC_INLIER_THRES: float = 3.5
    INLIER_IN_MATCH_RATIO: float = 0.1
    INLIER_IN_POINTS_RATIO: float = 0.04

    # ---- optimization (reference: config.cfg:59-66) ----
    STRAIGHTEN: bool = True
    SLOPE_PLAIN: float = 8e-3
    LM_LAMBDA: float = 5.0
    MULTIPASS_BA: int = 1

    # ---- blending (reference: config.cfg:69) ----
    MULTIBAND: int = 0

    # ---- compile-time constants of the reference (lib/config.hh:72-85) ----
    ORI_WINDOW_FACTOR: float = 1.5
    ORI_HIST_BIN_NUM: int = 36
    ORI_HIST_PEAK_RATIO: float = 0.8
    DESC_HIST_WIDTH: int = 4
    DESC_HIST_BIN_NUM: int = 8

    # ---- fixed-shape capacity knobs (no reference analog) ----
    # Per-octave cap on raw extrema candidates entering sub-pixel refinement.
    MAX_CAND_PER_OCTAVE: int = 4096
    # Per-octave cap on refined keypoints (before orientation duplication).
    MAX_KP_PER_OCTAVE: int = 2048
    # Max orientations emitted per keypoint (the reference emits every peak
    # >= 0.8*max; more than 3 peaks is vanishingly rare).
    MAX_ORI_PER_KP: int = 3
    # Per-octave cap on oriented/described keypoints.
    MAX_DESC_PER_OCTAVE: int = 2048
    # Final cap on keypoints per image (compacted across octaves).
    MAX_KP_PER_IMAGE: int = 4096
    # Cap on (ratio+mutual tested) matches kept per image pair.
    MAX_MATCHES_PER_PAIR: int = 1024
    # Grid resolution for the overlap-area estimate (replaces the reference's
    # sampled convex hull + shoelace area, transform_estimate.cc:204-208).
    OVERLAP_AREA_GRID: int = 64
    RANSAC_DTYPE: str = "float32"
    BA_DTYPE: str = "float64"
    # Bundle-adjustment knobs of the camera stack: where the LM runs (host
    # CPU or the card), the robust focal estimate, adaptive damping and the
    # incremental schedule's caps.
    BA_ON_HOST: bool = True
    ROBUST_FOCAL: bool = True
    BA_ADAPTIVE_LM: bool = True
    BA_INTERMEDIATE_ITERS: int = 9
    BA_INTERMEDIATE_PATIENCE: int = 1
    BA_INTERMEDIATE_POINT_SLOTS: int = 1
    BA_INTERMEDIATE_REL_TOL: float = 0.0
    BA_FINAL_MAX_ITER: int = 100
    BA_FINAL_PATIENCE: int = 5
    BA_BATCH_IMAGES: int = 1
    # Streamed u8 blend of the JAX package (a transfer-overlap device; the
    # port's blend produces the same canvas either way).
    STREAM_BLEND: bool = True

    @property
    def DESC_LEN(self) -> int:
        return self.DESC_HIST_WIDTH * self.DESC_HIST_WIDTH * self.DESC_HIST_BIN_NUM

    def validate(self) -> "Config":
        if int(self.CYLINDER) + int(self.ESTIMATE_CAMERA) + int(self.TRANS) > 1:
            raise ValueError("CYLINDER/ESTIMATE_CAMERA/TRANS are mutually exclusive")
        if self.CYLINDER and not self.ORDERED_INPUT:
            raise ValueError("CYLINDER mode requires ORDERED_INPUT")
        return self

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    # knobs the reference's init_config() reads with the fatal CFG() macro
    # (main.cc:237-292); a config file missing any of these aborts there
    # (lib/config.cc:31-35), so we match — minus LAZY_READ, which is an
    # accepted-but-optional field here.
    REFERENCE_KNOBS = (
        "CYLINDER", "TRANS", "ESTIMATE_CAMERA", "ORDERED_INPUT", "CROP",
        "STRAIGHTEN", "FOCAL_LENGTH", "MAX_OUTPUT_SIZE", "SIFT_WORKING_SIZE",
        "NUM_OCTAVE", "NUM_SCALE", "SCALE_FACTOR", "GAUSS_SIGMA",
        "GAUSS_WINDOW_FACTOR", "JUDGE_EXTREMA_DIFF_THRES", "CONTRAST_THRES",
        "PRE_COLOR_THRES", "EDGE_RATIO", "CALC_OFFSET_DEPTH", "OFFSET_THRES",
        "ORI_RADIUS", "ORI_HIST_SMOOTH_COUNT", "DESC_HIST_SCALE_FACTOR",
        "DESC_INT_FACTOR", "MATCH_REJECT_NEXT_RATIO", "RANSAC_ITERATIONS",
        "RANSAC_INLIER_THRES", "INLIER_IN_MATCH_RATIO",
        "INLIER_IN_POINTS_RATIO", "SLOPE_PLAIN", "LM_LAMBDA", "MULTIPASS_BA",
        "MULTIBAND",
    )

    @classmethod
    def from_file(cls, path: str, strict: bool = True, **overrides) -> "Config":
        """Parse the reference's config file format: whitespace-separated
        key value pairs, '#' comments, every value numeric
        (reference: lib/config.cc:13-29).

        strict=True matches the reference's fatal missing-key behavior
        (config.cc:31-35): every REFERENCE_KNOBS entry must appear in the
        file (or in ``overrides``).  Unknown file keys warn (the reference
        silently never reads them)."""
        import warnings

        values = {}
        field_map = {f.name: f for f in dataclasses.fields(cls)}
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = line.split()
                if len(parts) < 2:
                    continue
                key, val = parts[0], float(parts[1])
                if key not in field_map:
                    warnings.warn(f"config {path}: unknown key {key!r}")
                    continue
                ftype = field_map[key].type
                if ftype in ("bool", bool):
                    values[key] = bool(val)
                elif ftype in ("int", int):
                    values[key] = int(val)
                else:
                    values[key] = float(val)
        values.update(overrides)
        if strict:
            missing = [k for k in cls.REFERENCE_KNOBS if k not in values]
            if missing:
                raise KeyError(
                    f"Option {missing[0]} not found in config file {path}!"
                )  # lib/config.cc:31-35
        return cls(**values).validate()


DEFAULT = Config()


def gauss_window_radius(sigma: float, window_factor: int) -> int:
    """Kernel half-width for a given sigma; the full width is forced odd
    (reference: feature/gaussian.cc:22-24)."""
    kw = int(math.ceil(0.3 * (sigma / 2.0 - 1.0) + 0.8) * window_factor)
    if kw % 2 == 0:
        kw += 1
    return kw // 2
