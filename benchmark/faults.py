"""Faults planted in the port underneath a run, for the tests and the
calibration of the limits (``calibrate.py``): each breaks the timed path
in one of the ways the comparison must catch.  Each is a context manager
that patches one function of the port and restores it."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(mod, name, make):
    orig = getattr(mod, name)
    setattr(mod, name, make(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def lm_unchanged():
    """The bundle adjustment returns the cameras it was given."""
    from openpano_torch.camera import estimator

    return _patched(estimator, "ba_optimize_pairs",
                    lambda orig: lambda params, *a, **k: (params, 0))


def _features_edit(edit):
    from openpano_torch.stitch import stitcher

    def make(orig):
        def run(*a, **k):
            imgs, feats = orig(*a, **k)
            return imgs, edit(feats)
        return run
    return _patched(stitcher, "upload_and_compute_features", make)


def kp_scaled():
    """Every keypoint's position 3% too far from the image centre."""
    return _features_edit(lambda f: f._replace(pos=f.pos * 1.03))


def desc_altered():
    """The first view's descriptors each have their first bin raised by a
    tenth of their norm."""
    def edit(f):
        desc = f.desc.clone()
        desc[0, :, 0] += 0.1 * desc[0].norm(dim=-1) * f.valid[0]
        return f._replace(desc=desc)
    return _features_edit(edit)


def desc_rotated():
    """K2 bins each gradient one orientation bin (an eighth of a turn) off
    the keypoint's direction."""
    import math

    from openpano_torch.sift import descriptor

    def make(orig):
        def run(mag, ort, s, y, x, radius, hw, dirv, *a, **k):
            return orig(mag, ort, s, y, x, radius, hw, dirv + math.pi / 4,
                        *a, **k)
        return run
    return _patched(descriptor, "descriptor_histogram", make)


def _jobs_edit(keep):
    from openpano_torch.stitch import render

    def make(orig):
        def run(color_acc, w_acc, imgs6, hinvs, whs, jobs, *a, **k):
            m = keep(torch.as_tensor(jobs[0]))
            if m is None:
                return None
            jobs = tuple(j[m.numpy()] for j in jobs)
            return orig(color_acc, w_acc, imgs6, hinvs, whs, jobs, *a, **k)
        return run
    return _patched(render, "_run_jobs", make)


def blend_unchanged():
    """The blend leaves its accumulators as they were: an empty canvas."""
    return _jobs_edit(lambda img: None)


def half_batch():
    """The blend leaves out every odd image; the mean is over the rest."""
    return _jobs_edit(lambda img: img % 2 == 0)


def canvas_altered():
    """A 64 x 64 block of the returned canvas changed where it is made."""
    from openpano_torch.stitch import stitcher

    def make(orig):
        def run(*a, **k):
            rgba = orig(*a, **k).copy()
            h, w = rgba.shape[:2]
            y, x = h // 2, w // 2
            rgba[y:y + 64, x:x + 64, :3] += 64
            return rgba
        return run
    return _patched(stitcher, "blend_linear_stream_u8", make)


def _cylinder(name, make):
    from openpano_torch.stitch import cylstitcher

    return _patched(cylstitcher, name, make)


def warp_radius_off():
    """CYLINDER: the image warp's cylinder radius 3% too large; the
    keypoints are warped right."""
    return _cylinder("warp_images", lambda orig: lambda proj, *a, **k: orig(
        proj._replace(r=proj.r * 1.03), *a, **k))


def correction_skipped():
    """CYLINDER: the perspective correction returns the canvas as it got
    it."""
    return _cylinder("perspective_correction",
                     lambda orig: lambda canvas, *a, **k: canvas)


def left_chain_reversed():
    """CYLINDER: the left half's steps (i -> i + 1) chained in the reverse
    order of the pairs, each step's inliers with it."""
    def make(orig):
        def run(matches, pos, valid, whs, ii, jj, *a, **k):
            info = orig(matches, pos, valid, whs, ii, jj, *a, **k)
            if (jj < ii).all():
                info = type(info)(*(f.flip(0) for f in info))
            return info
        return run
    return _cylinder("estimate_transform_batch", make)


FAULTS = {"lm_unchanged": lm_unchanged, "kp_scaled": kp_scaled,
          "desc_altered": desc_altered, "desc_rotated": desc_rotated,
          "blend_unchanged": blend_unchanged,
          "half_batch": half_batch, "canvas_altered": canvas_altered,
          "warp_radius_off": warp_radius_off,
          "correction_skipped": correction_skipped,
          "left_chain_reversed": left_chain_reversed}
