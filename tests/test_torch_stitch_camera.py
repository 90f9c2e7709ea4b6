"""Port parity for the default ``Config()`` path: camera estimation with the
incremental bundle adjustment and the spherical linear blend, against the
JAX package's ``stitch``, uint8 and float32 input.

Five 240x320 views of a camera yawing over ``procedural_scene_large``
(32 degree field of view, 50% overlap), shuffled to [2, 0, 4, 1, 3] so that
the unordered all-pairs path runs, with the SMALL caps of
tests/test_stitch_full.py.  The two grey routes give different cameras (the
focal comes out near 440 for uint8 and near 538 for float32 input, against
a true 558), in both packages alike.

Gates, end to end: equal canvas size, equal per-image keypoint counts,
equal set of connected pairs, valid masks agreeing on >= 99.9% of pixels,
NCC >= 0.999 over the pixels valid in both.  The estimator alone, on the
JAX run's own match graph (so that the bundle adjustment is held apart from
the features): equal total LM iterations, focal rel 1e-6, R abs 1e-6,
``ba_rms_px`` within 1e-6.  The JAX side runs once per input type.
"""

import dataclasses

import jax
import numpy as np
import pytest

import openpano_tpu  # noqa: F401  (x64 on, as the JAX package runs)
from openpano_tpu.camera.estimator import estimate_cameras as jestimate
from openpano_tpu.config import Config as JConfig
from openpano_tpu.stitch.stitcher import stitch as jstitch
from openpano_torch.camera.estimator import estimate_cameras as port_estimate
from openpano_torch.compat import config_from_fields, key_from_numpy
from openpano_torch.stitch.stitcher import stitch as tstitch
from openpano_torch.synth import procedural_scene_large, render_views

SMALL = dict(
    RANSAC_ITERATIONS=400,
    MAX_CAND_PER_OCTAVE=1024, MAX_KP_PER_OCTAVE=512,
    MAX_DESC_PER_OCTAVE=512, MAX_KP_PER_IMAGE=1024,
    MAX_MATCHES_PER_PAIR=512, SIFT_WORKING_SIZE=400,
)
JCFG = JConfig(**SMALL)
PERM = [2, 0, 4, 1, 3]


def rotating_views(dtype):
    views, _ = render_views(procedural_scene_large(600, 2400, seed=0), 5,
                            out_w=320, out_h=240, hfov_deg=32, overlap=0.5)
    views = views[PERM]
    return np.round(views * 255).astype(np.uint8) if dtype == "u8" else views


def _pairs(graph):
    return {(i, j) for i, j in zip(*np.nonzero(np.triu(graph.conf > 0, 1)))}


@pytest.fixture(scope="module", params=["u8", "f32"])
def both(request):
    """(port, jax) results: (canvas, valid, info) each."""
    views = rotating_views(request.param)
    out = "u8" if request.param == "u8" else "f32"
    key = jax.random.PRNGKey(0)
    res = []
    for run, kw in (
        (tstitch, dict(cfg=config_from_fields(dataclasses.asdict(JCFG)),
                       device="cpu", key=key_from_numpy(np.asarray(key)))),
        (jstitch, dict(cfg=JCFG, key=key)),
    ):
        info = {}
        r = run(views, output=out, info_out=info, **kw)
        canvas, valid = r if out == "u8" else (r, r[..., 0] >= 0)
        res.append((np.asarray(canvas, np.float64), np.asarray(valid), info))
    return res


def test_same_canvas_size(both):
    (tc, _, _), (jc, _, _) = both
    assert tc.shape == jc.shape
    # 5 views x 32 degrees at 50% overlap: about 3x one view's width
    assert jc.shape[1] == pytest.approx(3.0 * 320, rel=0.25)


def test_same_keypoint_counts(both):
    (_, _, ti), (_, _, ji) = both
    np.testing.assert_array_equal(ti["kpt_counts"], ji["kpt_counts"])
    assert ji["kpt_counts"].min() > 200


def test_same_connected_pairs(both):
    (_, _, ti), (_, _, ji) = both
    assert _pairs(ti["graph"]) == _pairs(ji["graph"])
    assert ti["connected_pairs"] == ji["connected_pairs"] >= 4
    assert ti["total_inliers"] == ji["total_inliers"]


def test_valid_masks_agree(both):
    (_, tv, _), (_, jv, _) = both
    assert (tv == jv).mean() >= 0.999
    assert jv.mean() > 0.3


def test_canvas_ncc(both):
    (tc, tv, _), (jc, jv, _) = both
    m = tv & jv
    a = tc[m] - tc[m].mean()
    b = jc[m] - jc[m].mean()
    ncc = (a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum())
    assert ncc >= 0.999


def test_cameras_and_ba_stats_close(both):
    """Beyond the gates above: the end-to-end cameras (which see the RANSAC
    refits' 1e-6 rounding differences) stay within 1e-3."""
    (_, _, ti), (_, _, ji) = both
    np.testing.assert_allclose(ti["cams"].focal, ji["cams"].focal, rtol=1e-3)
    assert ti["ba_pairs"] == ji["ba_pairs"]
    assert ti["ba_points"] == ji["ba_points"]
    assert abs(ti["ba_rms_px"] - ji["ba_rms_px"]) < 1e-3


def test_estimator_on_jax_graph(both):
    """The port's estimator on the JAX run's match graph."""
    _, (_, _, ji) = both
    g = ji["graph"]
    whs = np.repeat([[320.0, 240.0]], 5, 0)
    js, ts = {}, {}
    args = (g.conf, g.homo, g.to_pos, g.from_pos, g.valid, whs)
    want = jestimate(*args, JCFG, stats=js)
    got = port_estimate(*args, config_from_fields(dataclasses.asdict(JCFG)),
                          stats=ts, device="cpu")
    assert ts["lm_iters"] == js["lm_iters"] > 0
    np.testing.assert_allclose(got.focal, want.focal, rtol=1e-6)
    np.testing.assert_allclose(got.R, want.R, rtol=0, atol=1e-6)
    assert abs(ts["ba_rms_px"] - js["ba_rms_px"]) < 1e-6
