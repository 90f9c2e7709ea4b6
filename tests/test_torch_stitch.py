"""Port parity for the whole slice: TRANS-mode stitching of a translated
strip, uint8 and float32 input, against the JAX package's ``stitch``.

Four translated 240x320 crops of ``procedural_scene_large`` (50% overlap),
the SMALL caps of tests/test_stitch_full.py.  Gates: equal canvas size,
equal per-image keypoint counts, equal set of connected pairs, valid masks
agreeing on >= 99.9% of pixels, and NCC >= 0.999 over the pixels valid in
both.  The JAX side runs once per input type for the module.
"""

import dataclasses

import jax
import numpy as np
import pytest

import openpano_tpu  # noqa: F401  (x64 on, as the JAX package runs)
from openpano_tpu.config import Config as JConfig
from openpano_tpu.stitch.stitcher import stitch as jstitch
from openpano_torch import Config, stitch_images
from openpano_torch.compat import config_from_fields, key_from_numpy
from openpano_torch.stitch.stitcher import stitch as tstitch
from openpano_torch.synth import procedural_scene_large, render_views, \
    strip_views

SMALL = dict(
    RANSAC_ITERATIONS=400,
    MAX_CAND_PER_OCTAVE=1024, MAX_KP_PER_OCTAVE=512,
    MAX_DESC_PER_OCTAVE=512, MAX_KP_PER_IMAGE=1024,
    MAX_MATCHES_PER_PAIR=512, SIFT_WORKING_SIZE=400,
)
JCFG = JConfig(ESTIMATE_CAMERA=False, TRANS=True, ORDERED_INPUT=True, **SMALL)


def _views(dtype):
    v = strip_views(4, 320, 240, overlap=0.5, seed=0)
    return np.round(v * 255).astype(np.uint8) if dtype == "u8" else v


def _pairs(graph):
    return {(i, j) for i, j in zip(*np.nonzero(np.triu(graph.conf > 0, 1)))}


@pytest.fixture(scope="module", params=["u8", "f32"])
def both(request):
    """(port, jax) results: (canvas, valid, info) each."""
    views = _views(request.param)
    out = "u8" if request.param == "u8" else "f32"
    key = jax.random.PRNGKey(0)
    res = []
    for run, kw in (
        (tstitch, dict(cfg=config_from_fields(dataclasses.asdict(JCFG)), device="cpu",
                       key=key_from_numpy(np.asarray(key)))),
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
    assert jc.shape[1] == pytest.approx(320 + 3 * 160, rel=0.1)
    assert jc.shape[0] == pytest.approx(240, rel=0.1)


def test_same_keypoint_counts(both):
    (_, _, ti), (_, _, ji) = both
    np.testing.assert_array_equal(ti["kpt_counts"], ji["kpt_counts"])
    assert ji["kpt_counts"].min() > 50


def test_same_connected_pairs(both):
    (_, _, ti), (_, _, ji) = both
    assert _pairs(ti["graph"]) == _pairs(ji["graph"]) \
        >= {(0, 1), (1, 2), (2, 3)}
    assert ti["connected_pairs"] == ji["connected_pairs"]


def test_valid_masks_agree(both):
    (_, tv, _), (_, jv, _) = both
    assert (tv == jv).mean() >= 0.999
    assert jv.mean() > 0.8


def test_canvas_ncc(both):
    (tc, tv, _), (jc, jv, _) = both
    m = tv & jv
    a = tc[m] - tc[m].mean()
    b = jc[m] - jc[m].mean()
    ncc = (a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum())
    assert ncc >= 0.999


def test_stitch_images_entry_point():
    """The public entry point on the CPU (u8 out) in TRANS mode, and in the
    default ``Config()``, the naive flat mode, the default with
    MULTIBAND=2 and CYLINDER mode on rotating views."""
    cfg = config_from_fields(dataclasses.asdict(JCFG))
    canvas, valid = stitch_images(_views("u8"), cfg, output="u8",
                                  device="cpu")
    assert canvas.dtype == np.uint8 and canvas.shape[:2] == valid.shape
    assert canvas.shape[1] > 700 and valid.mean() > 0.8
    views, _ = render_views(procedural_scene_large(600, 2400, seed=0), 5,
                            out_w=320, out_h=240, hfov_deg=32, overlap=0.5)
    u8 = np.round(views * 255).astype(np.uint8)
    default = Config(**SMALL)
    for mode in (default, default.replace(ESTIMATE_CAMERA=False)):
        info = {}
        canvas, valid = stitch_images(u8, mode, output="u8", device="cpu",
                                      info_out=info)
        assert canvas.shape[1] > 2.0 * 320 and valid.mean() > 0.3
        assert info["connected_pairs"] >= 4
        assert ("cams" in info) == mode.ESTIMATE_CAMERA
    info = {}
    canvas, valid = stitch_images(u8, default.replace(MULTIBAND=2),
                                  output="u8", device="cpu", info_out=info)
    assert canvas.shape[1] > 2.0 * 320 and valid.mean() > 0.3
    assert info["plan"].out_w == canvas.shape[1]
    cyl = default.replace(ESTIMATE_CAMERA=False, CYLINDER=True,
                          ORDERED_INPUT=True)
    info = {}
    canvas, valid = stitch_images(u8, cyl, output="u8", device="cpu",
                                  info_out=info)
    assert canvas.dtype == np.uint8 and canvas.shape[:2] == valid.shape
    assert canvas.shape[1] > 2.0 * 320 and valid.mean() > 0.8
    assert 0.5 <= info["hfactor"] <= 1.5 and 1 <= info["trials"] <= 4
