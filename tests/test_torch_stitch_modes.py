"""Port parity for the other stitching modes and the file entry point.

- The naive flat mode (``ESTIMATE_CAMERA=False, TRANS=False``: perspective
  RANSAC, homographies chained from the middle view, prescaled by the focal
  estimate) on five rotating views in sweep order, uint8 in and out;
- ``stitch_hetero`` on the same views with every other one resized to
  192x256 (resized once, beforehand, and handed to both packages), float32
  in, uint8 out;
against the JAX package, at the gates of the default path: equal canvas
size, equal keypoint counts, equal connected pairs, valid masks agreeing on
>= 99.9% of pixels, NCC >= 0.999.  The JAX side runs once per mode.

``stitch_files`` on PNGs written by the port's ``write_rgb`` equals
``stitch_images`` (or ``stitch_hetero``) followed by ``crop_with_mask``;
the PNG codec agrees with the JAX package's byte for byte.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import openpano_tpu  # noqa: F401  (x64 on, as the JAX package runs)
from openpano_tpu.config import Config as JConfig
from openpano_tpu.io import image as jimage
from openpano_tpu.stitch.stitcher import stitch as jstitch
from openpano_tpu.stitch.stitcher import stitch_hetero as jstitch_hetero
from openpano_torch import stitch_files, stitch_images
from openpano_torch.compat import config_from_fields, key_from_numpy
from openpano_torch.io import image as timage
from openpano_torch.ops.imgproc import crop_with_mask, resize
from openpano_torch.stitch.stitcher import stitch as tstitch
from openpano_torch.stitch.stitcher import stitch_hetero as tstitch_hetero
from openpano_torch.synth import procedural_scene_large, render_views

SMALL = dict(
    RANSAC_ITERATIONS=400,
    MAX_CAND_PER_OCTAVE=1024, MAX_KP_PER_OCTAVE=512,
    MAX_DESC_PER_OCTAVE=512, MAX_KP_PER_IMAGE=1024,
    MAX_MATCHES_PER_PAIR=512, SIFT_WORKING_SIZE=400,
)
MODES = {
    "naive": JConfig(ESTIMATE_CAMERA=False, **SMALL),
    "hetero": JConfig(**SMALL),
}


def sweep_views():
    views, _ = render_views(procedural_scene_large(600, 2400, seed=0), 5,
                            out_w=320, out_h=240, hfov_deg=32, overlap=0.5)
    return views


def hetero_views():
    views = sweep_views()
    return [resize(torch.from_numpy(v), 192, 256, rgb=True).numpy()
            if k % 2 else v for k, v in enumerate(views)]


def _pairs(graph):
    return {(i, j) for i, j in zip(*np.nonzero(np.triu(graph.conf > 0, 1)))}


@pytest.fixture(scope="module", params=list(MODES))
def both(request):
    """(port, jax) results: (canvas, valid, info) each."""
    jcfg = MODES[request.param]
    tcfg = config_from_fields(dataclasses.asdict(jcfg))
    key = jax.random.PRNGKey(0)
    tkey = key_from_numpy(np.asarray(key))
    if request.param == "naive":
        views = np.round(sweep_views() * 255).astype(np.uint8)
        runs = ((tstitch, dict(cfg=tcfg, key=tkey, device="cpu")),
                (jstitch, dict(cfg=jcfg, key=key)))
    else:
        views = hetero_views()
        runs = ((tstitch_hetero, dict(cfg=tcfg, key=tkey, device="cpu")),
                (jstitch_hetero, dict(cfg=jcfg, key=key)))
    res = []
    for run, kw in runs:
        info = {}
        canvas, valid = run(views, output="u8", info_out=info, **kw)
        res.append((np.asarray(canvas, np.float64), np.asarray(valid), info))
    return res


def test_same_canvas_size(both):
    (tc, _, _), (jc, _, _) = both
    assert tc.shape == jc.shape
    assert jc.shape[1] > 2.0 * 320


def test_same_keypoint_counts(both):
    (_, _, ti), (_, _, ji) = both
    np.testing.assert_array_equal(ti["kpt_counts"], ji["kpt_counts"])
    assert ji["kpt_counts"].min() > 100


def test_same_connected_pairs(both):
    (_, _, ti), (_, _, ji) = both
    assert _pairs(ti["graph"]) == _pairs(ji["graph"]) \
        >= {(0, 1), (1, 2), (2, 3), (3, 4)}


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


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------


def _write_views(tmp_path, views):
    paths = []
    for k, v in enumerate(views):
        p = str(tmp_path / f"view{k}.png")
        timage.write_rgb(p, v)
        paths.append(p)
    return paths


@pytest.mark.parametrize("hetero", [False, True])
def test_stitch_files_equals_stitch_and_crop(tmp_path, hetero):
    views = hetero_views() if hetero else list(sweep_views())
    paths = _write_views(tmp_path, views)
    u8 = [timage.read_img_u8(p) for p in paths]
    cfg = config_from_fields(dataclasses.asdict(MODES["hetero"]))
    out = str(tmp_path / "pano.png")
    got = stitch_files(paths, cfg, out=out, device="cpu")
    if hetero:
        canvas, valid = tstitch_hetero(u8, cfg, output="u8", device="cpu")
    else:
        canvas, valid = stitch_images(np.stack(u8), cfg, output="u8",
                                      device="cpu")
    want = crop_with_mask(canvas, valid)
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] > 2.0 * 256 and got.dtype == np.uint8
    np.testing.assert_array_equal(timage.read_img_u8(out), got)
    uncropped = stitch_files(paths, cfg, crop=False, device="cpu")
    np.testing.assert_array_equal(uncropped, canvas)


@pytest.mark.parametrize("dtype", ["u8", "f32"])
def test_png_codec_equals_jax(tmp_path, dtype):
    rng = np.random.default_rng(3)
    img = rng.uniform(-0.2, 1.0, size=(37, 53, 3)).astype(np.float32)
    if dtype == "u8":
        img = np.round(np.clip(img, 0, 1) * 255).astype(np.uint8)
    tp, jp = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    timage.write_rgb(tp, img)
    jimage.write_rgb(jp, img)
    with open(tp, "rb") as f, open(jp, "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(timage.read_img_u8(tp),
                                  jimage.read_img_u8(jp))
    np.testing.assert_array_equal(timage.read_img(tp), jimage.read_img(jp))
