"""Port parity for CYLINDER mode against the JAX package, on the CPU.

- ``make_projector``: every field equal (host f64 arithmetic, copied);
- ``warp_keypoints``: within 1e-4 px (f32 atan / hypot, and XLA:CPU's
  contraction of ``px * sizefactor + offset``, round differently);
- ``warp_image``: colour within 1e-4 where both are valid; the valid masks
  differ only on the boundary of the valid region (tan / cos ulps move a
  sample across the bilinear bound), on under 1% of the pixels;
- ``match_adjacent_pairs``: equal indices on the same descriptors;
- ``perspective_correction``: a fixed canvas and fixed homographies, canvas
  within 1e-4 and masks equal but for a counted few edge pixels;
- ``stitch_cylinder`` end to end on 6 procedural views of 320x240 with the
  caps of tests/test_stitch_cylinder.py: uint8 in with the linear blender,
  float32 in with MULTIBAND=2.  The chosen h-factor and number of trials are
  equal, the homographies within 1e-4 relative, the canvas shape equal,
  valid masks agree on >= 99.9% and NCC >= 0.999.  The JAX side runs once
  per input type.

The scene is ``procedural_scene_large(600, 2400, seed=2)``.  With seed 0,
one DoG extremum of the third view sits at a gate margin and flips in the
uint8 route: the port's blur and XLA:CPU's convolution sum their taps in
another order (blurred levels differ by up to 2.4e-7).
``test_seed0_extremum_flip_is_the_blur`` pins that cause: the port's
extrema code on the JAX package's scale space gives the JAX keypoints.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openpano_tpu  # noqa: F401  (x64 on, as the JAX package runs)
from openpano_tpu.config import Config as JConfig
from openpano_tpu.match import matcher as jmatcher
from openpano_tpu.stitch import cylstitcher as jcyl
from openpano_tpu.stitch import warp as jwarp
from openpano_tpu.stitch.render import plan_render as jplan_render
from openpano_torch.compat import config_from_fields, key_from_numpy
from openpano_torch.match import matcher as tmatcher
from openpano_torch.stitch import cylstitcher as tcyl
from openpano_torch.stitch import warp as twarp
from openpano_torch.synth import procedural_scene_large, render_views

SMALL = dict(
    RANSAC_ITERATIONS=400,
    MAX_CAND_PER_OCTAVE=1024, MAX_KP_PER_OCTAVE=512,
    MAX_DESC_PER_OCTAVE=512, MAX_KP_PER_IMAGE=1024,
    MAX_MATCHES_PER_PAIR=512, SIFT_WORKING_SIZE=400,
)
JCFG = JConfig(CYLINDER=True, ESTIMATE_CAMERA=False, ORDERED_INPUT=True,
               **SMALL)


def tcfg(jcfg):
    return config_from_fields(dataclasses.asdict(jcfg))


def sweep_views(seed=2):
    views, _ = render_views(procedural_scene_large(600, 2400, seed=seed), 6,
                            out_w=320, out_h=240, hfov_deg=32, overlap=0.5)
    return views


def boundary(mask):
    """Pixels with a 4-neighbour of the other state."""
    p = np.pad(mask, 1, mode="edge")
    return ((p[1:-1, :-2] != mask) | (p[1:-1, 2:] != mask)
            | (p[:-2, 1:-1] != mask) | (p[2:, 1:-1] != mask))


def canvas_stats(a, b):
    va, vb = a[..., 0] >= 0, b[..., 0] >= 0
    m = va & vb
    x, y = a[m] - a[m].mean(), b[m] - b[m].mean()
    ncc = (x * y).sum() / np.sqrt((x * x).sum() * (y * y).sum())
    return float((va == vb).mean()), float(ncc), va


@pytest.mark.parametrize("w,h,hf,fl", [(320, 240, 1.0, 37.0),
                                       (320, 240, 1.25, 37.0),
                                       (1300, 867, 1.0, 49.45),
                                       (321, 239, 0.8, 20.0)])
def test_projector_fields_equal(w, h, hf, fl):
    jc = JConfig(FOCAL_LENGTH=fl)
    assert tuple(twarp.make_projector(w, h, hf, tcfg(jc))) \
        == tuple(jwarp.make_projector(w, h, hf, jc))


@pytest.mark.parametrize("w,h,hf", [(320, 240, 1.0), (320, 240, 1.2),
                                    (321, 239, 0.8)])
def test_warp_keypoints_match(w, h, hf):
    proj = jwarp.make_projector(w, h, hf, JCFG)
    rng = np.random.default_rng(w + h)
    pts = np.stack([rng.uniform(-w / 2, w / 2, 4000),
                    rng.uniform(-h / 2, h / 2, 4000)], -1).astype(np.float32)
    want = np.asarray(jax.jit(lambda p: jwarp.warp_keypoints(proj, p, w, h))(
        jnp.asarray(pts)))
    got = twarp.warp_keypoints(proj, torch.from_numpy(pts), w, h).numpy()
    assert np.abs(got - want).max() <= 1e-4


@pytest.mark.parametrize("w,h,hf", [(320, 240, 1.0), (320, 240, 1.25),
                                    (321, 239, 0.8)])
def test_warp_image_match(w, h, hf):
    proj = jwarp.make_projector(w, h, hf, JCFG)
    img = np.random.default_rng(h).uniform(size=(h, w, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda im: jwarp.warp_image(
        proj, im, proj.out_h + 3, proj.out_w + 5, w, h))(jnp.asarray(img)))
    got = twarp.warp_image(proj, torch.from_numpy(img), proj.out_h + 3,
                           proj.out_w + 5, w, h).numpy()
    assert got.shape == want.shape
    vg, vw = got[..., 0] >= 0, want[..., 0] >= 0
    both = vg & vw
    assert np.abs(got[both] - want[both]).max() <= 1e-4
    differ = vg != vw
    assert differ.sum() < 0.01 * differ.size
    assert not (differ & ~boundary(vw)).any()
    assert vw.mean() > 0.85


def test_warp_images_u8_equals_f32_route():
    """A uint8 stack warps as its f32 /255 copy, image by image."""
    proj = twarp.make_projector(320, 240, 1.1, tcfg(JCFG))
    u8 = np.round(sweep_views()[:2] * 255).astype(np.uint8)
    got = twarp.warp_images(proj, torch.from_numpy(u8), proj.out_h,
                            proj.out_w, 320, 240)
    for k in range(2):
        one = twarp.warp_image(proj, torch.from_numpy(u8[k]).float() / 255.0,
                               proj.out_h, proj.out_w, 320, 240)
        assert torch.equal(got[k], one)


def test_match_adjacent_pairs_equal():
    """The same descriptors (the port's features of the sweep) give the
    same (i, i+1) match lists, n-1 of them."""
    from openpano_torch.stitch.stitcherbase import compute_features

    feats = compute_features(torch.from_numpy(sweep_views()[:4]), tcfg(JCFG))
    want = jmatcher.match_adjacent_pairs(jnp.asarray(feats.desc.numpy()),
                                         jnp.asarray(feats.valid.numpy()),
                                         JCFG)
    got = tmatcher.match_adjacent_pairs(feats.desc, feats.valid, tcfg(JCFG))
    assert got.idx.shape[0] == 3
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    assert (np.asarray(want.count) > 20).all()


def test_perspective_correction_match():
    """A fixed canvas (random colours, an empty band) and a fixed chain of
    translations with a slight drift, so the correction is not the
    identity."""
    n, ww, wh = 4, 96, 64
    homos = np.stack([np.array([[1.0, 0.0, 40.0 * (k - 2)],
                                [0.0, 1.0, 3.0 * (k - 2)],
                                [0.0, 0.0, 1.0]]) for k in range(n)])
    whs = np.repeat([[ww, wh]], n, 0).astype(np.float32)
    plan = jplan_render(homos, whs.astype(np.float64), 2, "flat", 8000)
    rng = np.random.default_rng(5)
    canvas = rng.uniform(size=(plan.out_h, plan.out_w, 3)).astype(np.float32)
    canvas[:4] = -1.0
    want = np.asarray(jcyl.perspective_correction(
        jnp.asarray(canvas), plan, homos, whs, 2))
    got = tcyl.perspective_correction(torch.from_numpy(canvas), plan, homos,
                                      whs, 2).numpy()
    assert got.shape == want.shape == canvas.shape
    vg, vw = got[..., 0] >= 0, want[..., 0] >= 0
    both = vg & vw
    assert np.abs(got[both] - want[both]).max() <= 1e-4
    assert (vg != vw).sum() <= 0.01 * vg.size
    assert not ((vg != vw) & ~boundary(vw)).any()
    assert 0.5 < vw.mean() < 1.0


@pytest.fixture(scope="module", params=["u8", "f32-multiband"])
def both(request):
    """(port, jax) results of ``stitch_cylinder``: (canvas f32, info) each.
    The JAX side's chosen h-factor, trials and homographies are read by
    wrapping its ``make_projector`` (called once per trial, then with the
    chosen factor) and its ``plan_render``."""
    views = sweep_views()
    jcfg = JCFG
    if request.param == "u8":
        views = np.round(views * 255).astype(np.uint8)
    else:
        jcfg = JCFG.replace(MULTIBAND=2)
    key = jax.random.PRNGKey(0)
    factors, homos = [], []
    make_projector, plan_render = jcyl.make_projector, jcyl.plan_render

    def spy_projector(w, h, factor, cfg):
        factors.append(factor)
        return make_projector(w, h, factor, cfg)

    def spy_plan(hs, *args):
        homos.append(hs)
        return plan_render(hs, *args)

    jcyl.make_projector, jcyl.plan_render = spy_projector, spy_plan
    try:
        jcanvas = np.asarray(jcyl.stitch_cylinder(views, jcfg, key))
    finally:
        jcyl.make_projector, jcyl.plan_render = make_projector, plan_render
    jinfo = dict(hfactor=factors[-1], trials=len(factors) - 1,
                 homos=homos[0])
    tinfo = {}
    tcanvas = tcyl.stitch_cylinder(views, tcfg(jcfg),
                                   key_from_numpy(np.asarray(key)),
                                   device="cpu", info_out=tinfo)
    return (tcanvas, tinfo), (jcanvas, jinfo)


def test_same_hfactor_and_trials(both):
    (_, ti), (_, ji) = both
    assert ti["hfactor"] == ji["hfactor"]
    assert ti["trials"] == ji["trials"]
    assert abs(ti["slope"]) < JCFG.SLOPE_PLAIN or ti["trials"] == 4


def test_homographies_match(both):
    (_, ti), (_, ji) = both
    rel = np.abs(ti["homos"] - ji["homos"]).max() / np.abs(ji["homos"]).max()
    assert rel <= 1e-4


def test_same_canvas_shape(both):
    (tc, _), (jc, _) = both
    assert tc.shape == jc.shape
    assert jc.shape[1] == pytest.approx(3.5 * 320, rel=0.2)
    assert 150 <= jc.shape[0] <= 400


def test_valid_masks_agree(both):
    (tc, _), (jc, _) = both
    agree, _, vj = canvas_stats(tc, jc)
    assert agree >= 0.999
    assert vj.mean() > 0.8


def test_canvas_ncc(both):
    (tc, _), (jc, _) = both
    assert canvas_stats(tc, jc)[1] >= 0.999


def test_seed0_extremum_flip_is_the_blur():
    """On seed 0's third view (uint8 route) the port finds one DoG extremum
    more than the JAX package in octave 0.  Its blurred levels differ from
    XLA:CPU's convolution by a few ulps; fed the JAX scale space, the
    port's extrema code finds the JAX keypoints exactly."""
    from openpano_tpu.ops.imgproc import resize as jresize
    from openpano_tpu.sift import extrema as jext
    from openpano_tpu.sift import pyramid as jpyr
    from openpano_tpu.sift.detector import octave_caps
    from openpano_torch.ops.imgproc import resize, working_size
    from openpano_torch.sift import extrema as text
    from openpano_torch.sift import pyramid as tpyr
    from openpano_torch.stitch.stitcherbase import grey_u8

    u8 = np.round(sweep_views(seed=0)[2:3] * 255).astype(np.uint8)
    grey = grey_u8(torch.from_numpy(u8))
    wh, ww = working_size(320, 240, JCFG.SIFT_WORKING_SIZE)
    work = resize(grey, wh, ww)
    jwork = jax.jit(lambda g: jresize(g, wh, ww))(jnp.asarray(grey[0].numpy()))
    np.testing.assert_array_equal(np.asarray(jwork), work[0].numpy())
    joct = jax.jit(lambda g: jpyr.build_scale_space(g, JCFG))(jwork)[0]
    toct = tpyr.build_scale_space(work, tcfg(JCFG))[0]
    gap = np.abs(np.asarray(joct.gauss) - toct.gauss[0].numpy()).max()
    assert 0 < gap <= 2.4e-7
    caps = octave_caps(JCFG, 0)
    jraw = jax.jit(lambda o: jext.detect_extrema(o, JCFG, cap_cand=caps[0],
                                                 cap_kp=caps[1]))(joct)
    on_jax = text.detect_extrema(
        tpyr.Octave(*(torch.from_numpy(np.array(f))[None] for f in joct)),
        tcfg(JCFG), cap_cand=caps[0], cap_kp=caps[1])
    own = text.detect_extrema(toct, tcfg(JCFG), cap_cand=caps[0],
                              cap_kp=caps[1])
    n = int(np.asarray(jraw.valid).sum())
    assert int(on_jax.valid.sum()) == n
    assert int(own.valid.sum()) == n + 1
    for f in ("x", "y", "s"):
        np.testing.assert_array_equal(getattr(on_jax, f)[0, :n].numpy(),
                                      np.asarray(getattr(jraw, f))[:n])
