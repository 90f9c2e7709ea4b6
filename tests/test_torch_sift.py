"""Port parity: image ops, scale space, extrema, orientation, descriptors.

Same numpy inputs through the JAX package (its CPU path) and the port
(device="cpu").  Tolerances: resize, blur and the pyramid to a max relative
error below 1e-5 (f32 rounding only; gradient orientations as vectors);
keypoint sets equal; histograms and descriptors below 1e-4 (the kernel
gate); compaction indices equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openpano_tpu  # noqa: F401  (x64 on, as the JAX package runs)
from openpano_tpu.config import Config as JConfig
from openpano_tpu.ops import compact as jcompact, gaussian as jgauss
from openpano_tpu.ops import imgproc as jimg
from openpano_tpu.sift import descriptor as jdesc, detector as jdet
from openpano_tpu.sift import extrema as jext, orientation as jori
from openpano_tpu.sift import pyramid as jpyr
from openpano_torch.config import Config
from openpano_torch.ops import compact as tcompact, gaussian as tgauss
from openpano_torch.ops import imgproc as timg
from openpano_torch.sift import descriptor as tdesc, detector as tdet
from openpano_torch.sift import extrema as text, orientation as tori
from openpano_torch.sift import pyramid as tpyr
from openpano_torch.synth import procedural_scene_large

import extrema_cases as ec

CAPS = dict(MAX_CAND_PER_OCTAVE=1024, MAX_KP_PER_OCTAVE=512,
            MAX_DESC_PER_OCTAVE=512, MAX_KP_PER_IMAGE=1024,
            SIFT_WORKING_SIZE=200)
JCFG, TCFG = JConfig(**CAPS), Config(**CAPS)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _angle_rel(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, 2 * np.pi - d).max() / (2 * np.pi)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def grey():
    img = procedural_scene_large(150, 200, seed=3)
    return (img.sum(-1) / 3.0).astype(np.float32)


@pytest.mark.parametrize("shape,out", [((37, 53), (60, 41)),
                                       ((150, 200), (64, 90)),
                                       ((9, 9), (9, 9))])
def test_resize_matches_gather_form(shape, out):
    rng = np.random.default_rng(sum(shape))
    g = rng.uniform(size=shape).astype(np.float32)
    rgb = rng.uniform(size=shape + (3,)).astype(np.float32)
    assert _rel(timg.resize(_t(g), *out),
                jimg._resize_gather(jnp.asarray(g), *out)) < 1e-5
    assert _rel(timg.resize(_t(rgb), *out, rgb=True),
                jimg._resize_gather(jnp.asarray(rgb), *out)) < 1e-5
    # batched planes resize one by one
    gb = np.stack([g, g[::-1]])
    got = timg.resize(_t(gb), *out).numpy()
    assert _rel(got[1], jimg._resize_gather(jnp.asarray(gb[1]), *out)) < 1e-5


def _tie_lerps(w: int, out_w: int):
    """A [2, w] image resized to [2, out_w] (one pixel pair per output
    column) whose horizontal lerps (1-fx)*p00 + fx*p01 fall within 2^-29
    of an f32 half ulp: a dark p00 beside a bright p01.  Row 0 sits just
    below the half ulp with fx*p01 of odd last bit, row 1 just above with
    it even, so that a sum rounded once to f64 and again to f32 ties the
    wrong way.  Returns the image and the crafted (row, column, t, p00, c)."""
    rng = np.random.default_rng(0)
    img = rng.random((2, w)).astype(np.float32)
    scale = np.float32(w / out_w)
    cases = []
    for j in range(out_w):
        # (j + 0.5) * s - 0.5 is exact in f64, so one cast rounds it
        rx = np.float32((j + 0.5) * np.float64(scale) - 0.5)
        sx = int(np.floor(rx))
        fx = np.float32(rx - sx)
        t = np.float32(1) - fx
        if sx < 0 or sx + 1 >= w or fx == 0:
            continue
        num, den = float(t).as_integer_ratio()
        shift = 24 - num.bit_length()
        T = num << shift                       # t = T * 2^-shift / den
        E = int(np.floor(np.log2(fx))) - 1     # fx*p01 in [2^E, 2^(E+1))
        for row, below in ((0, True), (1, False)):
            q, r = divmod(1 << 47, T)
            Q, d = (q, r) if below else (q + 1, T - r)
            if Q >= 1 << 24 or d >= 1 << 17:
                continue                       # t * p00 not near 2^(E-24)
            p00 = np.float32(Q * 2.0 ** (E - 71 + shift + den.bit_length() - 1))
            for _ in range(1000):
                p01 = np.float32(rng.uniform(2.0 ** E / fx,
                                             2.0 ** (E + 1) / fx))
                c = np.float32(fx * p01)
                if (2.0 ** E <= c < 2.0 ** (E + 1)
                        and bool(c.view(np.int32) & 1) == below):
                    break
            else:
                continue
            img[row, sx], img[row, sx + 1] = p00, p01
            cases.append((row, j, t, p00, c))
    return img, cases


def test_resize_rounds_ties_as_one_fused_multiply_add():
    """On lerps crafted to land next to a tie, where rounding the exact sum
    first to f64 and then to f32 differs from one rounding, the resize
    still equals the JAX package's jitted CPU resize (whose multiply-adds
    XLA contracts) bit for bit."""
    img, cases = _tie_lerps(1157, 500)
    want = np.asarray(jax.jit(jimg.resize, static_argnums=(1, 2))(
        jnp.asarray(img), 2, 500))
    twice = [np.float32(float(t) * float(p00) + float(c))
             for _, _, t, p00, c in cases]
    ties = [want[r, j] != v for (r, j, *_), v in zip(cases, twice)]
    assert len(cases) >= 8 and all(ties)       # every case is a tie case
    np.testing.assert_array_equal(timg.resize(_t(img), 2, 500).numpy(), want)


def test_working_size_and_grey():
    for w, h in ((1300, 867), (320, 240), (97, 1001)):
        assert timg.working_size(w, h, 800) == jimg.working_size(w, h, 800)
    rgb = np.random.default_rng(0).uniform(size=(5, 7, 3)).astype(np.float32)
    assert _rel(timg.rgb2grey(_t(rgb)), jimg.rgb2grey(jnp.asarray(rgb))) < 1e-6


@pytest.mark.parametrize("sigma", [1.4142135623, 2.0, 4.0])
def test_blur_matches(grey, sigma):
    np.testing.assert_array_equal(tgauss.gauss_kernel(sigma, 6),
                                  jgauss.gauss_kernel(sigma, 6))
    want = jgauss.blur(jnp.asarray(grey), sigma, 6)
    assert _rel(tgauss.blur(_t(grey)[None], sigma, 6)[0], want) < 1e-5


def test_pyramid_matches(grey):
    assert tpyr.octave_shapes(150, 200, TCFG) == jpyr.octave_shapes(150, 200,
                                                                    JCFG)
    jo = jpyr.build_scale_space(jnp.asarray(grey), JCFG)
    to = tpyr.build_scale_space(_t(grey)[None], TCFG)
    assert len(jo) == len(to) == TCFG.NUM_OCTAVE
    for j, t in zip(jo, to):
        assert _rel(t.gauss[0], j.gauss) < 1e-5
        assert _rel(t.mag[0], j.mag) < 1e-5
        assert _rel(t.dog[0], j.dog) < 1e-5
        # the orientation as the gradient vector mag * e^(i ort): a flat
        # region's angle is ill-conditioned and weighs nothing downstream
        tv = t.mag[0].numpy() * np.exp(1j * t.ort[0].numpy())
        jv = np.asarray(j.mag) * np.exp(1j * np.asarray(j.ort))
        assert np.abs(tv - jv).max() / np.abs(jv).max() < 1e-5
        # where the gradient is clear the angles themselves agree
        strong = np.asarray(j.mag) > 1e-2 * np.asarray(j.mag).max()
        assert _angle_rel(t.ort[0].numpy()[strong],
                          np.asarray(j.ort)[strong]) < 1e-5


def test_sample_bilinear_matches():
    rng = np.random.default_rng(5)
    img = rng.uniform(size=(20, 30, 3)).astype(np.float32)
    img[3, 4] = -1.0                                  # an INVALID pixel
    y = rng.uniform(-2, 22, (40, 50)).astype(np.float32)
    x = rng.uniform(-2, 32, (40, 50)).astype(np.float32)
    tc, tv = timg.sample_bilinear(_t(img), _t(y), _t(x))
    jc, jv = jimg.sample_bilinear(jnp.asarray(img), jnp.asarray(y),
                                  jnp.asarray(x))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert _rel(tc, jc) < 1e-6


@pytest.mark.parametrize("density", [0.002, 0.05, 0.6])
def test_compaction_matches(density):
    rng = np.random.default_rng(int(density * 1000))
    mask = rng.uniform(size=5000) < density
    for size in (16, 256, 4096):
        ti, tc = tcompact.compact_indices(_t(mask)[None], size)
        ji, jc = jcompact.compact_indices(jnp.asarray(mask), size)
        np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))
        assert int(tc[0]) == int(jc)              # not clipped
        ti, tc = tcompact.compact_indices_capped(_t(mask)[None], size)
        ji, jc = jcompact.compact_indices_capped(jnp.asarray(mask), size)
        np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))
        assert int(tc[0]) == int(jc) <= size      # clipped


@pytest.fixture(scope="module")
def jax_octaves(grey):
    return jpyr.build_scale_space(jnp.asarray(grey), JCFG)


def _torch_octave(o):
    return tpyr.Octave(*(_t(a)[None] for a in o))


@pytest.mark.parametrize("octave", [0, 1, 2])
def test_extrema_keypoint_sets_equal(jax_octaves, octave):
    """Same DoG stack in, same refined keypoints out."""
    caps = jdet.octave_caps(JCFG, octave)
    assert caps == tdet.octave_caps(TCFG, octave)
    jk = jext.detect_extrema(jax_octaves[octave], JCFG, caps[0], caps[1])
    tk = text.detect_extrema(_torch_octave(jax_octaves[octave]), TCFG,
                             caps[0], caps[1])
    v = np.asarray(jk.valid)
    assert v.sum() > 10
    np.testing.assert_array_equal(tk.valid[0].numpy(), v)
    for f in ("x", "y", "s"):
        np.testing.assert_array_equal(getattr(tk, f)[0].numpy()[v],
                                      np.asarray(getattr(jk, f))[v])
    for f in ("scale_factor", "real_x", "real_y"):
        assert _rel(getattr(tk, f)[0].numpy()[v],
                    np.asarray(getattr(jk, f))[v]) < 1e-6


def test_extrema_cpu_takes_the_plain_route(jax_octaves):
    """A CPU tensor takes ``detect_extrema_plain``: the same seven fields in
    every slot, and no kernel launch counted."""
    assert text.detect_extrema.launches == 0
    o = _torch_octave(jax_octaves[0])
    got = text.detect_extrema(o, TCFG, 1024, 512)
    want = text.detect_extrema_plain(o, TCFG, 1024, 512)
    for f in text.RawKeypoints._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert text.detect_extrema.launches == 0


def test_extrema_raise_on_a_device_without_kernels():
    dog = torch.zeros(1, TCFG.NUM_SCALE - 1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="no extrema kernel"):
        text.detect_extrema(tpyr.Octave(None, None, None, dog), TCFG)


def _crafted_keypoints(cap_cand, cap_kp):
    k = text.detect_extrema(ec.octave(ec.crafted()), ec.CFG, cap_cand, cap_kp)
    v = k.valid[0]
    pts = list(zip(k.s[0][v].tolist(), k.y[0][v].tolist(),
                   k.x[0][v].tolist()))
    return k, pts


D = ec.DENSE_X


@pytest.mark.parametrize("caps,dense,plants", [
    # 47 peaks in one 128-lane block (x 0..95 of the row): its first 32 kept
    ((4096, 128), D[:32] + D[47:], {"converge", "edge_in"}),
    # 40 candidates: the three level-1 plants, then the row's first 37
    ((40, 128), D[:32] + D[47:52], {"edge_in"}),
    # 16 keypoint slots: the first 16 survivors in scan order
    ((4096, 16), D[:15], {"edge_in"}),
])
def test_extrema_crafted_caps(caps, dense, plants):
    """The crafted volume (``tests/extrema_cases.py``) under the caps: the
    per-block cap of 32, the candidate cap and the keypoint cap keep the
    first extrema in scan order; past the survivors each slot holds slot
    0's candidate (the level-1 edge plant, refined but an edge) and is
    invalid; the empty image's slots all hold the dead slot 0."""
    k, pts = _crafted_keypoints(*caps)
    assert [x for s, y, x in pts if y == ec.DENSE_Y] == dense
    kept = {n for n, (s, y, x, *_) in ec.PLANTS.items() if (s, y, x) in pts}
    assert kept == plants
    n = len(pts)
    assert n == len(dense) + len(plants) and k.valid[0, :n].all()
    s0, y0, x0 = ec.PLANTS["edge_at"][:3]
    for f, want in (("s", s0), ("y", y0), ("x", x0)):
        assert (getattr(k, f)[0, n:] == want).all()
    assert not k.valid[1].any()
    assert (k.x[1] == 1).all() and (k.y[1] == 1).all() and (k.s[1] == 1).all()
    for f in ("scale_factor", "real_x", "real_y"):
        pad = getattr(k, f)
        assert (pad[0, n:] == pad[0, -1]).all() and (pad[1] == pad[1, 0]).all()


@pytest.mark.parametrize("name,kept", [
    ("converge", True), ("step_out", False), ("singular", False),
    ("half", False), ("edge_at", False), ("edge_in", True),
    ("edge_out", False)])
def test_extrema_crafted_branches(name, kept):
    """Each plant takes its branch: a Newton step out of the interior, a
    singular Hessian and an offset of exactly 0.5 (which rounds half to
    even to no step, so it never converges) fail; tr^2 / det on the edge
    limit 49 / 6 is an edge, just inside it is not."""
    s, y, x = ec.PLANTS[name][:3]
    assert ((s, y, x) in _crafted_keypoints(4096, 128)[1]) == kept


def test_orientation_and_descriptor_sets_equal(jax_octaves):
    """One octave's raw keypoints through orientation assignment (K1) and
    the descriptor (K2) on the same planes."""
    o = jax_octaves[0]
    jk = jext.detect_extrema(o, JCFG, 1024, 512)
    cap = 512
    jo, _ = jori.orient_keypoints(jk, o.mag, o.ort, JCFG, cap)
    tkp = text.RawKeypoints(*(_t(a)[None] for a in jk))
    to, _ = tori.orient_keypoints(tkp, _t(o.mag)[None], _t(o.ort)[None],
                                  TCFG, cap)
    v = np.asarray(jo.valid)
    assert v.sum() > 10
    np.testing.assert_array_equal(to.valid[0].numpy(), v)
    for f in ("x", "y", "s"):
        np.testing.assert_array_equal(getattr(to, f)[0].numpy()[v],
                                      np.asarray(getattr(jo, f))[v])
    assert _angle_rel(to.dir[0].numpy()[v], np.asarray(jo.dir)[v]) < 1e-5

    jd = jdesc.describe_keypoints(jo, o.mag, o.ort, JCFG)
    td = tdesc.describe_keypoints(
        tori.OrientedKeypoints(*(_t(a)[None] for a in jo)),
        _t(o.mag)[None], _t(o.ort)[None], TCFG)
    assert _rel(td[0], jd) < 1e-4


def test_round_half_away():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49, -0.51], np.float32)
    np.testing.assert_array_equal(tori.round_half_away(_t(x)).numpy(),
                                  np.asarray(jori._round_half_away(
                                      jnp.asarray(x))))
    assert tori.ori_window_radius(TCFG) == jori.ori_window_radius(JCFG)
    assert tdesc.desc_window_radius(TCFG) == jdesc.desc_window_radius(JCFG)


def test_detector_features_match():
    """The whole detector on a two-image grey batch: equal keypoint sets,
    equal positions, descriptors within the kernel gate (the RGB route runs
    in the end-to-end test)."""
    imgs = np.stack([procedural_scene_large(120, 160, seed=s)
                     for s in (7, 8)]).mean(-1, dtype=np.float32)
    wh = np.array([[160.0, 120.0]] * 2, np.float32)
    jf = jdet.detect_and_describe_batch(jnp.asarray(imgs), jnp.asarray(wh),
                                        JCFG)
    tf = tdet.detect_and_describe(_t(imgs), _t(wh), TCFG)
    v = np.asarray(jf.valid)
    assert v.sum(1).min() > 20
    np.testing.assert_array_equal(tf.valid.numpy(), v)
    assert _rel(tf.pos.numpy()[v], np.asarray(jf.pos)[v]) < 1e-5
    assert _rel(tf.desc.numpy()[v], np.asarray(jf.desc)[v]) < 1e-4


def test_crop_with_mask_matches():
    """The crop DP through the port's own loader of
    native/crop_largest_rect.c."""
    rng = np.random.default_rng(12)
    img = rng.uniform(size=(40, 60, 3)).astype(np.float32)
    for trial in range(4):
        valid = np.ones((40, 60), bool)
        valid[: rng.integers(0, 8)] = False
        valid[:, rng.integers(50, 61):] = False
        valid[rng.integers(0, 40), rng.integers(0, 60)] = False
        np.testing.assert_array_equal(timg.crop_with_mask(img, valid),
                                      jimg.crop_with_mask(img, valid))
    assert timg.crop_with_mask(img, np.zeros((40, 60), bool)).size == 0
