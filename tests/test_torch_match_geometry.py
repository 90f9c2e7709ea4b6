"""Port parity: matching, DLT, homography gates, RANSAC, render plan, blend.

Same numpy inputs through the JAX package (its CPU path) and the port
(device="cpu").  Tolerances: match indices equal; RANSAC on the same
threefry draws gives equal inlier sets and inlier coordinates, and affines
within a relative error of 1e-6; host-side planning (numpy in both) equal;
the blended canvas within 1e-4.

The two float tolerances are set by rounding, not by the algorithm.  The
refit's solve amplifies rounding: one ulp in a normalization scale moves an
affine by ~1e-6 relative.  The normal equations' products are formed in
XLA:CPU's order on the CPU (``dlt._xla_cpu_rows_product``), so the affines
agree to 8.0e-7 / 7.0e-7 (M = 128 / 16).  XLA:CPU sums the scales' rows in
an order of its own, which no PyTorch reduction follows; taken in its order
too (``_xla_norm_scale``) they agree to 7.0e-7 / 9.2e-8, the rest being the
Cholesky's multiply-adds, which XLA:CPU contracts into one rounding.  The
same contraction in the blend's inverse map moves sample coordinates by
ulps (~1e-5 px), which is ~1e-4 of colour at a hard texture edge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import openpano_tpu  # noqa: F401  (x64 on, as the JAX package runs)
from openpano_tpu.config import Config as JConfig
from openpano_tpu.geometry import dlt as jdlt, homography as jhom
from openpano_tpu.geometry import polygon as jpoly, ransac as jransac
from openpano_tpu.match import matcher as jmatch
from openpano_tpu.stitch import render as jrender, stitcher as jstitcher
from openpano_torch.compat import key_from_numpy
from openpano_torch.config import Config
from openpano_torch.geometry import dlt as tdlt, homography as thom
from openpano_torch.geometry import polygon as tpoly, ransac as transac
from openpano_torch.match import matcher as tmatch
from openpano_torch.ops.imgproc import _fma
from openpano_torch.stitch import render as trender, stitcher as tstitcher
from openpano_torch.synth import procedural_scene_large

CAPS = dict(MAX_MATCHES_PER_PAIR=128, RANSAC_ITERATIONS=300)
JCFG = JConfig(ESTIMATE_CAMERA=False, TRANS=True, ORDERED_INPUT=True, **CAPS)
TCFG = Config(ESTIMATE_CAMERA=False, TRANS=True, ORDERED_INPUT=True, **CAPS)
W, H = 320.0, 240.0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _t(a):
    return torch.from_numpy(np.array(a))


def _features(seed, n=4, K=160, shift=150.0, outliers=0.3):
    """n images whose keypoints follow a drifting translation + slight
    affine; a share of each image's keypoints has no counterpart.
    Returns pos [n,K,2] f32 (half-shifted), desc [n,K,128], valid [n,K]."""
    rng = np.random.default_rng(seed)
    world = rng.uniform([-W / 2, -H / 2], [W / 2 + shift * n, H / 2],
                        (600, 2))
    wdesc = rng.uniform(0, 1, (600, 128)) ** 3
    pos = np.zeros((n, K, 2), np.float32)
    desc = np.zeros((n, K, 128), np.float32)
    valid = np.zeros((n, K), bool)
    for i in range(n):
        A = np.array([[1.0 + 0.01 * i, 0.005], [-0.004, 1.0]])
        p = (world - [shift * i, 0]) @ A.T
        inside = np.nonzero((np.abs(p[:, 0]) < W / 2 - 1)
                            & (np.abs(p[:, 1]) < H / 2 - 1))[0]
        take = inside[: K - 7 * i]
        cnt = len(take)
        d = wdesc[take] + rng.normal(0, 0.01, (cnt, 128)) ** 2
        junk = rng.uniform(size=cnt) < outliers
        d[junk] = rng.uniform(0, 1, (junk.sum(), 128)) ** 3
        pos[i, :cnt] = p[take] + rng.normal(0, 0.3, (cnt, 2))
        desc[i, :cnt] = 512 * np.sqrt(d / d.sum(1, keepdims=True))
        valid[i, :cnt] = True
    return pos, desc, valid


@pytest.fixture(scope="module")
def feats():
    return _features(0)


@pytest.fixture(scope="module")
def ring(feats):
    pos, desc, valid = feats
    jm = jmatch.match_ring_pairs(jnp.asarray(desc), jnp.asarray(valid), JCFG)
    tm = tmatch.match_ring_pairs(_t(desc), _t(valid), TCFG)
    return jm, tm


def test_match_ring_indices_equal(ring):
    jm, tm = ring
    np.testing.assert_array_equal(tm.count.numpy(), np.asarray(jm.count))
    np.testing.assert_array_equal(tm.valid.numpy(), np.asarray(jm.valid))
    np.testing.assert_array_equal(tm.idx.numpy(), np.asarray(jm.idx))
    assert (np.asarray(jm.count)[:-1] >= 20).all()


def test_match_pair_and_all_pairs_equal(feats):
    pos, desc, valid = feats
    jm = jmatch.match_pair(jnp.asarray(desc[1]), jnp.asarray(valid[1]),
                           jnp.asarray(desc[2]), jnp.asarray(valid[2]), JCFG)
    tm = tmatch.match_pair(_t(desc[1]), _t(valid[1]), _t(desc[2]),
                           _t(valid[2]), TCFG)
    np.testing.assert_array_equal(tm.idx[0].numpy(), np.asarray(jm.idx))
    assert int(tm.count[0]) == int(jm.count) > 0
    ja = jmatch.match_all_pairs(jnp.asarray(desc), jnp.asarray(valid), JCFG)
    ta = tmatch.match_all_pairs(_t(desc), _t(valid), TCFG)
    assert tmatch.pair_indices(5) == jmatch.pair_indices(5)
    np.testing.assert_array_equal(ta.idx.numpy(), np.asarray(ja.idx))
    np.testing.assert_array_equal(ta.count.numpy(), np.asarray(ja.count))


def test_ring_chunking_is_invisible(feats, monkeypatch):
    """The 1.5 GiB chunk rule only splits the pair batch."""
    pos, desc, valid = feats
    whole = tmatch.match_ring_pairs(_t(desc), _t(valid), TCFG)
    parts = tmatch._match_index_pairs(_t(desc), _t(valid), [0, 1, 2, 3],
                                      [1, 2, 3, 0], TCFG, chunk=1)
    for a, b in zip(whole, parts):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("affine", [True, False])
def test_normalized_dlt_matches(affine):
    rng = np.random.default_rng(11)
    p2 = rng.uniform(-150, 150, (5, 40, 2)).astype(np.float32)
    Ht = np.array([[1.02, 0.01, 130.0], [-0.02, 0.99, 4.0],
                   [1e-5 * (not affine), 0.0, 1.0]])
    q = np.concatenate([p2, np.ones((5, 40, 1), np.float32)], -1) @ Ht.T
    p1 = (q[..., :2] / q[..., 2:]).astype(np.float32)
    p1 += rng.normal(0, 0.2, p1.shape).astype(np.float32)
    w = (rng.uniform(size=(5, 40)) < 0.7).astype(np.float32)
    jh = jdlt.normalized_transform(jnp.asarray(p1), jnp.asarray(p2),
                                   jnp.asarray(w), affine)
    th = tdlt.normalized_transform(_t(p1), _t(p2), _t(w), affine)
    assert _rel(th, jh) < 1e-6
    A = rng.normal(size=(7, 8, 8))
    A = A @ A.transpose(0, 2, 1) + 8 * np.eye(8)
    b = rng.normal(size=(7, 8))
    x = tdlt._chol_solve_small(_t(A), _t(b)).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(A, b[..., None])[..., 0],
                               rtol=1e-10, atol=1e-12)


def _xla_seq_sum(x):
    acc = x.new_zeros(x.shape[:-1])
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def _xla_row_sum(x):
    """Sum over the last axis in XLA:CPU's order: a row longer than 32 in
    32-wide windows padded evenly on both sides, each summed from its first
    element on, then the window sums the same way; a shorter row, fused
    with the product that feeds it, in 8 lanes by index mod 8, halved
    pairwise."""
    if x.shape[-1] <= 32:
        x = F.pad(x, (0, -x.shape[-1] % 8)).unflatten(-1, (-1, 8))
        x = _xla_seq_sum(x.transpose(-1, -2))
        while x.shape[-1] > 1:
            h = x.shape[-1] // 2
            x = x[..., :h] + x[..., h:]
        return x[..., 0]
    while x.shape[-1] > 32:
        pad = -x.shape[-1] % 32
        x = F.pad(x, (pad // 2, pad - pad // 2)).unflatten(-1, (-1, 32))
        x = _xla_seq_sum(x)
    return _xla_seq_sum(x)


def _xla_sq_sum(p, w):
    """sum(|p|^2 * w) over the points, rounded as the jitted JAX code does
    (|p|^2 contracted into one multiply-add)."""
    return _xla_row_sum(_fma(p[..., 1], p[..., 1], p[..., 0] * p[..., 0]) * w)


def _xla_norm_scale(p, w, cnt):
    sqrsum = _xla_sq_sum(p, w) / cnt
    return torch.sqrt(2.0 / torch.clamp(sqrsum, min=1e-12))


@pytest.mark.parametrize("n", [8, 16, 32, 40, 128, 1000])
def test_dlt_sums_round_as_xla_cpu(n):
    """``_xla_row_sum`` is XLA:CPU's order: it equals the jitted scale sum
    bit for bit, at short and windowed lengths.  The port's normal
    equations on the CPU (``dlt._xla_cpu_rows_product``) equal XLA:CPU's
    product bit for bit at the refits' sizes here (up to 2 x 128 rows).
    ``torch.matmul`` does not on every host: its BLAS rounds differently on
    AVX2 and AVX-512 hosts, so the port does not use it on the CPU."""
    rng = np.random.default_rng(n)
    p = rng.uniform(-3, 3, (500, n, 2)).astype(np.float32)
    w = (rng.uniform(size=(500, n)) < 0.7).astype(np.float32)
    want = jax.jit(lambda p, w: jnp.sum(jnp.sum(p * p, -1) * w, -1))(p, w)
    np.testing.assert_array_equal(_xla_sq_sum(_t(p), _t(w)).numpy(),
                                  np.asarray(want))
    a, b = (rng.normal(size=(64, min(2 * n, 256), 6)).astype(np.float32)
            for _ in range(2))
    want = jax.jit(lambda a, b: jnp.einsum("...ri,...rj->...ij", a, b))(a, b)
    got = tdlt._xla_cpu_rows_product(_t(a), _t(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nparam", [6, 8])
@pytest.mark.parametrize("R", [6, 8, 512, 1024, 2048])
def test_normal_equations_round_as_xla_cpu(R, nparam):
    """The normal equations of ``_weighted_lstsq`` as the JAX package forms
    them under jit, bit for bit: the hypotheses' rows (6, 8) and the refits
    of MAX_MATCHES_PER_PAIR = 256, 512 and 1024 (XLA:CPU sums these in
    blocks of 256 rows)."""
    rng = np.random.default_rng(R + nparam)
    A = rng.normal(size=(5, R, nparam)).astype(np.float32)
    w = (rng.uniform(size=(5, R)) < 0.6).astype(np.float32)
    b = rng.normal(size=(5, R)).astype(np.float32)
    want = jax.jit(lambda A, w, b: (
        jnp.einsum("...ri,...rj->...ij", A * w[..., None], A),
        jnp.einsum("...ri,...r->...i", A * w[..., None], b)))(A, w, b)
    got = tdlt._normal_equations(_t(A) * _t(w)[..., None], _t(A), _t(b))
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_perspective_dlt_f64_keeps_f64(seed):
    """CYLINDER's perspective correction fits the raw, unnormalised DLT to
    four canvas corners in f64 on the host, as the JAX package does with
    x64 on.  The port's f64 fit stays within f64 rounding of JAX's (5.4e-13
    relative at most over 20 such rectangles); f32-rounded normal
    equations would part by 1.2e-6 to 1.9e-4."""
    rng = np.random.default_rng(seed)
    errs = []
    for _ in range(8):
        w, h = rng.integers(2000, 8000), rng.integers(500, 3000)
        std = np.array([[0, 0], [0, h], [w, 0], [w, h]], np.float64)
        c = std + rng.uniform(-60, 60, (4, 2))
        want = np.asarray(jdlt.perspective_dlt(
            jnp.asarray(c), jnp.asarray(std), jnp.ones(4)))
        got = tdlt.perspective_dlt(torch.from_numpy(c), torch.from_numpy(std),
                                   torch.ones(4, dtype=torch.float64))
        assert got.dtype == torch.float64
        errs.append(np.abs(got.numpy() - want).max() / np.abs(want).max())
    assert max(errs) < 1e-11


def test_homography_gates_match():
    rng = np.random.default_rng(3)
    Hs = np.eye(3)[None] + rng.normal(0, 0.05, (64, 3, 3))
    Hs[:, 2, :2] *= 0.05
    Hs[:, 0, 2] = rng.uniform(-200, 200, 64)
    Hs = Hs.astype(np.float32)
    wh1 = np.array([W, H], np.float32)
    pts = rng.uniform(-200, 200, (64, 50, 2)).astype(np.float32)
    np.testing.assert_array_equal(thom.health(_t(Hs)).numpy(),
                                  np.asarray(jhom.health(jnp.asarray(Hs))))
    ti, tok = thom.homo_inverse(_t(Hs))
    ji, jok = jhom.homo_inverse(jnp.asarray(Hs))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert _rel(ti, ji) < 1e-6
    assert _rel(thom.det3(_t(Hs)), jhom.det3(jnp.asarray(Hs))) < 1e-6
    tm = thom.overlap_mask_in1(_t(Hs), ti, _t(wh1), _t(wh1), _t(pts))
    jm = jhom.overlap_mask_in1(jnp.asarray(Hs), ji, jnp.asarray(wh1),
                               jnp.asarray(wh1), jnp.asarray(pts))
    assert (tm.numpy() != np.asarray(jm)).mean() < 1e-3
    whb = np.broadcast_to(wh1, (64, 2))
    ta = thom.overlap_area_fraction(_t(Hs), _t(whb), _t(whb), 64)
    ja = jhom.overlap_area_fraction(jnp.asarray(Hs), jnp.asarray(whb),
                                    jnp.asarray(whb), 64)
    assert np.abs(ta.numpy() - np.asarray(ja)).max() <= 2.0 / 64 ** 2


def _ransac_both(feats, M):
    """The JAX package's and the port's RANSAC on the same draws."""
    pos, desc, valid = feats
    jcfg, tcfg = (c.replace(MAX_MATCHES_PER_PAIR=M) for c in (JCFG, TCFG))
    jm = jmatch.match_ring_pairs(jnp.asarray(desc), jnp.asarray(valid), jcfg)
    tm = tmatch.match_ring_pairs(_t(desc), _t(valid), tcfg)
    n = pos.shape[0]
    ii, jj = list(range(n)), [(i + 1) % n for i in range(n)]
    whs = np.array([[W, H]] * n, np.float32)
    jkey = jax.random.PRNGKey(3)
    jkeys = jax.random.split(jkey, n)
    ji = jransac.estimate_transform_batch(
        jm, jnp.asarray(pos), jnp.asarray(valid), jnp.asarray(whs),
        jnp.asarray(ii), jnp.asarray(jj), jkey, jcfg, True, keys=jkeys)
    ti = transac.estimate_transform_batch(
        tm, _t(pos), _t(valid), _t(whs), ii, jj,
        key_from_numpy(np.asarray(jkey)), tcfg, True)
    return jm, ji, ti


@pytest.mark.parametrize("M", [128, 16])
def test_ransac_same_draws_same_affines(feats, M):
    """M=16 leaves more matches than the buffer holds: the count is not
    clipped, so draws past the buffer clamp to its last row, as the JAX
    package's gather does."""
    jm, ji, ti = _ransac_both(feats, M)
    ok = np.asarray(ji.confidence) > 0
    assert ok[:-1].all()
    assert (np.asarray(jm.count)[:-1] > M).any() == (M == 16)
    np.testing.assert_array_equal(ti.valid.numpy(), np.asarray(ji.valid))
    np.testing.assert_array_equal(ti.count.numpy(), np.asarray(ji.count))
    assert _rel(ti.homo.numpy()[ok], np.asarray(ji.homo)[ok]) < 1e-6
    assert _rel(ti.confidence, ji.confidence) < 1e-6
    assert _rel(ti.to_pos, ji.to_pos) == 0.0
    assert _rel(ti.from_pos, ji.from_pos) == 0.0


@pytest.mark.parametrize("M", [128, 16])
def test_ransac_refit_gap_is_the_scale_sums(feats, M, monkeypatch):
    """What is left of the refits' gap: with the normalization scales summed
    in XLA:CPU's order as well, the port's affines (8.0e-7 and 7.0e-7
    relative from the JAX package's as they are) agree to 7.0e-7 and
    9.2e-8; the rest is the Cholesky's contracted multiply-adds."""
    monkeypatch.setattr(tdlt, "_norm_scale", _xla_norm_scale)
    _, ji, ti = _ransac_both(feats, M)
    ok = np.asarray(ji.confidence) > 0
    np.testing.assert_array_equal(ti.valid.numpy(), np.asarray(ji.valid))
    assert _rel(ti.homo.numpy()[ok], np.asarray(ji.homo)[ok]) < 1e-6


@pytest.mark.parametrize("affine", [False, True])
def test_ransac_cpu_takes_the_plain_chain(feats, affine):
    """CPU tensors launch no kernel: the batch and the single-call entry
    points give what estimate_transform_plain gives, bit for bit."""
    from openpano_torch.utils import prng

    pos, desc, valid = (_t(a) for a in feats)
    tm = tmatch.match_ring_pairs(desc, valid, TCFG)
    n = pos.shape[0]
    ii, jj = list(range(n)), [(i + 1) % n for i in range(n)]
    whs = _t(np.array([[W, H]] * n, np.float32))
    keys = prng.split(prng.key((0, 3)), n)
    before = transac.estimate_transform.launches
    batch = transac.estimate_transform_batch(tm, pos, valid, whs, ii, jj,
                                             None, TCFG, affine, keys=keys)
    args = (tm, pos[ii], valid[ii], pos[jj], valid[jj], whs[ii], whs[jj],
            keys, TCFG, affine)
    one = transac.estimate_transform(*args)
    want = transac.estimate_transform_plain(*args)
    assert transac.estimate_transform.launches == before
    assert (want.count > 0).sum() >= n - 1
    for f in transac.MatchInfo._fields:
        assert torch.equal(getattr(batch, f), getattr(want, f)), f
        assert torch.equal(getattr(one, f), getattr(want, f)), f


def test_convex_hull_matches():
    rng = np.random.default_rng(9)
    for n in (1, 2, 3, 50, 400):
        p = rng.normal(size=(n, 2))
        np.testing.assert_array_equal(tpoly.convex_hull(p),
                                      jpoly.convex_hull(p))


def _chain(n, step=150.0):
    homos = np.stack([np.array([[1.0, 0.0, step * (k - n // 2)],
                                [0.0, 1.0, 3.0 * (k % 2)],
                                [0.0, 0.0, 1.0]]) for k in range(n)])
    return homos / (0.5 * (W + H))


def _ring(n, step, f=0.5 * (W + H)):
    """n views of a camera turning about y by ``step`` radians, focal f."""
    out = []
    for k in range(n):
        th = step * (k - n // 2)
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                      [-np.sin(th), 0, np.cos(th)]])
        out.append(R.T @ np.linalg.inv(np.diag([f, f, 1.0])))
    return np.stack(out)


def _homos(proj, n, step):
    """The flat chain, or for a projection of angles the turning ring."""
    return _chain(n) if proj == "flat" else _ring(n, step)


@pytest.mark.parametrize("n", [3, 9])
def test_render_plan_and_jobs_match(n):
    homos, whs = _chain(n), np.array([[W, H]] * n)
    tp = trender.plan_render(homos, whs, n // 2, "flat", 8000)
    jp = jrender.plan_render(homos, whs, n // 2, "flat", 8000)
    for f in tp._fields:
        a, b = getattr(tp, f), getattr(jp, f)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    tj = trender._tile_jobs(tp, 4)
    jj = jrender._tile_jobs(jp, 4, item_slabs=True)
    assert tj[:6] == jj[:6]
    for tb, jb in zip(tj[6], jj[6]):
        for x, y in zip(tb, jb):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("proj", ["flat", "spherical", "cylindrical"])
@pytest.mark.parametrize("exact", [False, True])
def test_item_slab_jobs_cover_their_items(proj, exact):
    """One job per render item (the ring wraps past 360 degrees, so some
    views split into two items), its slab covering the item's box clipped
    to the canvas, and a band-g job within columns [g*SW, (g+2)*SW)."""
    n = 9
    homos, whs = _homos(proj, n, 0.75), np.array([[W, H]] * n)
    plan = trender.plan_render(homos, whs, n // 2, proj, 8000)
    if proj != "flat":
        assert len(plan.items) > n
    G, SW, Hp, Wp, TH, TW, bands = trender._tile_jobs(plan, 4, exact=exact)
    assert G == 4 if exact else 1 < G <= 4
    assert SW >= TW and Wp == G * SW
    seen = np.concatenate([b[3] for b in bands])
    np.testing.assert_array_equal(np.sort(seen), np.arange(len(plan.items)))
    for g, (img, bbox, org, item) in enumerate(bands):
        np.testing.assert_array_equal(img, plan.items[item, 0])
        np.testing.assert_array_equal(bbox, plan.items[item, 1:5])
        ox, oy = org[:, 0], org[:, 1]
        x0, y0, x1, y1 = plan.items[item, 1:5].T
        assert (ox <= np.maximum(x0, 0)).all()
        assert (oy <= np.maximum(y0, 0)).all()
        assert (ox + TW >= np.minimum(x1, plan.out_w)).all()
        assert (oy + TH >= np.minimum(y1, plan.out_h)).all()
        assert (ox >= g * SW).all() and (ox + TW <= (g + 2) * SW).all()
        assert (oy + TH <= Hp).all()


@pytest.mark.parametrize("proj", ["flat", "spherical", "cylindrical"])
@pytest.mark.parametrize("ordered", [True, False])
def test_blend_linear_matches(proj, ordered):
    n = 5
    imgs = np.stack([procedural_scene_large(int(H), int(W), seed=s)
                     for s in range(n)])
    homos = _homos(proj, n, 0.4)
    homos[:, 0, 1] = 0.002                     # a slight shear resamples
    whs = np.array([[W, H]] * n)
    plan = trender.plan_render(homos, whs, n // 2, proj, 500)
    got = trender.blend_linear(_t(imgs), plan, ordered=ordered).numpy()
    want = np.asarray(jrender.blend_linear(jnp.asarray(imgs), plan,
                                           ordered))
    assert got.shape == want.shape == (plan.out_h, plan.out_w, 3)
    np.testing.assert_array_equal(got[..., 0] >= 0, want[..., 0] >= 0)
    assert np.abs(got - want).max() < 1e-4
    tu, tv = trender.f32_to_u8(_t(want))
    ju, jv = jstitcher._f32_to_u8(jnp.asarray(want))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_linear_chain_matches():
    n = 5
    g_t, g_j = tstitcher.PairwiseGraph(n, 4), jstitcher.PairwiseGraph(n, 4)
    rng = np.random.default_rng(4)
    for i in range(n - 1):
        Hp = np.array([[1.0, 0.01 * i, 150.0], [0.0, 1.0, rng.normal()],
                       [0.0, 0.0, 1.0]], np.float32)
        args = (i, i + 1, 0.5, Hp, np.zeros((4, 2)), np.zeros((4, 2)),
                np.ones(4, bool))
        assert g_t.fill_pair(*args) and g_j.fill_pair(*args)
    whs = np.array([[W, H]] * n)
    np.testing.assert_array_equal(
        tstitcher._build_linear_simple(g_t, n, n // 2, whs, TCFG),
        jstitcher._build_linear_simple(g_j, n, n // 2, whs, JCFG))
    # the naive flat mode prescales by the focal estimate instead
    naive = dict(TRANS=False, ORDERED_INPUT=False)
    np.testing.assert_array_equal(
        tstitcher._build_linear_simple(g_t, n, n // 2, whs,
                                       TCFG.replace(**naive)),
        jstitcher._build_linear_simple(g_j, n, n // 2, whs,
                                       JCFG.replace(**naive)))
    g_t.conf[1, 2] = g_t.conf[2, 1] = 0
    with pytest.raises(RuntimeError):
        tstitcher._build_linear_simple(g_t, n, n // 2, whs, TCFG)
