"""Port parity for the stage artifacts, the numeric guard mode and the host
image helpers, against the JAX package, on the CPU.

- npz features, match graph and cameras written by either package load in
  the other with equal arrays;
- the matchinfo text of one graph is byte-identical between the packages,
  and both loaders give equal arrays (each pair's points packed to a slot
  prefix, in the dumped order);
- ``assert_finite`` raises the JAX package's message on the same arrays
  (numpy or torch), is a no-op when disabled, skips ints and ``None``;
- with ``OPENPANO_CHECK_NUMERICS=1`` a clean 5-camera problem gives the
  cameras and LM iterations of a run with checks off, bit for bit; a NaN in
  one inlier position raises ``NumericsError`` from the LM naming the
  residuals; a NaN homography on a spanning-tree edge of a preloaded graph
  raises at the ``estimate_camera`` stage;
- ``hconcat``, ``vconcat`` and ``crop_to_largest_rect`` equal the JAX ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openpano_tpu  # noqa: F401  (x64 on, as the JAX package runs)
from openpano_tpu.camera.camera import CameraSet as JCameraSet
from openpano_tpu.io import artifacts as jart
from openpano_tpu.ops import imgproc as jimg
from openpano_tpu.sift.descriptor import Features as JFeatures
from openpano_tpu.stitch.stitcher import PairwiseGraph as JGraph
from openpano_tpu.utils import debug as jdebug
from openpano_torch import Config
from openpano_torch.camera.camera import CameraSet
from openpano_torch.camera.estimator import estimate_cameras, \
    traverse_spanning_tree
from openpano_torch.io import artifacts as tart
from openpano_torch.ops import imgproc as timg
from openpano_torch.sift.descriptor import Features
from openpano_torch.stitch.stitcher import PairwiseGraph, stitch
from openpano_torch.synth import gt_pair_homography
from openpano_torch.utils import debug as tdebug

N, W, H, M = 5, 320, 240, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this module: its Python loops issue many
    small ops, and the test workers share the CPU, so more threads would
    only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def synthetic_graph(graph_cls=PairwiseGraph, seed=0):
    """Five cameras of focal 400 yawing 0.3 rad apart over 320x240 views:
    every pair within two steps holds the true homography and up to 24
    noisy correspondences, in every other match slot (so not a prefix)."""
    rng = np.random.default_rng(seed)
    truth = {"focal_px": 400.0, "yaws": (np.arange(N) - N // 2) * 0.3}
    g = graph_cls(N, M)
    for i in range(N):
        for j in range(i + 1, min(i + 3, N)):
            Hij = gt_pair_homography(truth, i, j, W, H)
            pf = np.stack([rng.uniform(-W / 2, W / 2, 48),
                           rng.uniform(-H / 2, H / 2, 48)], -1)
            ph = np.concatenate([pf, np.ones((48, 1))], 1) @ Hij.T
            pt = ph[:, :2] / ph[:, 2:]
            keep = (np.abs(pt[:, 0]) < W / 2) & (np.abs(pt[:, 1]) < H / 2)
            pt, pf = pt[keep][:24], pf[keep][:24]
            pt = pt + rng.normal(scale=0.3, size=pt.shape)
            k = len(pt)
            to_pos = np.zeros((M, 2))
            from_pos = np.zeros((M, 2))
            valid = np.zeros(M, bool)
            slots = np.arange(k) * 2
            to_pos[slots], from_pos[slots], valid[slots] = pt, pf, True
            conf = k / (8 + 0.3 * k)
            Hinv = np.linalg.inv(Hij)
            Hinv /= Hinv[2, 2]
            g.conf[i, j] = g.conf[j, i] = conf
            g.homo[i, j], g.homo[j, i] = Hij, Hinv
            g.to_pos[i, j], g.from_pos[i, j] = to_pos, from_pos
            g.to_pos[j, i], g.from_pos[j, i] = from_pos, to_pos
            g.valid[i, j] = g.valid[j, i] = valid
    return g


WHS = np.repeat([[float(W), float(H)]], N, 0)
CFG = Config()


def graph_arrays(g):
    return [g.conf, g.homo, g.to_pos, g.from_pos, g.valid]


def assert_graphs_equal(a, b):
    for x, y in zip(graph_arrays(a), graph_arrays(b)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(x, y)


# ---- npz stages ----

def test_features_npz_both_ways(tmp_path):
    rng = np.random.default_rng(1)
    pos = rng.normal(size=(2, 8, 2)).astype(np.float32)
    desc = rng.normal(size=(2, 8, 128)).astype(np.float32)
    valid = rng.random((2, 8)) > 0.5
    p = str(tmp_path / "port.npz")
    tart.save_features(p, Features(*map(torch.from_numpy, (pos, desc, valid))))
    got = jart.load_features(p)
    for a, b in zip((got.pos, got.desc, got.valid), (pos, desc, valid)):
        np.testing.assert_array_equal(np.asarray(a), b)
    q = str(tmp_path / "jax.npz")
    jart.save_features(q, JFeatures(*map(jnp.asarray, (pos, desc, valid))))
    back = tart.load_features(q)
    assert back.pos.device.type == "cpu" and back.valid.dtype == torch.bool
    for a, b in zip(back, (pos, desc, valid)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_match_graph_npz_both_ways(tmp_path):
    p, q = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tart.save_match_graph(p, synthetic_graph())
    assert_graphs_equal(jart.load_match_graph(p), synthetic_graph())
    jart.save_match_graph(q, synthetic_graph(JGraph))
    assert_graphs_equal(tart.load_match_graph(q), synthetic_graph())


def test_cameras_npz_both_ways(tmp_path):
    rng = np.random.default_rng(2)
    fields = dict(focal=rng.normal(size=4) + 700, ppx=rng.normal(size=4),
                  ppy=rng.normal(size=4),
                  R=np.linalg.qr(rng.normal(size=(4, 3, 3)))[0])
    p, q = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tart.save_cameras(p, CameraSet(**fields))
    jart.save_cameras(q, JCameraSet(**fields))
    for cams in (jart.load_cameras(p), tart.load_cameras(q)):
        for k, v in fields.items():
            np.testing.assert_array_equal(getattr(cams, k), v)


# ---- the reference-compatible text ----

def test_matchinfo_text_identical(tmp_path):
    p, q = tmp_path / "port.txt", tmp_path / "jax.txt"
    tart.dump_matchinfo_text(str(p), synthetic_graph())
    jart.dump_matchinfo_text(str(q), synthetic_graph(JGraph))
    assert p.read_bytes() == q.read_bytes()
    got = tart.load_matchinfo_text(str(p), N, M)
    assert_graphs_equal(got, jart.load_matchinfo_text(str(q), N, M))
    # every value round-trips; each pair's points now fill a slot prefix
    g = synthetic_graph()
    np.testing.assert_array_equal(got.conf, g.conf)
    np.testing.assert_array_equal(got.homo, g.homo)
    for i in range(N):
        for j in range(N):
            m = g.valid[i, j]
            k = int(m.sum())
            assert got.valid[i, j, :k].all() and not got.valid[i, j, k:].any()
            np.testing.assert_array_equal(got.to_pos[i, j, :k],
                                          g.to_pos[i, j][m])
            np.testing.assert_array_equal(got.from_pos[i, j, :k],
                                          g.from_pos[i, j][m])


# ---- assert_finite ----

def _bad_arrays():
    a = np.ones((3, 4), np.float32)
    a[1, 2] = np.inf
    b = np.zeros((2, 5, 2))
    b[1, 3:, 0] = np.nan
    return {"canvas": a, "to_pos": b, "scalar": np.float64(np.nan)}


@pytest.mark.parametrize("name", list(_bad_arrays()))
@pytest.mark.parametrize("as_tensor", [False, True])
def test_assert_finite_message_matches(monkeypatch, name, as_tensor):
    monkeypatch.setenv("OPENPANO_CHECK_NUMERICS", "1")
    arr = _bad_arrays()[name]
    with pytest.raises(jdebug.NumericsError) as want:
        jdebug.assert_finite("blend", ok=np.ones(3), **{name: arr})
    port_arr = torch.from_numpy(np.asarray(arr)) if as_tensor else arr
    with pytest.raises(tdebug.NumericsError) as got:
        tdebug.assert_finite("blend", ok=np.ones(3), **{name: port_arr})
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, AssertionError)


def test_assert_finite_noop_and_skips(monkeypatch):
    monkeypatch.delenv("OPENPANO_CHECK_NUMERICS", raising=False)
    assert not tdebug.numeric_checks_enabled()
    tdebug.assert_finite("stage", x=np.array([np.nan]),
                         t=torch.tensor([float("inf")]))
    monkeypatch.setenv("OPENPANO_CHECK_NUMERICS", "1")
    assert tdebug.numeric_checks_enabled()
    tdebug.assert_finite("stage", idx=np.array([1, 2, 3]),
                         t=torch.tensor([1, 2]), m=torch.tensor([True]),
                         x=None)


# ---- numeric checks in the camera stage ----

def _estimate(g, stats):
    return estimate_cameras(g.conf, g.homo, g.to_pos, g.from_pos, g.valid,
                            WHS, CFG, stats=stats)


def test_checks_leave_clean_problem_bit_identical(monkeypatch):
    monkeypatch.delenv("OPENPANO_CHECK_NUMERICS", raising=False)
    off_stats = {}
    off = _estimate(synthetic_graph(), off_stats)
    monkeypatch.setenv("OPENPANO_CHECK_NUMERICS", "1")
    on_stats = {}
    on = _estimate(synthetic_graph(), on_stats)
    for k in ("focal", "ppx", "ppy", "R"):
        np.testing.assert_array_equal(getattr(on, k), getattr(off, k))
    assert on_stats["lm_iters"] == off_stats["lm_iters"] > 0
    assert on_stats["ba_rms_px"] == off_stats["ba_rms_px"] < 1.0
    np.testing.assert_allclose(on.focal, 400.0, rtol=0.05)


def test_nan_position_raises_in_lm(monkeypatch):
    monkeypatch.setenv("OPENPANO_CHECK_NUMERICS", "1")
    g = synthetic_graph()
    g.to_pos[1, 2, 4, 0] = np.nan                    # slot 4 is an inlier
    assert g.valid[1, 2, 4]
    with pytest.raises(tdebug.NumericsError,
                       match=r"\[ba_lm\[\d+\] iteration 0\] 'residuals'"):
        _estimate(g, {})


def test_nan_homography_in_preloaded_graph(monkeypatch):
    """A loaded graph skips the match stage and its guard; the tree edge's
    homography is checked where it initialises a camera."""
    monkeypatch.setenv("OPENPANO_CHECK_NUMERICS", "1")
    g = synthetic_graph()
    _, edges = traverse_spanning_tree(g.conf)
    now, nxt = edges[1]
    g.homo[now, nxt, 0, 1] = np.nan
    views = np.zeros((N, H, W, 3), np.uint8)
    with pytest.raises(tdebug.NumericsError,
                       match=rf"\[estimate_camera\] 'homos\[{now}, {nxt}\]' "
                             r"has 1 non-finite values \(first at index "
                             r"\(0, 1\)"):
        stitch(views, CFG, device="cpu", graph=g)


# ---- host image helpers ----

def test_concat_and_crop_match():
    rng = np.random.default_rng(3)
    mats = [rng.uniform(size=(h, w, 3)).astype(np.float32)
            for h, w in ((20, 30), (35, 12), (7, 41))]
    for t, j in ((timg.hconcat, jimg.hconcat), (timg.vconcat, jimg.vconcat)):
        np.testing.assert_array_equal(t(mats), j(mats))
    img = rng.uniform(size=(40, 60, 3)).astype(np.float32)
    img[:5] = -1.0
    img[:, 50:] = -1.0
    img[30, 10] = -1.0
    got = timg.crop_to_largest_rect(img)
    np.testing.assert_array_equal(got, jimg.crop_to_largest_rect(img))
    assert got.shape[:2] == (35, 39) and (got >= 0).all()
