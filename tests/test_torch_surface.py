"""The port's public surface against the JAX package's, on the CPU.

Every name in each ``openpano_tpu`` subpackage's ``__all__`` imports from
the matching ``openpano_torch`` subpackage, and the port's ``__all__`` lists
the same names.  The small public helpers agree with the JAX package's:
``translation``, ``polygon_area``, ``points_in_polygon``,
``reverse_matchinfo``, ``slab_offsets`` (K3's slab layout), the synth
generators (``serpentine_rotations``, ``render_views_sphere``,
``gt_rot_pair_homography``), and ``photo_scene``, which reads a photo given
by path the same way, reads the same default photo without one, and fails
the same way when that photo is absent.  ``assign_orientation``, ``compute_descriptors`` and
``detect_and_describe_batch`` equal the port's own stage functions they
name (which ``tests/test_torch_sift.py`` holds to the JAX package).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openpano_tpu  # noqa: F401  (x64 on, as the JAX package runs)
from openpano_tpu import synth as jsynth
from openpano_tpu.geometry import homography as jhomo
from openpano_tpu.geometry import polygon as jpoly
from openpano_tpu.geometry import ransac as jransac
from openpano_tpu.sift import orientation as jori
from openpano_torch import Config
from openpano_torch import synth as tsynth
from openpano_torch.geometry import homography as thomo
from openpano_torch.geometry import polygon as tpoly
from openpano_torch.geometry import ransac as transac
from openpano_torch.io.image import write_rgb
from openpano_torch.sift import descriptor as tdesc
from openpano_torch.sift import detector as tdet
from openpano_torch.sift import orientation as tori
from openpano_torch.sift.extrema import detect_extrema
from openpano_torch.sift.pyramid import build_scale_space

SUBPACKAGES = ("camera", "geometry", "io", "match", "ops", "sift", "stitch",
               "utils")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this module (the test workers share
    the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_public_name_is_in_the_port(sub):
    jax_mod = importlib.import_module(f"openpano_tpu.{sub}")
    port = importlib.import_module(f"openpano_torch.{sub}")
    assert list(port.__all__) == list(jax_mod.__all__)
    missing = [n for n in jax_mod.__all__ if not hasattr(port, n)]
    assert not missing
    for n in jax_mod.__all__:
        assert callable(getattr(port, n)) == callable(getattr(jax_mod, n)) \
            or n in ("INVALID", "PROJECTIONS")


def test_translation_equals_jax():
    np.testing.assert_array_equal(thomo.translation(3.5, -2.0).numpy(),
                                  np.asarray(jhomo.translation(3.5, -2.0)))
    H = thomo.translation(1.0, 2.0, dtype=torch.float64)
    assert H.dtype == torch.float64


def test_polygon_helpers_equal_jax():
    rng = np.random.default_rng(0)
    square = np.array([[0, 0], [4, 0], [4, 3], [0, 3]], np.float64)
    tri = rng.uniform(-5, 5, (3, 2))
    concave = np.array([[0, 0], [6, 0], [6, 6], [3, 2], [0, 6]], np.float64)
    pts = np.concatenate([rng.uniform(-6, 8, (200, 2)),
                          [[2, 0], [4, 1.5], [0, 0], [3, 2]]])
    for poly in (square, tri, concave, square[:2]):
        assert tpoly.polygon_area(poly) == jpoly.polygon_area(poly)
        np.testing.assert_array_equal(tpoly.points_in_polygon(pts, poly),
                                      jpoly.points_in_polygon(pts, poly))
    assert tpoly.polygon_area(square) == 12.0
    assert tpoly.points_in_polygon(np.array([[2.0, 0.0]]), square)[0]


def test_reverse_matchinfo_equals_jax():
    rng = np.random.default_rng(1)
    H = np.eye(3) + rng.normal(size=(2, 3, 3)) * 0.05
    fields = dict(homo=H, confidence=rng.uniform(size=2),
                  to_pos=rng.normal(size=(2, 5, 2)),
                  from_pos=rng.normal(size=(2, 5, 2)),
                  valid=rng.uniform(size=(2, 5)) < 0.5,
                  count=np.array([3, 4]))
    t = transac.reverse_matchinfo(transac.MatchInfo(
        **{k: torch.from_numpy(np.asarray(v)) for k, v in fields.items()}))
    j = jransac.reverse_matchinfo(jransac.MatchInfo(
        **{k: jnp.asarray(v) for k, v in fields.items()}))
    for name in transac.MatchInfo._fields:
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=1e-12,
                                   err_msg=name)
    np.testing.assert_allclose(t.homo.numpy() @ H, np.broadcast_to(
        np.eye(3), (2, 3, 3)), atol=1e-12)


@pytest.mark.parametrize("H,W,WR", [(60, 90, 24), (300, 500, 56)])
def test_slab_offsets_equal_jax(H, W, WR):
    rng = np.random.default_rng(H)
    y = rng.integers(0, H, 40).astype(np.int32)
    x = rng.integers(0, W, 40).astype(np.int32)
    dy, dx = tori.slab_offsets(torch.from_numpy(y), torch.from_numpy(x), H, W,
                               WR)
    jy, jx = jori.slab_offsets(jnp.asarray(y), jnp.asarray(x), H, W, WR)
    assert dy.shape == (40, WR, 1) and dx.shape == (40, 1, 256)
    np.testing.assert_array_equal(dy.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(jx))


def test_synth_helpers_equal_jax():
    R, order = tsynth.serpentine_rotations(3, 2, 0.3, 0.2)
    Rj, order_j = jsynth.serpentine_rotations(3, 2, 0.3, 0.2)
    np.testing.assert_array_equal(R, Rj)
    assert order == order_j
    scene = tsynth.procedural_scene_large(60, 240, seed=3)
    for dtype in (np.uint8, np.float32):
        np.testing.assert_array_equal(
            tsynth.render_views_sphere(scene, R, 40, 30, 35.0, dtype),
            jsynth.render_views_sphere(scene, R, 40, 30, 35.0, dtype))
    np.testing.assert_array_equal(
        tsynth.gt_rot_pair_homography(35.0, R[0], R[1]),
        jsynth.gt_rot_pair_homography(35.0, R[0], R[1]))


def test_photo_scene_reads_and_fails_as_jax(tmp_path, monkeypatch):
    img = (np.random.default_rng(2).uniform(size=(12, 16, 3)) * 255).astype(
        np.uint8)
    path = str(tmp_path / "scene.png")
    write_rgb(path, img)
    np.testing.assert_array_equal(tsynth.photo_scene(path),
                                  jsynth.photo_scene(path))
    # without a path both read the same default photo
    import openpano_torch.io.image as timage
    import openpano_tpu.io as jio

    read = []
    for mod in (timage, jio):
        monkeypatch.setattr(mod, "read_img", lambda p: read.append(p) or img)
    tsynth.photo_scene()
    jsynth.photo_scene()
    assert read[0] == tsynth.DEFAULT_PHOTO == read[1]
    monkeypatch.undo()
    missing = str(tmp_path / "absent" / "CMU0-all.jpg")
    monkeypatch.setattr(tsynth, "DEFAULT_PHOTO", missing)
    with pytest.raises(FileNotFoundError):
        tsynth.photo_scene()
    with pytest.raises(FileNotFoundError):
        jsynth.photo_scene(missing)


def test_sift_stage_helpers_equal_the_port_stages():
    cfg = Config(MAX_CAND_PER_OCTAVE=256, MAX_KP_PER_OCTAVE=128,
                 MAX_DESC_PER_OCTAVE=128, MAX_KP_PER_IMAGE=256)
    scene = tsynth.procedural_scene(96, 128, seed=4)
    grey = torch.from_numpy(scene.mean(-1, dtype=np.float32))[None]
    octave = build_scale_space(grey, cfg)[0]
    raw = detect_extrema(octave, cfg, cap_cand=256, cap_kp=128)
    ori = tori.assign_orientation(raw, octave, cfg)
    want, _ = tori.orient_keypoints(raw, octave.mag, octave.ort, cfg,
                                    cfg.MAX_DESC_PER_OCTAVE)
    assert int(ori.valid.sum()) > 0
    for a, b in zip(ori, want):
        assert torch.equal(a, b)
    desc = tdesc.compute_descriptors(ori, octave, cfg)
    assert torch.equal(desc, tdesc.describe_keypoints(ori, octave.mag,
                                                      octave.ort, cfg))
    imgs = torch.from_numpy(np.stack([scene, scene[::-1].copy()]))
    whs = torch.tensor([[128.0, 96.0]] * 2)
    for a, b in zip(tdet.detect_and_describe_batch(imgs, whs, cfg),
                    tdet.detect_and_describe(imgs, whs, cfg)):
        assert torch.equal(a, b)
