"""The port's tuning knobs and tools against the JAX package, on the CPU.

- ``OPENPANO_FEATURE_BATCH``: every batch size in {1, 2, 3, 4} gives the
  same Features bit for bit, through ``compute_features`` and through the
  transport (``bench.feature_batch``), and ``feature_shards`` follows it;
- ``OPENPANO_TILE_H`` / ``OPENPANO_TILE_W``: the port's ``_tile_jobs``
  under other tile sizes equals the JAX package's with the same sizes;
- ``OPENPANO_BLEND_GRID``: the port's ``_inverse_map_grid`` equals the JAX
  package's within 1e-6 relative; its linear blend of a 5-view spherical
  plan equals the JAX package's grid-mode blend (``render._BLEND_GRID``
  set by monkeypatch) within the 1e-4 the exact blend is held to; against
  the exact map it stays under ``render.GRID_MAX_ABS`` / ``GRID_MEAN_ABS``,
  which this measurement set;
- ``OPENPANO_MATCH_PRECISION``: every value gives the same matches on the
  CPU, and an unknown one raises; so does a batch or tile size below 1;
- the tools: ``ba_sweep.reproj_of`` equals the JAX tools' formula on fixed
  cameras; its variants are the JAX tool's; a sweep on a small set runs
  one schedule and one variant, and an unknown knob raises;
  ``comm_volume`` at 1-3 gloo ranks moves no byte in the feature compute
  (only the gather of its results) and the closed-form all-reduce per LM
  iteration; ``profile_sift`` runs its substages; ``run_test`` passes both
  modes through the port's CLI.

No JAX feature pipeline runs here.
"""

import ast
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openpano_tpu  # noqa: F401  (x64 on, as the JAX package runs)
from openpano_tpu.camera.camera import intrinsic as jintrinsic
from openpano_tpu.stitch import render as jrender
from openpano_tpu.stitch.projection import PROJECTIONS as JPROJ
from openpano_tpu.synth import gt_pair_homography as jgt_pair_homography
from openpano_torch.bench import ba_sweep, comm_volume, feature_batch, \
    profile_sift, run_test
from openpano_torch.bench.headline import Workload, headline_inputs
from openpano_torch.camera.camera import CameraSet
from openpano_torch.config import Config
from openpano_torch.match import matcher as tmatch
from openpano_torch.parallel.spawn import run_ranks
from openpano_torch.stitch import render as trender
from openpano_torch.stitch.projection import PROJECTIONS as TPROJ
from openpano_torch.stitch.stitcherbase import compute_features, \
    feature_shards
from openpano_torch.stitch.stitcherbase import feature_batch as \
    feature_batch_knob
from openpano_torch.synth import procedural_scene_large, render_views

ROOT = Path(__file__).resolve().parent.parent
CFG = Config(MAX_KP_PER_IMAGE=512, SIFT_WORKING_SIZE=280,
             MAX_CAND_PER_OCTAVE=1024, MAX_KP_PER_OCTAVE=512,
             MAX_DESC_PER_OCTAVE=512)
TINY = Workload(5, 320, 240, 32, 0.5, scene=(600, 2400), working_size=280)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this module (the test workers share
    the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def views():
    return profile_sift.feature_views(5, 320, 240, scene=(600, 2400))


@pytest.fixture(scope="module")
def ref_features(views):
    """The features at the batch the environment gives (4 unset)."""
    return compute_features(torch.from_numpy(views), CFG)


@pytest.mark.parametrize("B", [1, 2, 3, 4])
def test_feature_batch_gives_the_same_features(views, ref_features, B,
                                               monkeypatch):
    monkeypatch.setenv("OPENPANO_FEATURE_BATCH", str(B))
    got = compute_features(torch.from_numpy(views), CFG)
    for a, b in zip(got, ref_features):
        assert torch.equal(a, b)
    # 11 images on 2 ranks pad to 12, in chunks of B per rank
    assert feature_shards(11, 2).shape[1] == -(-12 // (2 * B)) * B


def test_feature_batch_sweep_through_the_transport(views, ref_features):
    """The sweep (in this process, the knob set per size): features equal
    across sizes and to ``compute_features``'s, the knob restored."""
    before = os.environ.get("OPENPANO_FEATURE_BATCH")
    lines, ok = feature_batch.run(device="cpu", sizes=(1, 2, 3, 4), u8=views,
                                  trials=1, cfg=CFG)
    assert ok and [line["batch"] for line in lines] == [1, 2, 3, 4]
    assert all(line["features_equal_first"] for line in lines[1:])
    assert [line["expected_launches"] for line in lines] == [5, 3, 2, 2]
    assert lines[0]["keypoints"] == int(ref_features.valid.sum())
    assert os.environ.get("OPENPANO_FEATURE_BATCH") == before
    for key in ("batch", "trials_s", "best_s", "device", "power_limit"):
        assert key in lines[0]


def _spherical_plan(n=5):
    views, truth = render_views(procedural_scene_large(600, 2400, seed=0), n,
                                out_w=320, out_h=240, hfov_deg=32,
                                overlap=0.5, seed=2)
    f = truth["focal_px"]
    homos = []
    for th in truth["yaws"]:
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                      [-np.sin(th), 0, np.cos(th)]])
        homos.append(R.T @ np.linalg.inv(np.diag([f, f, 1.0])))
    args = (np.stack(homos), np.repeat([[320.0, 240.0]], n, 0), n // 2,
            "spherical", 8000)
    return (views.astype(np.float32), trender.plan_render(*args),
            jrender.plan_render(*args))


@pytest.fixture(scope="module")
def spherical():
    return _spherical_plan()


@pytest.mark.parametrize("th,tw", [(128, 384), (64, 128), (256, 256)])
@pytest.mark.parametrize("exact", [False, True])
def test_tile_jobs_follow_the_tile_knobs(spherical, th, tw, exact,
                                         monkeypatch):
    _, tp, jp = spherical
    monkeypatch.setenv("OPENPANO_TILE_H", str(th))
    monkeypatch.setenv("OPENPANO_TILE_W", str(tw))
    tj = trender._tile_jobs(tp, 2, item_slabs=False, exact=exact)
    jj = jrender._tile_jobs(jp, 2, TH=th, TW=tw, item_slabs=False,
                            exact=exact)
    assert tj[:6] == jj[:6] and tj[4:6] == (th, tw)
    for tb, jb in zip(tj[6], jj[6]):
        for x, y in zip(tb, jb):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("proj", ["flat", "spherical", "cylindrical"])
def test_inverse_map_grid_matches_jax(spherical, proj):
    """Same inputs through both grid maps: within 1e-6 relative (XLA:CPU
    contracts the map's products; 2.4e-7 measured); a side no multiple of
    16 is the first rows and columns of the next whole-cell map."""
    _, plan, _ = spherical
    f32 = lambda a: np.asarray(a, np.float32)
    hinv, wh = f32(plan.homo_invs[1]), f32(plan.whs[1])
    res, pmin = f32(plan.resolution), f32(plan.proj_min)
    t = torch.from_numpy
    got = trender._inverse_map_grid(TPROJ[proj][1], t(hinv), t(wh), 96, 32,
                                    t(res), t(pmin), 256, 256)
    want = jax.jit(lambda h, w, ox, oy, r, p: jrender._inverse_map_grid(
        JPROJ[proj][1], h, w, ox, oy, r, p, 256, 256))(
        hinv, wh, jnp.int32(96), jnp.int32(32), res, pmin)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-6 * np.abs(b).max()
    cut = trender._inverse_map_grid(TPROJ[proj][1], t(hinv), t(wh), 96, 32,
                                    t(res), t(pmin), 248, 200)
    for a, b in zip(cut, got):
        assert torch.equal(a, b[:248, :200])


def _valid(canvas):
    return canvas[..., 0] >= 0


def test_grid_blend_matches_jax_grid_blend(spherical, monkeypatch):
    """The grid-mode linear blend (256 x 256 tiles) against the JAX
    package's: within 1e-4 where both are valid, the same valid pixels."""
    imgs, tp, jp = spherical
    monkeypatch.setattr(jrender, "_BLEND_GRID", True)
    jrender._blend_group.clear_cache()
    try:
        want = np.asarray(jrender.blend_linear(jnp.asarray(imgs), jp,
                                               ordered=False,
                                               item_slabs=False))
    finally:
        jrender._blend_group.clear_cache()
    monkeypatch.setenv("OPENPANO_BLEND_GRID", "1")
    got = trender.blend_linear(torch.from_numpy(imgs), tp, ordered=False,
                               item_slabs=False).numpy()
    np.testing.assert_array_equal(_valid(got), _valid(want))
    both = _valid(got)
    assert np.abs(got - want)[both].max() < 1e-4


@pytest.mark.parametrize("item_slabs", [True, False])
def test_grid_blend_within_its_bound(spherical, item_slabs, monkeypatch):
    """Grid against exact map, the port's own blend, both job geometries:
    largest difference 0.313 and mean 7.6e-4 where both are valid, 30 of
    238,791 pixels valid in one only (the z and bounds tests on
    interpolated coordinates); ``render.GRID_MAX_ABS`` and
    ``GRID_MEAN_ABS`` hold these, and the card's gates use them."""
    imgs, tp, _ = spherical
    src = torch.from_numpy(imgs)
    exact = trender.blend_linear(src, tp, ordered=False,
                                 item_slabs=item_slabs).numpy()
    monkeypatch.setenv("OPENPANO_BLEND_GRID", "1")
    grid = trender.blend_linear(src, tp, ordered=False,
                                item_slabs=item_slabs).numpy()
    both = _valid(grid) & _valid(exact)
    d = np.abs(grid - exact)[both]
    assert 0 < d.max() < trender.GRID_MAX_ABS
    assert d.mean() < trender.GRID_MEAN_ABS
    assert (_valid(grid) != _valid(exact)).mean() < 1e-3


def _descriptors(seed, n=2, K=300):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, K, 128)).astype(np.float32)
    d[1, :200] = d[0, :200] + rng.normal(0, 0.3, (200, 128))
    d = np.abs(d)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    valid = np.ones((n, K), bool)
    valid[:, -20:] = False
    return torch.from_numpy(d * 512), torch.from_numpy(valid)


@pytest.mark.parametrize("prec", ["highest", "high", "medium", "HIGH"])
def test_match_precision_gives_the_same_matches_on_cpu(prec, monkeypatch):
    d, v = _descriptors(3)
    cfg = Config(MAX_MATCHES_PER_PAIR=256)
    want = tmatch.match_pair(d[0], v[0], d[1], v[1], cfg)
    monkeypatch.setenv("OPENPANO_MATCH_PRECISION", prec)
    got = tmatch.match_pair(d[0], v[0], d[1], v[1], cfg)
    assert int(want.count) > 100
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.get_float32_matmul_precision() == "highest"


def test_unknown_match_precision_raises(monkeypatch):
    d, v = _descriptors(4)
    monkeypatch.setenv("OPENPANO_MATCH_PRECISION", "bf16")
    with pytest.raises(ValueError, match="OPENPANO_MATCH_PRECISION"):
        tmatch.match_pair(d[0], v[0], d[1], v[1], Config())


@pytest.mark.parametrize("name,value", [
    ("OPENPANO_FEATURE_BATCH", "0"), ("OPENPANO_FEATURE_BATCH", "-2"),
    ("OPENPANO_TILE_H", "0"), ("OPENPANO_TILE_W", "-1")])
def test_size_knobs_below_one_raise(name, value, monkeypatch):
    monkeypatch.setenv(name, value)
    read = feature_batch_knob if name == "OPENPANO_FEATURE_BATCH" \
        else trender.tile_size
    with pytest.raises(ValueError, match=name):
        read()


def _jax_reproj_of(cams, truth, perm, w):
    """tools/ba_sweep.py:64-88's reproj_of, with the JAX package's
    intrinsic and ground truth."""
    n = len(cams.focal)
    inv_perm = np.argsort(perm)
    gx, gy = np.meshgrid(np.linspace(-w.out_w * 0.45, w.out_w * 0.05, 9),
                         np.linspace(-w.out_h * 0.4, w.out_h * 0.4, 7))
    grid = np.stack([gx.ravel(), gy.ravel(), np.ones(gx.size)], 1)
    homos = np.zeros((n, 3, 3))
    for i in range(n):
        K = jintrinsic(cams.focal[i], cams.ppx[i], cams.ppy[i])
        homos[i] = cams.R[i].T @ np.linalg.inv(K)
    errs = []
    for orig in range(n - 1):
        i, j = inv_perm[orig], inv_perm[orig + 1]
        H_est = np.linalg.inv(homos[i]) @ homos[j]
        H_gt = jgt_pair_homography(
            {"focal_px": truth["focal_px"], "yaws": truth["yaws"]},
            i, j, w.out_w, w.out_h)
        pe, pg = grid @ H_est.T, grid @ H_gt.T
        errs.append(np.linalg.norm(pe[:, :2] / pe[:, 2:3]
                                   - pg[:, :2] / pg[:, 2:3], axis=1).mean())
    return float(np.mean(errs))


def test_reproj_of_is_the_jax_tools_formula():
    """Cameras near the truth (yaws of the shuffled sweep, focal and yaw
    perturbed): the port's ``reproj_of`` equals the JAX tool's."""
    _, truth, perm = headline_inputs(TINY)
    rng = np.random.default_rng(7)
    n = TINY.n
    Rs = []
    for yaw in truth["yaws"] + rng.normal(0, 0.01, n):
        c, s = np.cos(yaw), np.sin(yaw)
        Rs.append(np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]))
    cams = CameraSet(focal=truth["focal_px"] * (1 + rng.normal(0, 0.02, n)),
                     ppx=np.zeros(n), ppy=np.zeros(n), R=np.stack(Rs))
    got = ba_sweep.reproj_of(cams, truth, perm, TINY)
    want = _jax_reproj_of(cams, truth, perm, TINY)
    assert got > 0.1
    assert abs(got - want) <= 1e-12 * want


def _jax_r5_variants() -> dict:
    """The ``variants`` literal of tools/sweep_ba_r5.py, read without
    running the tool."""
    tree = ast.parse((ROOT / "tools" / "sweep_ba_r5.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "variants"):
            return ast.literal_eval(node.value)
    raise AssertionError("no variants in tools/sweep_ba_r5.py")


def test_ba_sweep_knobs_are_the_jax_tools():
    """The 28 variants (no environment variable among them) and the 8
    schedules, every knob a field of the port's Config; an unknown knob or
    variant raises."""
    jv = _jax_r5_variants()
    assert len(jv) == 28 and all(env == {} for _, env in jv.values())
    assert ba_sweep.R5_VARIANTS == {k: over for k, (over, _) in jv.items()}
    assert len(ba_sweep.R2_SCHEDULES) == 8
    for over in [*ba_sweep.R2_SCHEDULES, *ba_sweep.R5_VARIANTS.values()]:
        ba_sweep.check_knobs(over)
    with pytest.raises(ValueError, match="BA_FUSED"):
        ba_sweep.check_knobs({"BA_FUSED": True})
    with pytest.raises(ValueError, match="nope"):
        ba_sweep.run(device="cpu", sweep="r5", picks=["nope"])


@pytest.mark.parametrize("sweep,pick", [("r2", "0"), ("r5", "cap2_it9_adapt")])
def test_ba_sweep_runs_one_schedule(sweep, pick):
    (line,) = ba_sweep.run(device="cpu", sweep=sweep, picks=[pick],
                           workload=TINY, reps=1)
    keys = (("BA_INTERMEDIATE_ITERS", "wall_s", "lm_iters", "ba_rms_px",
             "reproj_px") if sweep == "r2" else
            ("name", "ec_s", "wall_s", "iters", "reproj_px", "lm"))
    for key in keys + ("device", "power_limit"):
        assert key in line
    assert 0 < line["reproj_px"] < 2.5
    assert (line["lm_iters"] if sweep == "r2" else line["iters"]) > 0


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_comm_volume(nd, tmp_path):
    """Every rank: no collective byte in the feature compute, only the
    gather of its fixed-cap results; one LM iteration's all-reduce is the
    dense f64 normal equations at 38 cameras and the cost's two sums; the
    sharded blend's halo goes right from every rank but the last."""
    imgs = comm_volume.views(4, 160, 120)
    ranks = run_ranks(comm_volume.measure, nd, str(tmp_path), args=(imgs,),
                      timeout_s=240.0)
    assert comm_volume.ba_iteration_bytes(38) == (228 * 228 + 228 + 2) * 8
    for r, got in enumerate(ranks):
        feat = got["feature"]
        assert feat["compute_bytes"] == 0
        assert feat["collective_bytes_per_device"] == {
            "features": {"all_gather": feat["gather_bytes"]}}
        assert (got["dist_ba"]["collective_bytes_per_device_per_iteration"]
                == comm_volume.ba_iteration_bytes())
        blend = got["blend_sharded"]["collective_bytes_per_device"]["blend"]
        assert ("halo_right" in blend) == (r < nd - 1)
        assert set(got["match_ransac"]["collective_bytes_per_device"]) == {
            "match", "ransac"}


def test_profile_sift_substages():
    """Every substage line and key on a small set; no kernel launches on
    the CPU (the plain versions run)."""
    v = profile_sift.feature_views(4, 320, 240, scene=(600, 2400))
    lines = profile_sift.run(device="cpu", views=v, reps=1, cfg=CFG)
    prof, steady, calls = lines
    for key in ("resize_ms", "pyramid_ms", "extrema_ms", "orientation_ms",
                "descriptor_ms", "full_chunk_ms", "resid_ms", "keypoints",
                "device", "power_limit"):
        assert key in prof
    assert prof["keypoints"] > 100
    assert len(steady["trials_ms"]) == 3
    assert set(steady["batch_ms_per_img"]) == {"2", "4"}
    assert all(c == 0 for stage in prof["launches_per_call"].values()
               for c in stage.values())
    assert calls["tool"] == "feature_batch_launches"


def test_run_test_both_modes(tmp_path, monkeypatch):
    """The CLI harness, both modes, on the CPU: each final size within 0.8
    of its golden.  The CLI processes take one intra-op thread, as this
    module does (the test workers share the CPU)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    lines = run_test.run(device="cpu", jobs_dir=str(tmp_path))
    assert [line["mode"] for line in lines] == ["cylinder", "camera"]
    for line in lines:
        assert line["ok"], line
