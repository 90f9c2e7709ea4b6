"""Port parity for the host-stream blends against the JAX package, on the CPU.

The image stack stays in host memory and the canvas is blended in column
bands, the spill halo carried from band to band (``render.
blend_linear_host_stream``, ``multiband.blend_multiband_host_stream``):

- ``_tile_jobs`` equals the JAX package's one-slab-per-item layout field
  for field, for 2, 3 and 4 bands, banded (``exact=True``) and in memory,
  on a flat plan and on a spherical plan whose sweep passes 360 degrees (a
  wrap-split item);
- the linear host stream within 1e-5 of the port's in-memory ``blend`` on
  pixels valid in both, valid masks agreeing on >= 99.9%, and of the JAX
  one on the flat plan (2 and 4 bands); on the spherical plan (2 bands)
  within 1e-4 of the JAX one, since the two packages' in-memory blends
  already differ there by 3.8e-5 (torch's and XLA:CPU's f32 sin / cos /
  tan differ in the last bit for 3-5% of arguments, which moves sample
  coordinates); its u8 output within one level of the JAX u8 output (flat
  plan) and of its own f32 output;
- the multiband host stream within 1e-4 of the port's in-memory
  ``blend_multiband`` (which tests/test_torch_multiband.py holds to the
  JAX package's on the same spherical plan), and of the JAX host stream on
  the flat plan.  On the spherical plan the JAX host stream departs from
  the in-memory blend by up to 0.5 at the seams of items that spill into
  the next band (its seam halo runs one way: such an item never sees the
  next band's items); the port folds the seam over all bands first and
  stays on the in-memory canvas (ROADMAP Queue 3);
- through ``stitch(device="cpu")``: ``OPENPANO_HOST_BLEND=1`` and a budget
  of 0.001 GB (linear and MULTIBAND=2) give the in-memory canvas within one
  u8 level (f32 band-order rounding at ties, as tests/test_host_blend.py
  allows), with the same render plan.
"""

import numpy as np
import pytest
import torch

import openpano_tpu  # noqa: F401  (x64 on, as the JAX package runs)
from openpano_tpu.stitch import multiband as jmb
from openpano_tpu.stitch import render as jrender
from openpano_torch import Config
from openpano_torch.stitch import multiband as tmb
from openpano_torch.stitch import render as trender
from openpano_torch.stitch.stitcher import host_stream_groups, stitch
from openpano_torch.synth import procedural_scene_large, render_views

LINEAR_TOL = 1e-5
MB_TOL = 1e-4
# linear, against the JAX package: the f32 trig of the spherical inverse map
# rounds apart (module docstring)
JAX_LINEAR_TOL = {"flat": LINEAR_TOL, "spherical": 1e-4}
CFG = Config(ESTIMATE_CAMERA=True, ORDERED_INPUT=True,
             MAX_CAND_PER_OCTAVE=1024, MAX_KP_PER_OCTAVE=512,
             MAX_DESC_PER_OCTAVE=512, MAX_KP_PER_IMAGE=1024,
             MAX_MATCHES_PER_PAIR=256, SIFT_WORKING_SIZE=280)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this module: its Python loops issue many
    small ops, and the test workers share the CPU, so more threads would
    only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def u8(views):
    return np.round(views * 255).astype(np.uint8)


def flat_case():
    """tests/test_host_blend.py's data: 6 u8 views of 320x240 on a flat plan
    of 90 px translations."""
    views, _ = render_views(procedural_scene_large(600, 2400, seed=0), 6,
                            out_w=320, out_h=240, hfov_deg=30, overlap=0.55,
                            seed=7)
    n = 6
    homos = np.stack([np.eye(3) for _ in range(n)])
    homos[:, 0, 2] = 90.0 * (np.arange(n) - n // 2)
    plan = jrender.plan_render(homos, np.repeat([[320.0, 240.0]], n, 0),
                               n // 2, "flat", 8000)
    return u8(views), plan


def spherical_case():
    """12 u8 views of 160x120 over 392 degrees (40 degree field of view, 20%
    overlap), cameras from the true yaws: a view straddles the +-pi seam
    and splits into two render items at the canvas edges."""
    n = 12
    views, truth = render_views(procedural_scene_large(300, 1600, seed=1), n,
                                out_w=160, out_h=120, hfov_deg=40,
                                overlap=0.2, seed=2)
    f = truth["focal_px"]
    homos = []
    for th in truth["yaws"]:
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                      [-np.sin(th), 0, np.cos(th)]])
        homos.append(R.T @ np.linalg.inv(np.diag([f, f, 1.0])))
    plan = jrender.plan_render(np.stack(homos),
                               np.repeat([[160.0, 120.0]], n, 0), n // 2,
                               "spherical", 8000)
    assert len(plan.items) > n            # the wrap split fired
    return u8(views), plan


CASES = {"flat": flat_case, "spherical": spherical_case}
_cache = {}


def cached(fn):
    """Memoize a function of the case name within the module."""
    def run(name):
        if (fn, name) not in _cache:
            _cache[fn, name] = fn(name)
        return _cache[fn, name]
    return run


@cached
def case(name):
    return CASES[name]()


def f32_stack(imgs):
    return imgs.astype(np.float32) / 255.0


@cached
def in_memory_linear(name):
    imgs, plan = case(name)
    return trender.blend(torch.from_numpy(f32_stack(imgs)), plan,
                         ordered=True, multiband=0).numpy()


@cached
def in_memory_multiband(name):
    """The port's in-memory multiband canvas at two levels."""
    imgs, plan = case(name)
    return tmb.blend_multiband(torch.from_numpy(f32_stack(imgs)), plan,
                               2).numpy()


def assert_canvases_agree(got, want, tol):
    assert got.shape == want.shape
    vg, vw = got[..., 0] >= 0, want[..., 0] >= 0
    agree = (vg == vw).mean()
    assert agree >= 0.999, agree
    both = vg & vw
    assert both.mean() > 0.3
    diff = np.abs(got[both] - want[both]).max()
    assert diff <= tol, diff


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("groups", [2, 3, 4])
@pytest.mark.parametrize("exact", [False, True])
def test_tile_jobs_exact_match(name, groups, exact):
    _, plan = case(name)
    got = trender._tile_jobs(plan, groups, exact=exact)
    want = jrender._tile_jobs(plan, groups=groups, exact=exact,
                              item_slabs=True)
    assert got[:6] == want[:6]
    assert got[1] >= got[5]                            # SW >= TW
    assert got[0] == groups if exact else got[0] <= groups
    for gb, wb in zip(got[6], want[6]):
        for a, b in zip(gb, wb):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("groups", [2, 4])
def test_linear_host_stream_matches(name, groups):
    imgs, plan = case(name)
    got = trender.blend_linear_host_stream(imgs, plan, ordered=True,
                                           groups=groups, device="cpu")
    assert_canvases_agree(got, in_memory_linear(name), LINEAR_TOL)
    if name == "flat" or groups == 2:
        want = jrender.blend_linear_host_stream(imgs, plan, ordered=True,
                                                groups=groups)
        assert_canvases_agree(got, np.asarray(want), JAX_LINEAR_TOL[name])


@pytest.mark.parametrize("name", list(CASES))
def test_linear_host_stream_u8_out(name):
    """u8 strips: RGBA, alpha the valid mask of the f32 run and colour its
    rounding; within one level of the JAX u8 output (its download codec is
    lossless) on the flat plan."""
    imgs, plan = case(name)
    got = trender.blend_linear_host_stream(imgs, plan, ordered=False,
                                           groups=3, u8_out=True, device="cpu")
    assert got.dtype == np.uint8
    assert got.shape == (plan.out_h, plan.out_w, 4)
    f32 = trender.blend_linear_host_stream(imgs, plan, ordered=False,
                                           groups=3, device="cpu")
    valid = f32[..., 0] >= 0
    np.testing.assert_array_equal(got[..., 3] > 0, valid)
    np.testing.assert_array_equal(
        got[..., :3][valid], np.round(f32[valid] * 255.0).astype(np.uint8))
    assert (got[..., :3][~valid] == 255).all()
    if name == "flat":
        want = jrender.blend_linear_host_stream(imgs, plan, ordered=False,
                                                groups=3, u8_out=True)
        assert got.shape == want.shape
        assert (got[..., 3] == want[..., 3]).mean() >= 0.999
        assert np.abs(got.astype(np.int16)
                      - want.astype(np.int16)).max() <= 1


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("groups", [2, 3])
def test_multiband_host_stream_matches(name, groups):
    imgs, plan = case(name)
    got = tmb.blend_multiband_host_stream(imgs, plan, 2, groups,
                                          device="cpu")
    mem = in_memory_multiband(name)
    assert_canvases_agree(got, mem, MB_TOL)
    if name == "spherical" and groups != 2:
        return                            # the JAX departure is pinned once
    jhost = np.asarray(jmb.blend_multiband_host_stream(
        imgs, plan, band_level=2, groups=groups))
    if name == "flat":
        assert_canvases_agree(got, jhost, MB_TOL)
    else:
        # the JAX host stream's one-way seam halo (module docstring)
        assert np.abs(jhost - mem).max() > 0.1


@pytest.mark.parametrize("name", list(CASES))
def test_multiband_host_stream_replicates_box_edges(name):
    """At 5 levels (four blurs, reach 27 px) the band step's planes take
    their box's edge past it before each blur, as the in-memory ones do:
    the two canvases agree within the gate, and both differ from a run
    that leaves the padding zero (the JAX package's layout) by more."""
    imgs, plan = case(name)
    got = tmb.blend_multiband_host_stream(imgs, plan, 5, 2, device="cpu")
    mem = tmb.blend_multiband(torch.from_numpy(f32_stack(imgs)), plan,
                              5).numpy()
    assert_canvases_agree(got, mem, MB_TOL)
    keep = tmb._replicate_box_edges
    tmb._replicate_box_edges = lambda planes, sizes: planes
    try:
        zero = tmb.blend_multiband_host_stream(imgs, plan, 5, 2,
                                               device="cpu")
    finally:
        tmb._replicate_box_edges = keep
    valid = (got[..., 0] >= 0) & (zero[..., 0] >= 0)
    assert np.abs(got[valid] - zero[valid]).max() > 10 * MB_TOL


# ---- through the entry point ----

@pytest.fixture(scope="module")
def views_u8():
    """5 u8 views of 320x240 of a rotating camera."""
    views, _ = render_views(procedural_scene_large(600, 2400, seed=0), 5,
                            out_w=320, out_h=240, hfov_deg=30, overlap=0.55,
                            seed=7)
    return u8(views)


@pytest.fixture(scope="module")
def in_memory(views_u8):
    info = {}
    out = stitch(views_u8, CFG, output="u8", device="cpu", info_out=info)
    return out, info


def assert_u8_agree(got, want):
    (cg, vg), (cw, vw) = got, want
    assert cg.shape == cw.shape
    assert (vg == vw).mean() >= 0.999
    both = vg & vw
    assert both.mean() > 0.3
    d = np.abs(cg[both].astype(np.int16) - cw[both].astype(np.int16))
    assert d.max() <= 1, d.max()  # f32 band-order rounding at u8 ties


@pytest.mark.parametrize("env,multiband", [
    ({"OPENPANO_HOST_BLEND": "1"}, 0),
    ({"OPENPANO_HBM_BUDGET_GB": "0.001"}, 0),
    ({"OPENPANO_HBM_BUDGET_GB": "0.001"}, 2)])
def test_stitch_host_stream_equals_in_memory(views_u8, in_memory, monkeypatch,
                                             env, multiband):
    """The host path fires, keeps every stage before the blend (the same
    plan), and its canvas is the in-memory one within one u8 level; the
    multiband run is held to the in-memory multiband blend of that plan."""
    (canvas, valid), info = in_memory
    plan = info["plan"]
    calls = []
    real = trender.band_slice
    monkeypatch.setattr(trender, "band_slice",
                        lambda *a: calls.append(len(a[1])) or real(*a))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    host_info = {}
    got = stitch(views_u8, CFG.replace(MULTIBAND=multiband), output="u8",
                 device="cpu", info_out=host_info)
    groups = host_stream_groups(views_u8.shape)
    assert groups == 2
    assert 0 < len(calls) <= groups and sum(calls) >= len(views_u8)
    np.testing.assert_array_equal(host_info["plan"].items, plan.items)
    np.testing.assert_array_equal(host_info["kpt_counts"], info["kpt_counts"])
    if multiband:
        from openpano_torch.stitch.stitcher import to_output

        src = torch.from_numpy(views_u8).float() / 255.0
        want = to_output(tmb.blend_multiband(src, plan, multiband), "u8")
    else:
        want = (canvas, valid)
    assert_u8_agree(got, want)
