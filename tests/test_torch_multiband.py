"""Port parity for the multiband blender against the JAX package, on the CPU.

- ``_roi_sizes`` equal (the 8 / 128 rounding is kept: the blur replicates
  the plane's edge, so the padding decides what it sees near a RoI edge);
- first-level planes within 1e-4 (the inverse map's f32 products round
  apart from XLA:CPU's contracted ones; the weights move by ulps);
- winner-take-all: the port's seam on the JAX planes equals the JAX seam
  (exact comparisons), and on its own planes it differs only where two
  weights tie within an ulp: those pixels are counted and bounded;
- ``blend_multiband`` at band levels 2 and 3 on the two-image plan of
  tests/test_multiband.py and on a 12-view spherical plan whose sweep
  passes 360 degrees (the wrap split fires): equal valid masks, and the
  canvas within 1e-4 away from the blurs' reach of an item's right and
  bottom box edges.  Within that reach the two depart: the JAX package
  blurs its planes' zero padding past the box, the port replicates the
  box's edge as OpenPano does (tests/test_torch_multiband_reference.py
  holds the port there to a float64 reference).  Measured at 2 levels
  1.2e-7 (two-image) and 2.8e-5 (spherical), inside 1e-4; at 3 levels
  0.011 and 0.0033;
- the ``render.blend`` dispatch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openpano_tpu  # noqa: F401  (x64 on, as the JAX package runs)
from openpano_tpu.stitch import multiband as jmb
from openpano_tpu.stitch import render as jrender
from openpano_torch.config import Config, gauss_window_radius
from openpano_torch.stitch import multiband as tmb
from openpano_torch.stitch import render as trender
from openpano_torch.synth import procedural_scene_large, render_views

TOL = 1e-4


def padding_reach(plan, levels: int) -> np.ndarray:
    """[out_h, out_w] canvas pixels within the blurs' summed radii of an
    item's right or bottom box edge: the only ones the JAX package's zero
    padding can move."""
    reach = sum(gauss_window_radius(float(np.sqrt(2 * lv + 1.0) * 4),
                                    Config().GAUSS_WINDOW_FACTOR)
                for lv in range(levels - 1))
    near = np.zeros((plan.out_h, plan.out_w), bool)
    for _, x0, y0, x1, y1 in np.asarray(plan.items):
        if reach and x1 > x0 and y1 > y0:
            near[y0:y1, max(x0, x1 - reach):x1] = True
            near[max(y0, y1 - reach):y1, x0:x1] = True
    return near


def two_image_plan(shift=48):
    """tests/test_multiband.py's plan: two crops of one random scene, the
    second ``shift`` px to the right."""
    scene = np.random.default_rng(4).uniform(size=(64, 160, 3)).astype(np.float32)
    H2 = np.eye(3)
    H2[0, 2] = shift
    plan = jrender.plan_render(np.stack([np.eye(3), H2]),
                               np.array([[96.0, 64.0]] * 2), 0, "flat", 8000)
    return np.stack([scene[:, :96], scene[:, shift : shift + 96]]), plan


def spherical_plan():
    """12 views of 160x120, 40 degree field of view, 20% overlap: the sweep
    covers 392 degrees, so some image straddles the +-pi seam and splits
    into two render items.  Cameras from the true yaws."""
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
    plan = jrender.plan_render(np.stack(homos), np.repeat([[160.0, 120.0]], n, 0),
                               n // 2, "spherical", 8000)
    assert len(plan.items) > n            # the wrap split fired
    return views.astype(np.float32), plan


PLANS = {"two": two_image_plan, "spherical": spherical_plan}


def f32(a):
    return torch.as_tensor(np.array(a), dtype=torch.float32)


def first_levels(imgs, plan):
    rh, rw = jmb._roi_sizes(plan)
    want = jmb._first_level(
        jrender.pair_imgs_x(jnp.asarray(imgs)), jnp.asarray(plan.homo_invs),
        jnp.asarray(plan.whs, jnp.float32), jnp.asarray(plan.items[:, 0]),
        jnp.asarray(plan.items[:, 1:5]),
        jnp.asarray(plan.proj_min, jnp.float32),
        jnp.asarray(plan.resolution, jnp.float32), plan.proj, rh, rw)
    got = tmb._first_level(
        trender.pair_imgs_x(torch.from_numpy(imgs)), f32(plan.homo_invs),
        f32(plan.whs), plan.items[:, 0], plan.items[:, 1:5],
        f32(plan.proj_min), f32(plan.resolution), plan.proj, rh, rw)
    return got, np.asarray(want)


@pytest.mark.parametrize("name", ["two", "spherical", "shift0"])
def test_roi_sizes_equal(name):
    plan = two_image_plan(0)[1] if name == "shift0" else PLANS[name]()[1]
    assert tmb._roi_sizes(plan) == jmb._roi_sizes(plan)


@pytest.mark.parametrize("name", list(PLANS))
def test_first_level_planes_match(name):
    got, want = first_levels(*PLANS[name]())
    got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 3] > 0, want[..., 3] > 0)
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("name", list(PLANS))
def test_winner_take_all_matches(name):
    imgs, plan = PLANS[name]()
    got, want = first_levels(imgs, plan)
    ranges = plan.items[:, 1:5]
    jwta = np.asarray(jmb._winner_take_all(
        jnp.asarray(want), jnp.asarray(ranges), plan.out_h, plan.out_w))
    on_jax = tmb._winner_take_all(torch.from_numpy(want.copy()), ranges,
                                  plan.out_h, plan.out_w).numpy()
    np.testing.assert_array_equal(on_jax, jwta)
    own = tmb._winner_take_all(got, ranges, plan.out_h, plan.out_w).numpy()
    # seam pixels that change hands: only where the first-level weights
    # tie within a few ulps
    flips = own[..., 3] != jwta[..., 3]
    assert flips.sum() <= 1e-3 * flips.size
    assert set(np.unique(own[..., 3])) <= {0.0, 1.0}
    assert np.array_equal(own[..., :3], got.numpy()[..., :3])


@pytest.mark.parametrize("name", list(PLANS))
@pytest.mark.parametrize("levels", [2, 3])
def test_blend_multiband_matches(name, levels):
    imgs, plan = PLANS[name]()
    want = np.asarray(jmb.blend_multiband(jnp.asarray(imgs), plan, levels))
    got = tmb.blend_multiband(torch.from_numpy(imgs), plan, levels).numpy()
    assert got.shape == want.shape == (plan.out_h, plan.out_w, 3)
    np.testing.assert_array_equal(got[..., 0] >= 0, want[..., 0] >= 0)
    diff = np.abs(got - want).max(-1)
    near = padding_reach(plan, levels)
    assert diff[~near].max() <= TOL
    # the JAX package's zero padding (module docstring)
    assert (diff[near].max() > TOL) == (levels == 3)
    assert (want[..., 0] >= 0).mean() > 0.5


def test_blend_dispatch():
    """multiband > 0 runs the multiband blender, 0 the linear one; both
    match the JAX dispatch."""
    imgs, plan = two_image_plan()
    t = torch.from_numpy(imgs)
    for mb in (0, 2):
        got = trender.blend(t, plan, ordered=True, multiband=mb).numpy()
        want = np.asarray(jrender.blend(jnp.asarray(imgs), plan, ordered=True,
                                        multiband=mb))
        ref = (tmb.blend_multiband(t, plan, mb) if mb
               else trender.blend_linear(t, plan, ordered=True))
        assert torch.equal(torch.from_numpy(got), ref)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= TOL
