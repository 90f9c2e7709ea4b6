"""The port's multiband blender held to the benchmark's plain float64
reference (``benchmark/reference_multiband.py``), on the CPU.

- ``multiband.blend_multiband`` (float32) against ``reference_multiband.
  blend`` (float64) on seeded procedural views through a 12-view
  spherical plan whose sweep passes 360 degrees (one image splits at
  +-pi into two render items), at 1, 2 and 5 levels: equal masks, and the
  share of canvas pixels more than one u8 level off, which only float32's
  rounding ties may make.  The reference computed in bfloat16 fails it.
- the JAX package's ``blend_multiband`` pads every item's plane with zeros
  to the largest item's box and blurs those zeros where OpenPano (and the
  port, and the reference) replicate the item's box edge: at 5 levels its
  canvas departs from the reference only within the blurs' reach of an
  item's right and bottom box edges, and there by more than rounding.
- one end-to-end ``stitch_images(MULTIBAND=5)`` of a 4-view sweep, judged
  by the benchmark's own ``judge.canvas_bad`` with this reference.
- the reference imports nothing of the port, of JAX or of the JAX package.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import openpano_torch
from benchmark import judge, reference, reference_multiband as rmb
from openpano_torch.config import Config
from openpano_torch.stitch import multiband as tmb
from openpano_torch.stitch.render import f32_to_u8, plan_render
from openpano_torch.synth import procedural_scene, procedural_scene_large, \
    render_views

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = {"GAUSS_WINDOW_FACTOR": Config().GAUSS_WINDOW_FACTOR}
# the share of canvas pixels more than one level off (or outside one mask
# only) that the port may give: 0 at 1, 2 and 5 levels on this plan (the
# largest gap one level: float32 against float64 at u8 rounding ties); the
# bound leaves room for a few seam pixels whose float32 weights tie.  The
# bfloat16 reference reads 0.66-0.73.
SHARE_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this module (the test workers share
    the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wrap_plan():
    """12 u8 views of 160x120 of a seeded procedural scene, 40 degree field
    of view, 20% overlap, cameras from the true yaws: the sweep covers 392
    degrees, so one image straddles the +-pi seam.  Returns (views, the
    port's RenderPlan, the reference's plan)."""
    n = 12
    views, truth = render_views(procedural_scene(300, 1600, seed=3), n,
                                out_w=160, out_h=120, hfov_deg=40,
                                overlap=0.2, seed=2)
    u8 = np.round(np.asarray(views) * 255).astype(np.uint8)
    f = truth["focal_px"]
    homos = []
    for th in truth["yaws"]:
        R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                      [-np.sin(th), 0, np.cos(th)]])
        homos.append(R.T @ np.linalg.inv(np.diag([f, f, 1.0])))
    homos = np.stack(homos)
    whs = np.repeat([[160.0, 120.0]], n, 0)
    tp = plan_render(homos, whs, n // 2, "spherical", 8000)
    rp = reference.plan(homos, whs, n // 2, "spherical", 8000)
    assert len(rp["items"]) > n                 # the wrap split fired
    np.testing.assert_array_equal(np.asarray(tp.items),
                                  np.asarray(rp["items"]))
    return u8, tp, rp


def _padding_reach(rp: dict, levels: int) -> torch.Tensor:
    """Canvas pixels within the blurs' summed radii of an item's right or
    bottom box edge: the only pixels zero padding past the box can move."""
    reach = 0
    for lv in range(levels - 1):
        reach += sift_radius(math.sqrt(2 * lv + 1.0) * 4)
    near = torch.zeros(rp["out_h"], rp["out_w"], dtype=torch.bool)
    for _, x0, y0, x1, y1 in rp["items"]:
        if reach and x1 > x0 and y1 > y0:
            near[y0:y1, max(x0, x1 - reach):x1] = True
            near[max(y0, y1 - reach):y1, x0:x1] = True
    return near


def sift_radius(sigma: float) -> int:
    from benchmark import sift_ref

    return int(sift_ref.gauss_taps(sigma, SETTINGS["GAUSS_WINDOW_FACTOR"],
                                   None, "cpu").numel()) // 2


def _bad(got, got_m, want, want_m) -> torch.Tensor:
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs().amax(-1)
    return (got_m != want_m) | (got_m & want_m & (diff > 1))


@pytest.mark.parametrize("levels", [1, 2, 5])
def test_port_against_float64_reference(wrap_plan, levels):
    u8, tp, rp = wrap_plan
    s = {**SETTINGS, "MULTIBAND": levels}
    got, got_m = f32_to_u8(tmb.blend_multiband(
        torch.from_numpy(u8).float() / 255.0, tp, levels))
    want, want_m = rmb.blend(torch.from_numpy(u8), rp, s)
    assert got.shape == want.shape == (rp["out_h"], rp["out_w"], 3)
    assert torch.equal(got_m, want_m)
    assert want_m.double().mean() > 0.5
    assert _bad(got, got_m, want, want_m).double().mean() <= SHARE_TOL
    low, low_m = rmb.blend(torch.from_numpy(u8), rp, s, dtype=torch.bfloat16)
    assert _bad(low, low_m, want, want_m).double().mean() > SHARE_TOL


def test_padding_departure_is_the_zero_padding(wrap_plan):
    """At 5 levels the JAX package's canvas departs from the reference only
    within the padding's reach, and by more than rounding: its zero-padded
    planes (7.4% of this plan's pixels), which the port's replicated box
    edges no longer share (test above)."""
    import jax.numpy as jnp
    from openpano_tpu.stitch import multiband as jmb
    from openpano_tpu.stitch import render as jrender

    u8, tp, rp = wrap_plan
    jp = jrender.plan_render(tp.homos, tp.whs, len(u8) // 2, tp.proj, 8000)
    j = jmb.blend_multiband(jnp.asarray(u8.astype(np.float32) / 255.0), jp,
                            5)
    got, got_m = f32_to_u8(torch.from_numpy(np.array(j)))
    want, want_m = rmb.blend(torch.from_numpy(u8), rp,
                             {**SETTINGS, "MULTIBAND": 5})
    bad = _bad(got, got_m, want, want_m)
    near = _padding_reach(rp, 5)
    assert int((bad & ~near).sum()) == 0
    assert bad.double().mean() > 0.01


# a 4-view sweep through the normal path (test_torch_spans.py's views)
CFG = Config(RANSAC_ITERATIONS=400, MAX_CAND_PER_OCTAVE=1024,
             MAX_KP_PER_OCTAVE=512, MAX_DESC_PER_OCTAVE=512,
             MAX_KP_PER_IMAGE=1024, MAX_MATCHES_PER_PAIR=512,
             SIFT_WORKING_SIZE=400, MULTIBAND=5)
# the benchmark cell's limit (benchmark/limits/camera_multiband.
# cmu0_unordered38.json) holds here too: this stitch reads 5.0e-6 (one
# pixel), its bfloat16 control 0.68
STITCH_TOL = 1e-4


def test_stitch_multiband_judged_by_canvas_bad():
    views = render_views(procedural_scene_large(600, 2400, seed=0), 4,
                         out_w=320, out_h=240, hfov_deg=32, overlap=0.5)[0]
    u8 = np.round(np.asarray(views) * 255).astype(np.uint8)
    info = {}
    canvas, mask = openpano_torch.stitch_images(u8, CFG, output="u8",
                                                device="cpu", info_out=info)
    s = {"ESTIMATE_CAMERA": True, "MAX_OUTPUT_SIZE": CFG.MAX_OUTPUT_SIZE,
         "MULTIBAND": CFG.MULTIBAND, "reference": "reference_multiband",
         "GAUSS_WINDOW_FACTOR": CFG.GAUSS_WINDOW_FACTOR,
         "precision": {"blend": "float32"}}
    cap = judge.Capture(views=u8, truth={}, desc=None, valid=None,
                        match_idx=None, match_count=None, graph={},
                        homos=np.asarray(info["homos"], np.float64),
                        canvas=np.asarray(canvas), mask=np.asarray(mask))
    assert judge.canvas_bad(cap, s, "program", "cpu") <= STITCH_TOL
    assert judge.canvas_bad(cap, s, "control", "cpu") > STITCH_TOL


def test_reference_imports_nothing_of_the_port_or_jax():
    code = ("import sys; import benchmark.reference_multiband, "
            "benchmark.workmodel_multiband; print(sorted({m.split('.')[0] "
            "for m in sys.modules} & {'jax', 'jaxlib', 'flax', "
            "'openpano_tpu', 'openpano_torch'}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
