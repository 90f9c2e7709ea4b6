"""A CYLINDER cell at a size the CPU holds: added only as files (its
configuration naming ``reference_cylinder``, traffic and limits) and
entries, it runs correct with the h-factor search past its first trial;
its control and three faults planted in the cylinder stitcher's own steps
come out incorrect.  Beside it: ``pitch`` 0 leaves the sweep's views and
truths as they were, and the camera cell's numbers are unchanged."""

import contextlib
import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from benchmark import calibrate, faults, harness, scenes, spec
from conftest import ROOT, TINY_CELL

SEED = 2147483673           # compares panoramas 0 and 1
CYL_CELL = "tiny_cylinder.tiny_pitched"
CYL_TRAFFIC = {
    "kind": "sweep",
    "params": {"n": 5, "width": 480, "height": 360, "hfov": 40,
               "overlap": 0.5, "jitter": 0.05, "shuffle": False,
               "pitch": 3.0, "texture": [560, 4200]},
    "program": {"ORDERED_INPUT": True}, "pool": 5, "warmup": 0}
# the cylinder's radius is the views' focal: r = hypot(w, h) * FOCAL_LENGTH
# / 43.266 (warp.cc:70-75) and f = (w / 2) / tan(hfov / 2)
FOCAL_LENGTH = (240 / math.tan(math.radians(20))) * 43.266 / math.hypot(
    480, 360)
CYL_CONFIG = {
    "name": "tiny_cylinder", "source": "test", "program": {
        "CYLINDER": True, "ESTIMATE_CAMERA": False, "TRANS": False,
        "FOCAL_LENGTH": FOCAL_LENGTH, "MAX_KP_PER_IMAGE": 1024,
        "MAX_MATCHES_PER_PAIR": 1024},
    "reference": "reference_cylinder",
    "precision": {"features": "float32", "match": "float32",
                  "ransac": "float32", "cameras": "float64",
                  "blend": "float32"}}
# set from the CPU readings of the tiny cell, two panoramas a seed, seeds
# 11, 2^31 + 25 and 2^31 + 42 (program: kp_diff 0, kp_offset 9.0e-5-9.9e-5,
# ori_miss 0, desc_miss 0, match_diff 0, refit_px 2.4e-4-7.8e-4, truth_px
# 0.49-0.77, canvas_bad 0-2.0e-6; 2 trials of the h-factor search, factor
# 1.2, every panorama; the bfloat16 control: kp_diff 3.2-3.5, kp_offset
# 0.41-0.47, ori_miss 0.093-0.096, desc_miss 0.998-0.9995, match_diff
# 5.5e-3-1.9e-2, refit_px 3.1-7.8, canvas_bad 0.73-0.77, truth_px as the
# program's (its transforms rounded to float32); the faults at 2^31 + 25:
# warp_radius_off canvas_bad 0.87, correction_skipped canvas_bad 0.75,
# left_chain_reversed truth_px 27.4)
CYL_LIMITS = {"kp_diff": 1e-2, "kp_offset": 0.05, "ori_miss": 0.02,
              "desc_miss": 0.01, "match_diff": 1e-3, "refit_px": 0.05,
              "truth_px": 4.0, "canvas_bad": 1e-4}


@pytest.fixture(scope="module")
def cyl_root(tmp_path_factory):
    """A checkout-like root: the real benchmark's data files, plus a tiny
    CYLINDER cell added only as files and entries."""
    root = tmp_path_factory.mktemp("bench_cyl_root")
    bdir = root / "benchmark"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(ROOT, "benchmark", sub), bdir / sub)
    (bdir / "configs" / "tiny_cylinder.json").write_text(
        json.dumps(CYL_CONFIG))
    (bdir / "traffic" / "tiny_pitched.json").write_text(
        json.dumps(CYL_TRAFFIC))
    (bdir / "limits" / f"{CYL_CELL}.json").write_text(json.dumps(CYL_LIMITS))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_cylinder", "source": "test",
                             "file": "benchmark/configs/tiny_cylinder.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CYL_CELL, "config": "tiny_cylinder",
                               "traffic": "tiny_pitched", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def cell(cyl_root):
    return spec.load(CYL_CELL, root=str(cyl_root))


@contextlib.contextmanager
def _searches(seen: list):
    """Each CYLINDER stitch's h-factor search (trials, factor) into
    ``seen``."""
    from openpano_torch.stitch import cylstitcher

    orig = cylstitcher.stitch_cylinder

    def run(*a, info_out=None, **k):
        info = {} if info_out is None else info_out
        out = orig(*a, info_out=info, **k)
        seen.append((info["trials"], info["hfactor"]))
        return out
    cylstitcher.stitch_cylinder = run
    try:
        yield
    finally:
        cylstitcher.stitch_cylinder = orig


def test_cylinder_cell_runs_correct_past_the_first_trial(cell):
    assert cell.config["reference"] == "reference_cylinder"
    seen = []
    with _searches(seen):
        r = harness.run(cell, SEED, 0.1, False, device="cpu",
                        log=lambda m: None)
    assert r["correct"] is True, json.dumps(r["compared"])
    for name, c in r["compared"].items():
        assert c["value"] <= c["limit"], (name, c)
    assert seen and all(trials >= 2 for trials, _ in seen), seen
    assert not harness.forbidden_modules()


def test_capture_holds_the_chain_pairs(cell):
    """The captured graph holds the n - 1 chain pairs, each once, with a
    positive confidence, and its transforms multiply into the final
    ones."""
    import openpano_torch
    from openpano_torch import Config
    from openpano_torch.ops import windows
    from openpano_torch.stitch import stitcher

    views, truth = harness.make_pool(cell, SEED, "cpu", count=1)[0]
    probes = harness.Probes(stitcher, windows)
    try:
        probes.armed = True
        probes.reset()
        info = {}
        canvas, mask = openpano_torch.stitch_images(
            views, Config(**cell.program()), output="u8", info_out=info,
            device="cpu")
        cap = harness._capture(views, truth, probes, info, canvas, mask)
    finally:
        probes.close()
    n, mid = len(views), len(views) >> 1
    conf = cap.graph["conf"]
    assert cap.hfactor == info["hfactor"]
    assert sorted(zip(*np.nonzero(conf > 0))) == sorted(
        [(i, i + 1) for i in range(mid, n - 1)]
        + [(i + 1, i) for i in range(mid)])
    homo = cap.graph["homo"].astype(np.float64)
    acc = np.eye(3)
    for k in range(mid + 1, n):
        acc = acc @ homo[k - 1, k]
        np.testing.assert_array_equal(acc, cap.homos[k])
    acc = np.eye(3)
    for i in range(mid - 1, -1, -1):
        acc = acc @ homo[i + 1, i]
        np.testing.assert_array_equal(acc, cap.homos[i])


def test_control_fails(cell):
    rows = calibrate.readings(cell, SEED + 1, 1, [], "cpu")
    program, control = rows[0]["program"], rows[0]["control"]
    assert all(program[k] <= CYL_LIMITS[k] for k in CYL_LIMITS), program
    failed = {k for k in CYL_LIMITS if control[k] > CYL_LIMITS[k]}
    assert {"kp_diff", "kp_offset", "ori_miss", "desc_miss", "refit_px",
            "canvas_bad"} <= failed, control


@pytest.mark.parametrize("fault,number", [
    ("warp_radius_off", "canvas_bad"),      # the image warp's radius off
    ("correction_skipped", "canvas_bad"),   # a step leaves its input
    ("left_chain_reversed", "truth_px"),    # the chain in the wrong order
])
def test_cylinder_fault_makes_the_run_incorrect(cell, fault, number):
    with faults.FAULTS[fault]():
        r = harness.run(cell, SEED, 0.1, False, device="cpu",
                        log=lambda m: None)
    assert r["correct"] is False
    got = r["compared"][number]
    assert got["value"] > got["limit"], (fault, got)


# the sweep's view set as it was before ``pitch``: the oracle that pitch 0
# changes no view and no truth
def _untilted_view_set(tex, p, seed, index):
    from benchmark.scenes import bilinear_wrap_x, host_rng, to_u8

    gen = scenes.generator("sweep")
    n, w, h = p["n"], p["width"], p["height"]
    f = gen.focal_px(p)
    step = math.radians(p["hfov"]) * (1 - p["overlap"])
    rng = host_rng(seed, index)
    start = rng.uniform(0, 2 * math.pi)
    yaws = start + (np.arange(n) - (n - 1) / 2) * step \
        + rng.normal(scale=p["jitter"] * step, size=n)
    order = rng.permutation(n) if p["shuffle"] else np.arange(n)
    vh = (h / 2) / f * 1.15 / 0.9
    dev = tex.device
    hs, ws = tex.shape[0], tex.shape[1]
    u = torch.arange(w, device=dev, dtype=torch.float32) - (w - 1) / 2.0
    v = torch.arange(h, device=dev, dtype=torch.float32) - (h - 1) / 2.0
    uu, vv = u[None, :], v[:, None]
    views = torch.empty((n, h, w, 3), dtype=torch.uint8, device=dev)
    for slot, k in enumerate(order):
        c, s = math.cos(yaws[k]), math.sin(yaws[k])
        xr = c * uu + s * f
        zr = -s * uu + c * f
        ang = torch.atan2(xr, zr)
        hgt = vv / torch.hypot(xr, zr)
        sx = (ang / (2 * math.pi) + 0.5) * ws
        sy = (hgt / (2 * vh) + 0.5) * (hs - 1)
        views[slot] = to_u8(bilinear_wrap_x(tex, sy.expand(h, w),
                                            sx.expand(h, w)))
    K = np.array([[f, 0, -0.5], [0, f, -0.5], [0, 0, 1.0]])
    Kinv = np.linalg.inv(K)
    slot_of = np.argsort(order)
    adjacent = []
    for k in range(n - 1):
        a, b = int(slot_of[k]), int(slot_of[k + 1])
        T = K @ gen._rot_y(yaws[k + 1] - yaws[k]) @ Kinv
        adjacent.append((a, b, T / T[2, 2]))
    return views, {"focal_px": f, "yaws": yaws[order], "adjacent": adjacent,
                   "size": (w, h)}


@pytest.mark.parametrize("traffic", ["cmu0_unordered38", "ordered13"])
def test_pitch_zero_leaves_the_first_view_set(traffic):
    with open(os.path.join(ROOT, "benchmark", "traffic",
                           f"{traffic}.json")) as f:
        p = json.load(f)["params"]
    assert "pitch" not in p
    gen = scenes.generator("sweep")
    seed = 2**31 + 77
    tex = gen.build(p, seed, "cpu")
    want_views, want = _untilted_view_set(tex, p, seed, 0)
    for params in (p, {**p, "pitch": 0.0}):
        views, truth = gen.view_set(tex, params, seed, 0)
        assert torch.equal(views, want_views)
        assert truth["focal_px"] == want["focal_px"]
        assert truth["size"] == want["size"]
        np.testing.assert_array_equal(truth["yaws"], want["yaws"])
        assert len(truth["adjacent"]) == len(want["adjacent"])
        for (a, b, T), (wa, wb, wT) in zip(truth["adjacent"],
                                           want["adjacent"]):
            assert (a, b) == (wa, wb)
            np.testing.assert_array_equal(T, wT)


# the tiny camera cell's program numbers at seed 2^31 + 26, read with the
# judge before it took CYLINDER (one panorama, the CPU)
CAMERA_NUMBERS = {"kp_diff": 0.0, "kp_offset": 9.126904259093571e-05,
                  "ori_miss": 0.0, "desc_miss": 0.0, "match_diff": 0.0,
                  "refit_px": 0.003855232269253592,
                  "truth_px": 0.3785900030448599, "canvas_bad": 0.0}


def test_camera_cell_numbers_unchanged(tiny_root):
    cell = spec.load(TINY_CELL, root=str(tiny_root))
    rows = calibrate.readings(cell, SEED + 1, 1, [], "cpu", control=False)
    got = rows[0]["program"]
    for name, want in CAMERA_NUMBERS.items():
        assert got[name] == pytest.approx(want, rel=1e-9, abs=1e-15), name
