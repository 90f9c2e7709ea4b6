"""The port's benches (``openpano_torch/bench/``) against the JAX package's
bench.py and tools, on the CPU.

- (a) ``roofline``'s work model equals ``tools/roofline.py``'s counts
  exactly on the headline's, the UAV strip's and the rotational grid's
  shapes (the tool loaded by path; no JAX pipeline runs); ``relate``
  against the H100's peaks, by hand;
- (b) every bench Config equals an ``openpano_tpu.Config`` built from the
  JAX tool's own lines (bench.py:39-42, tools/giga_bench.py:104-112,
  211-219, 323-330, tools/scaling_bench.py:53-59), through
  ``compat.config_from_fields``;
- (c) ``headline.run(device="cpu", warm_runs=1)`` on 6 views of 400x300
  (SIFT working size 320 for views of that size): every key of bench.py's
  line, and bench.py's gates (run raises on a failed one);
- (d) ``giga`` trans mode on 8 views of 500x560 at working size 400: every
  key of the JAX tool's line, every adjacent pair connected, each pairwise
  offset within 6 px of ``strip_views``' truth, no failed gate;
- (e) ``scaling`` at 1 and 2 gloo ranks gives the same canvas within the
  rank-count gates of tests/test_torch_parallel.py;
- (f) ``kernel_check.check`` raises on the CPU: there is no kernel there;
- the block-parallel scene and view builders of ``synth`` equal the
  one-call functions pixel for pixel.

Run as a script, the file holds the rotational grid's cameras from one
match graph to both packages' estimators on the CPU:

    PYTHONPATH=. python tests/test_torch_bench.py GRAPH.txt [giga rot args]

GRAPH.txt is the matchinfo text that ``python -m openpano_torch.bench.giga
--mode rot --dump-matchinfo GRAPH.txt`` writes on the card; for each
estimator (host LM, the rot Config) it prints the LM iterations, the focal
spread and the consecutive pairs' reprojection error against the true
rotations (``giga.rot_errors``), which tells a camera error of the bench
apart from the estimator (same graph, same cameras).
"""

import ast
import dataclasses
import importlib.util
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from openpano_tpu.camera.estimator import \
    estimate_cameras as jax_estimate_cameras
from openpano_tpu.config import Config as JConfig
from openpano_tpu.io import artifacts as jart
from openpano_torch import compat, synth
from openpano_torch.bench import giga, headline, kernel_check, roofline, \
    scaling
from openpano_torch.camera.camera import intrinsic
from openpano_torch.camera.estimator import \
    estimate_cameras as port_estimate_cameras
from openpano_torch.io import artifacts as tart

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op torch thread for this module (the test workers share
    the CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_roofline():
    spec = importlib.util.spec_from_file_location(
        "jax_roofline", ROOT / "tools" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed_keys(path: Path, func: str) -> tuple[set, set]:
    """The keys of the dict literal that ``func`` of ``path`` prints with
    ``json.dumps``, and of its ``extra`` dict if it has one."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", "") == "dumps"
                and isinstance(n.args[0], ast.Dict))
    d = call.args[0]
    keys = {k.value for k in d.keys}
    extra = next((v for k, v in zip(d.keys, d.values) if k.value == "extra"),
                 None)
    return keys, ({k.value for k in extra.keys} if extra is not None
                  else set())


# (shapes, Config) of the three runs the model is held on
SHAPES = {
    "headline": dict(n=38, w=1300, h=867, pairs=38 * 37 // 2,
                     canvas=(8000, 677), cfg=headline.config()),
    "uav": dict(n=500, w=500, h=560, pairs=500, canvas=(75350, 1562),
                cfg=giga.trans_config(400)),
    "rot": dict(n=496, w=2200, h=1400, pairs=496, canvas=(69835, 6828),
                cfg=giga.rot_config(640, 1)),
}


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_roofline_counts_equal_the_jax_tool(jax_roofline, case):
    c = SHAPES[case]
    jcfg = JConfig(**dataclasses.asdict(c["cfg"]))
    assert (roofline.feature_stage(c["n"], c["w"], c["h"], c["cfg"])
            == jax_roofline.feature_stage(c["n"], c["w"], c["h"], jcfg))
    K = c["cfg"].MAX_KP_PER_IMAGE
    assert (roofline.match_stage(c["pairs"], K, c["cfg"].DESC_LEN)
            == jax_roofline.match_stage(c["pairs"], K, jcfg.DESC_LEN))
    assert (roofline.blend_stage(*c["canvas"])
            == jax_roofline.blend_stage(*c["canvas"]))


def test_relate_against_the_h100_peaks():
    """67 TFLOP/s of f32 and 3.35 TB/s: half of each peak for 2 s, and a
    quarter of a 10 GB/s link; the ideal times 0.1 + 1.0 + 0.5 s."""
    est = {"flops": 6.7e12, "hbm_bytes": 3.35e12, "wire_bytes": 5e9}
    got = roofline.relate(est, 2.0, 10e9)
    assert got["pct_peak_flops"] == 5.0
    assert got["pct_peak_hbm"] == 50.0
    assert got["pct_peak_wire"] == 25.0
    assert got["bound"] == "hbm" and got["ideal_s"] == 1.6
    assert roofline.relate(est, 0.0, 10e9) == est


JAX_CONFIGS = {
    # bench.py:39-42
    "headline": (lambda: headline.config(), dict(
        ESTIMATE_CAMERA=True, ORDERED_INPUT=False,
        MAX_KP_PER_IMAGE=2048, MAX_MATCHES_PER_PAIR=1024)),
    # tools/giga_bench.py:104-112 (--working-size 400, GIGA_r04.json)
    "trans": (lambda: giga.trans_config(400), dict(
        ESTIMATE_CAMERA=False, TRANS=True, ORDERED_INPUT=True,
        MAX_OUTPUT_SIZE=79000, MAX_KP_PER_IMAGE=1024,
        MAX_MATCHES_PER_PAIR=512, SIFT_WORKING_SIZE=400)),
    # tools/giga_bench.py:211-219 (the defaults)
    "rot": (lambda: giga.rot_config(640, 1), dict(
        ESTIMATE_CAMERA=True, ORDERED_INPUT=True, MULTIPASS_BA=1,
        MAX_OUTPUT_SIZE=79000, MAX_KP_PER_IMAGE=2048,
        MAX_MATCHES_PER_PAIR=512, MAX_CAND_PER_OCTAVE=4096,
        MAX_KP_PER_OCTAVE=2048, MAX_DESC_PER_OCTAVE=2048,
        SIFT_WORKING_SIZE=640)),
    # tools/giga_bench.py:323-330
    "trans2d": (lambda: giga.trans2d_config(640), dict(
        ESTIMATE_CAMERA=False, TRANS=True, ORDERED_INPUT=True,
        MAX_OUTPUT_SIZE=79000, MAX_KP_PER_IMAGE=2048,
        MAX_MATCHES_PER_PAIR=512, MAX_CAND_PER_OCTAVE=4096,
        MAX_KP_PER_OCTAVE=2048, MAX_DESC_PER_OCTAVE=2048,
        SIFT_WORKING_SIZE=640)),
    # tools/scaling_bench.py:53-59
    "scaling": (lambda: scaling.config(), dict(
        ESTIMATE_CAMERA=True, ORDERED_INPUT=False, RANSAC_ITERATIONS=400,
        SIFT_WORKING_SIZE=300, MAX_CAND_PER_OCTAVE=1024,
        MAX_KP_PER_OCTAVE=512, MAX_DESC_PER_OCTAVE=512,
        MAX_KP_PER_IMAGE=1024, MAX_MATCHES_PER_PAIR=512)),
}


@pytest.mark.parametrize("mode", sorted(JAX_CONFIGS))
def test_configs_equal_the_jax_tools(mode):
    port, fields = JAX_CONFIGS[mode]
    want = compat.config_from_fields(dataclasses.asdict(JConfig(**fields)))
    assert port() == want


def test_giga_arguments_are_the_jax_tools():
    """The modes' size and grid defaults, as tools/giga_bench.py:83-94."""
    assert giga.parse_args([]).size == (1300, 560)
    rot = giga.parse_args(["--mode", "rot"])
    assert rot.size == (2200, 1400) and rot.grid == (62, 8)
    t2d = giga.parse_args(["--mode", "trans2d"])
    assert t2d.size == (2000, 1200) and t2d.grid == (25, 20)
    assert giga.parse_args(["--mode", "trans2d", "--size", "800", "600"]
                           ).size == (800, 600)


SMALL_SWEEP = headline.Workload(6, 400, 300, 30, 0.5, scene=(600, 2400),
                                working_size=320)


def test_headline_bench_on_cpu():
    got = headline.run(SMALL_SWEEP, device="cpu", warm_runs=1)
    top, extra = _printed_keys(ROOT / "bench.py", "main")
    assert top <= set(got) and extra <= set(got["extra"])
    e = got["extra"]
    assert e["images"] == 6 and len(e["warm_walls_s"]) == 1
    assert e["mean_reproj_err_px"] < headline.REPROJ_LIMIT_PX
    assert e["multiband"]["ncc_vs_linear"] > headline.MB_NCC_LIMIT
    assert e["final_size"] == e["multiband"]["final_size"]
    assert e["kernel_parity"] is None and e["link"] is None and e["note"]
    assert e["device"] == "cpu" and e["peak_device_gib"] is None
    assert set(e["roofline"]) == {"feature", "match_2nn", "blend"}
    # the transport ran: the feature stage's wire bytes are its own
    assert e["roofline"]["feature"]["wire_source"] == "wirecodec.STATS"
    assert e["roofline"]["feature"]["wire_bytes"] == (
        e["wire"]["up_bytes"] - e["wire"]["bg_up_bytes"])


def test_giga_trans_on_cpu():
    args = giga.parse_args(["--images", "8", "--size", "500", "560",
                            "--overlap", "0.7", "--working-size", "400",
                            "--device", "cpu"])
    got = giga.run_trans(args, cold=False)
    top, _ = _printed_keys(ROOT / "tools" / "giga_bench.py", "main")
    assert top <= set(got)
    assert got["adjacent_connected"]
    assert got["max_pair_offset_err_px"] < giga.PAIR_LIMIT_PX
    assert giga.trans_gates(got) == []
    assert got["feature_batches"] == 2 and not got["host_stream"]


def test_giga_trans_gates_fail():
    """Each gate of trans_gates fires on its own fault."""
    ok = {"adjacent_connected": True, "max_pair_offset_err_px": 1.0,
          "canvas": [1000, 600], "true_extent": [1010, 600],
          "device": "NVIDIA H100", "launches": {"a": 2, "b": 2},
          "feature_batches": 2}
    assert giga.trans_gates(ok) == []
    for key, bad in (("adjacent_connected", False),
                     ("max_pair_offset_err_px", 6.0),
                     ("canvas", [1100, 600]),
                     ("launches", {"a": 2, "b": 0})):
        assert len(giga.trans_gates(dict(ok, **{key: bad}))) == 1


def test_scaling_one_and_two_ranks_on_cpu():
    got = scaling.run([1, 2], images=4, size=(240, 180), repeat=1,
                      device="cpu")
    top = {"devices", "step_s", "speedup", "efficiency", "canvas"}
    assert all(top <= set(r) for r in got)
    assert [r["devices"] for r in got] == [1, 2]
    one, two = got[0]["canvas_f32"], got[1]["canvas_f32"]
    assert one.shape == two.shape and (one[..., 0] >= 0).mean() > 0.5
    assert ((one[..., 0] >= 0) == (two[..., 0] >= 0)).mean() >= 0.9995
    both = (one[..., 0] >= 0) & (two[..., 0] >= 0)
    diff = np.abs(one[both] - two[both])
    assert diff.mean() < 1e-6 and diff.max() < 1e-4


def test_kernel_check_raises_on_cpu(monkeypatch):
    with pytest.raises(RuntimeError, match="plain version"):
        kernel_check.check(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_check.check()


def test_block_builders_equal_the_one_call_functions(tmp_path):
    path = str(tmp_path / "scene.npy")
    synth.procedural_scene_large_to(path, 600, 517, seed=13,
                                    dtype=np.uint8, workers=2)
    want = np.round(synth.procedural_scene_large(600, 517, 13) * 255)
    np.testing.assert_array_equal(np.load(path), want.astype(np.uint8))
    synth.procedural_scene_large_to(path, 300, 700, seed=11, workers=2)
    scene = np.load(path)
    np.testing.assert_array_equal(scene,
                                  synth.procedural_scene_large(300, 700, 11))
    Rs, _ = synth.serpentine_rotations(3, 3, 0.3, 0.2)
    views = str(tmp_path / "views.npy")
    synth.render_views_sphere_to(views, path, Rs, 60, 40, 80.0, workers=2)
    np.testing.assert_array_equal(
        np.load(views), synth.render_views_sphere(scene, Rs, 60, 40, 80.0))
    assert sorted(os.listdir(tmp_path)) == ["scene.npy", "views.npy"]


def graph_cameras(argv) -> int:
    """The script's body (module docstring): argv is GRAPH.txt and the rot
    mode's arguments of ``giga``."""
    path, rest = argv[0], argv[1:]
    args = giga.parse_args(["--mode", "rot", *rest])
    cols, rows = args.grid
    n = cols * rows
    w, h = args.size
    f = args.focal
    Rs, _ = synth.serpentine_rotations(cols, rows, 2 * np.pi / cols,
                                       args.pitch_px / f)
    whs = np.repeat([[float(w), float(h)]], n, 0)
    cfg = giga.rot_config(args.working_size, args.multipass)
    M = cfg.MAX_MATCHES_PER_PAIR
    runs = {
        "jax": lambda g, st: jax_estimate_cameras(
            g.conf, g.homo, g.to_pos, g.from_pos, g.valid, whs,
            JConfig(**dataclasses.asdict(cfg)), stats=st),
        "torch": lambda g, st: port_estimate_cameras(
            g.conf, g.homo, g.to_pos, g.from_pos, g.valid, whs, cfg,
            stats=st, device="cpu"),
    }
    for name, run in runs.items():
        g = (jart if name == "jax" else tart).load_matchinfo_text(path, n, M)
        st = {}
        t0 = time.perf_counter()
        cams = run(g, st)
        secs = time.perf_counter() - t0
        homos = np.stack([
            cams.R[i].T @ np.linalg.inv(intrinsic(cams.focal[i], cams.ppx[i],
                                                  cams.ppy[i]))
            for i in range(n)])
        errs = giga.rot_errors(homos, Rs, f, w, h)
        print(f"{name}: {st['lm_iters']} LM iterations in {secs:.1f} s; "
              f"focal min / median / max {cams.focal.min():.3f} / "
              f"{np.median(cams.focal):.3f} / {cams.focal.max():.3f} (true "
              f"{f}); reprojection of consecutive pairs mean "
              f"{errs.mean():.6f} median {np.median(errs):.6f} max "
              f"{errs.max():.6f} px", flush=True)
    return 0


if __name__ == "__main__":
    torch.set_num_threads(4)
    sys.exit(graph_cameras(sys.argv[1:]))
