"""Shared set-up of the benchmark's own tests (run them with
``python -m pytest benchmark/tests -q`` from the root; the card's test
with ``-m cuda`` on a machine that has one)."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a sweep small enough for the CPU that still connects on every seed tried
TINY_TRAFFIC = {
    "kind": "sweep",
    "params": {"n": 4, "width": 480, "height": 360, "hfov": 40,
               "overlap": 0.6, "jitter": 0.05, "shuffle": True,
               "texture": [560, 4200]},
    "program": {"ORDERED_INPUT": False}, "pool": 5, "warmup": 0}
TINY_CONFIG = {
    "name": "tiny_camera", "source": "test", "program": {
        "ESTIMATE_CAMERA": True, "MAX_KP_PER_IMAGE": 1024,
        "MAX_MATCHES_PER_PAIR": 1024},
    "precision": {"features": "float32", "match": "float32",
                  "ransac": "float32", "cameras": "float64",
                  "blend": "float32"}}
# set from the CPU readings of the tiny cell on three seeds (program:
# kp_diff 0, kp_offset 9.1e-5-9.8e-5, ori_miss 0, desc_miss 0, match_diff
# 0, refit_px 2e-3-9e-3, truth_px 0.29-2.4 (four views of 480 x 360 hold
# few matches), canvas_bad 0; the control read kp_diff 3.0-3.3, kp_offset
# 0.36-0.49, ori_miss 0.083-0.099, desc_miss 0.998-0.999; the faults in
# test_bench_correct.py)
TINY_LIMITS = {"kp_diff": 1e-2, "kp_offset": 0.05, "ori_miss": 0.02,
               "desc_miss": 0.01, "match_diff": 1e-3, "refit_px": 0.05,
               "truth_px": 4.0, "canvas_bad": 1e-4}
TINY_CELL = "tiny_camera.tiny"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where there is none")


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    import torch

    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """A checkout-like root: the real benchmark's data files, plus a tiny
    cell added only as files (configuration, traffic, limits) and
    entries."""
    root = tmp_path_factory.mktemp("bench_root")
    bdir = root / "benchmark"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(ROOT, "benchmark", sub), bdir / sub)
    (bdir / "configs" / "tiny_camera.json").write_text(
        json.dumps(TINY_CONFIG))
    (bdir / "traffic" / "tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    (bdir / "limits" / f"{TINY_CELL}.json").write_text(
        json.dumps(TINY_LIMITS))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_camera", "source": "test",
                             "file": "benchmark/configs/tiny_camera.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": TINY_CELL, "config": "tiny_camera",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"].append(TINY_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def card():
    """Skips unless a CUDA card is here; decided when the test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
